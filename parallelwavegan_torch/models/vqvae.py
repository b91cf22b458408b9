"""VQ-VAE wav2wav model, channels-last (B, T, C).

Counterpart of ``VQVAE`` in ``parallelwavegan_tpu/models/vqvae.py``: the
encoder is a MelGAN discriminator tower whose last output (B, T / prod
(downsample_scales), embed_dim) is the latent z_e; the codebook quantises
it with the straight-through estimator; the decoder is a MelGAN generator
on the quantised latents, concatenated with an optional local condition
(through a 1x1 conv without weight norm) and an optional global condition
(a speaker embedding, N(0, 1) at init, broadcast over time). Submodules
carry the flax names (``encoder``, ``codebook``, ``decoder``,
``local_embed``, ``global_embed``), so a converted tree loads with
``strict=True``. The encoder and the decoder take ``use_weight_norm``
unless their confs say otherwise; ``folded=True`` (the serving form) holds
their kernels with weight norm applied.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from parallelwavegan_torch.layers.common import (
    Conv1d,
    Embed,
    torch_conv_default_init,
)
from parallelwavegan_torch.layers.vq import VQCodebook
from parallelwavegan_torch.models.melgan import (
    MelGANDiscriminator,
    MelGANGenerator,
)

_ENCODER_CONF = {"out_channels": 256, "downsample_scales": [4, 4, 2, 2],
                 "max_downsample_channels": 1024}
_DECODER_CONF = {"in_channels": 256, "upsample_scales": [4, 4, 2, 2],
                 "channels": 512, "stacks": 3}


class VQVAE(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        num_embeds: int = 512,
        embed_dim: int = 256,
        num_local_embeds: Optional[int] = None,
        local_embed_dim: Optional[int] = None,
        num_global_embeds: Optional[int] = None,
        global_embed_dim: Optional[int] = None,
        encoder_type: str = "MelGANDiscriminator",
        decoder_type: str = "MelGANGenerator",
        encoder_conf: Optional[Dict[str, Any]] = None,
        decoder_conf: Optional[Dict[str, Any]] = None,
        use_weight_norm: bool = True,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if encoder_type != "MelGANDiscriminator" \
                or decoder_type != "MelGANGenerator":
            raise NotImplementedError(
                f"VQVAE takes a MelGANDiscriminator encoder and a "
                f"MelGANGenerator decoder, not {encoder_type} / "
                f"{decoder_type}")
        enc_conf = dict(encoder_conf or _ENCODER_CONF)
        enc_conf["in_channels"] = in_channels
        enc_conf["out_channels"] = embed_dim
        enc_conf.setdefault("use_weight_norm", use_weight_norm)
        dec_conf = dict(decoder_conf or _DECODER_CONF)
        dec_conf["out_channels"] = out_channels
        dec_conf.setdefault("use_weight_norm", use_weight_norm)
        kw = dict(folded=folded, generator=generator)
        self.encoder = MelGANDiscriminator(**enc_conf, **kw)
        self.codebook = VQCodebook(num_embeds, embed_dim, generator=generator)
        self.decoder = MelGANGenerator(**dec_conf, **kw)
        self.local_embed = None
        if num_local_embeds is not None and local_embed_dim is not None:
            self.local_embed = Conv1d(
                num_local_embeds, local_embed_dim, 1,
                kernel_init=torch_conv_default_init, bias_init=None,
                generator=generator)
        self.global_embed = None
        if num_global_embeds is not None:
            self.global_embed = Embed(num_global_embeds, global_embed_dim,
                                      generator=generator)

    def _condition(self, z: torch.Tensor, l: Optional[torch.Tensor],
                   g: Optional[torch.Tensor]) -> torch.Tensor:
        if l is not None:
            if self.local_embed is not None:
                l = self.local_embed(l)
            z = torch.cat([z, l], dim=-1)
        if g is not None:
            ge = self.global_embed(g)  # (B, D)
            z = torch.cat([z, ge[:, None, :].expand(-1, z.shape[1], -1)],
                          dim=-1)
        return z

    def forward(self, x: torch.Tensor, l: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None,
                indices: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, T, in_channels), l (B, T', local), g (B,) ints ->
        (x_bar, z_e, z_q): the reconstruction and the encoder's and the
        quantised latents (B, T', embed_dim). ``indices`` (B, T') replaces
        the nearest codes (``VQCodebook.straight_through``)."""
        z_e = self.encoder(x)[-1]
        z_q_st, z_q = self.codebook.straight_through(z_e, indices)
        x_bar = self.decoder(self._condition(z_q_st, l, g))
        return x_bar, z_e, z_q

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, in_channels) -> code indices (B, T')."""
        return self.codebook(self.encoder(x)[-1])

    def decode(self, indices: torch.Tensor, l: Optional[torch.Tensor] = None,
               g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Code indices (B, T') -> wave (B, T' * prod(upsample_scales),
        out_channels)."""
        z_q = self.codebook.lookup(indices)
        return self.decoder(self._condition(z_q, l, g))
