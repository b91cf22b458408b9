"""Discrete-symbol (token) vocoder generators, channels-last (B, T, C).

Counterpart of ``parallelwavegan_tpu/models/discrete.py``: token ids (a
HuBERT unit or a singing token a frame, with a speaker id in a second
column where ``num_spk_embs`` > 0) are embedded and synthesized by a
HiFi-GAN trunk or a StyleMelGAN trunk.

- ``DiscreteSymbolHiFiGANGenerator``: ids (B, T, 2|1) -> ``emb`` (+ the
  speaker's ``spk_emb`` row, added or, with ``concat_spk_emb``,
  concatenated; the speaker id is the first frame's) -> ``trunk``;
  ``use_embedding_feats`` (no speakers) takes float features as they are.
- ``DiscreteSymbolDurationGenerator``: the same with a
  ``duration_predictor`` on the embeddings and the length regulator:
  ``forward(c, ds)`` expands each symbol by ``ds`` (teacher forcing) into
  ``max_reg_len`` frames, zero-filled past the sum of the durations; with
  ``ds`` None it uses the predicted durations. Returns (wave, predicted
  log-durations). Its token table has ``num_embs + 1`` rows (``emb_pad``).
- ``DiscreteSymbolF0Generator``: + the f0 (B, T, 1) through the Dense
  ``f0_embedding``, concatenated; with ``use_weight_sum`` (and no
  speakers) ``layer_num`` tables ``emb_<i>`` of the ids of L HuBERT
  layers mixed by softmax(``weights``), or by the raw ``weights`` with
  ``use_fix_weight`` (no gradient), as the JAX module does it. Its input
  conv is never weight-normed (the reference re-declares it plain).
- ``DiscreteSymbolStyleMelGANGenerator``: ``emb`` of ``aux_channels``
  and ``spk_emb`` -> a ``StyleMelGANGenerator`` trunk on noise z.

The HiFi-GAN trunk pads its transposed convs by (k - s) // 2 with no
output padding (an odd scale such as 5 with kernel 10 gives 5 T + 1
samples), and ends in LeakyReLU(0.01), a conv and tanh. Ids become int64
at the module boundary. ``check_ids`` raises ``ValueError`` for an id
outside its table on the host: the serving and training entry points call
it on each utterance or batch before it goes to the device, so the lookup
itself costs no device-to-host sync. Submodules carry the flax
names, so a converted tree loads with ``strict=True``; ``folded=True``
(the serving form) holds every kernel with weight norm applied,
``folded=False`` holds ``kernel_v``/``kernel_g``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from parallelwavegan_torch.layers.common import (
    Conv1d,
    ConvTranspose1d,
    Dense,
    Embed,
    get_activation,
    normal_init,
)
from parallelwavegan_torch.layers.duration import (
    DurationPredictor,
    durations_from_log,
    length_regulator,
)
from parallelwavegan_torch.layers.residual_block import HiFiGANResidualBlock
from parallelwavegan_torch.models.style_melgan import StyleMelGANGenerator


class _HiFiGANTrunk(nn.Module):
    """The HiFi-GAN trunk of the discrete generators: (B, T, in_channels)
    -> (B, T', out_channels)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int = 1,
        channels: int = 512,
        kernel_size: int = 7,
        upsample_scales: Sequence[int] = (8, 8, 2, 2),
        upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
        resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
        resblock_dilations: Sequence[Sequence[int]] = (
            (1, 3, 5), (1, 3, 5), (1, 3, 5)),
        use_additional_convs: bool = True,
        bias: bool = True,
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: Optional[Dict[str, Any]] = None,
        use_weight_norm: bool = True,
        input_conv_weight_norm: bool = True,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("kernel_size must be odd")
        if len(upsample_scales) != len(upsample_kernel_sizes):
            raise ValueError("upsample_scales and upsample_kernel_sizes "
                             "differ in length")
        if len(resblock_dilations) != len(resblock_kernel_sizes):
            raise ValueError("resblock_dilations and resblock_kernel_sizes "
                             "differ in length")
        self.upsample_scales = tuple(upsample_scales)
        act_params = dict(nonlinear_activation_params
                          or {"negative_slope": 0.1})
        self.act = get_activation(nonlinear_activation, act_params)
        wn = use_weight_norm and not folded
        kinit = normal_init(0.01)
        # bias_init None: torch's uniform bias for the kernel's fan-in
        conv_kw = dict(kernel_init=kinit, bias_init=None, generator=generator)
        pad = (kernel_size - 1) // 2
        self.input_conv = Conv1d(in_channels, channels, kernel_size,
                                 padding=pad,
                                 use_weight_norm=wn and input_conv_weight_norm,
                                 **conv_kw)
        self.upsamples: List[ConvTranspose1d] = []
        self.mrfs: List[List[HiFiGANResidualBlock]] = []
        n_blocks = len(resblock_kernel_sizes)
        ch = channels
        for i, (s, k) in enumerate(zip(self.upsample_scales,
                                       upsample_kernel_sizes)):
            out_ch = channels // (2 ** (i + 1))
            up = ConvTranspose1d(ch, out_ch, k, stride=s, padding=(k - s) // 2,
                                 use_weight_norm=wn, kernel_init=kinit,
                                 generator=generator)
            self.add_module(f"upsamples_{i}", up)
            self.upsamples.append(up)
            blocks = []
            for j, (k_res, dils) in enumerate(zip(resblock_kernel_sizes,
                                                  resblock_dilations)):
                block = HiFiGANResidualBlock(
                    kernel_size=k_res, channels=out_ch, dilations=tuple(dils),
                    bias=bias, use_additional_convs=use_additional_convs,
                    nonlinear_activation=nonlinear_activation,
                    nonlinear_activation_params=act_params,
                    use_weight_norm=wn, kernel_init=kinit,
                    generator=generator)
                self.add_module(f"blocks_{i * n_blocks + j}", block)
                blocks.append(block)
            self.mrfs.append(blocks)
            ch = out_ch
        self.output_conv = Conv1d(ch, out_channels, kernel_size, padding=pad,
                                  use_weight_norm=wn, **conv_kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.input_conv(x)
        for up, blocks in zip(self.upsamples, self.mrfs):
            x = up(self.act(x))
            cs = 0.0
            for block in blocks:
                cs = cs + block(x)
            x = cs / len(blocks)
        x = F.leaky_relu(x, negative_slope=0.01)
        return torch.tanh(self.output_conv(x))


def check_ids(ids: np.ndarray, n: int) -> None:
    """Raise ``ValueError`` unless every id of the host array ``ids`` lies
    in [0, n). The entry points check a batch here, before it goes to the
    card: a lookup out of range there is a device-side assert that ends the
    process's CUDA context (flax's ``take`` gives NaN rows)."""
    ids = np.asarray(ids)
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        raise ValueError(f"token ids must lie in [0, {n}); got "
                         f"[{ids.min()}, {ids.max()}]")


def _speaker_ids(c: torch.Tensor) -> torch.Tensor:
    """The speaker id of each utterance: column 1 of its first frame."""
    return c[:, 0, 1].long()


class _TokenEmbed(nn.Module):
    """The token (+ speaker) front end: ``emb`` of ``num_embs + emb_pad``
    rows of ``features``, with ``num_spk_embs`` > 0 ``spk_emb`` of
    ``spk_emb_dim``, added (``features`` == ``spk_emb_dim``) or
    concatenated; with no speakers and ``use_embedding_feats`` no table
    (float features pass as they are)."""

    def _build_embed(self, features: int, num_embs: int, num_spk_embs: int,
                     spk_emb_dim: int, concat_spk_emb: bool,
                     use_embedding_feats: bool, emb_pad: int,
                     generator: Optional[torch.Generator],
                     build_emb: bool = True) -> int:
        """Make the tables; returns the embedded sequence's channels."""
        self.num_embs, self.num_spk_embs = num_embs, num_spk_embs
        self.spk_emb_dim, self.concat_spk_emb = spk_emb_dim, concat_spk_emb
        self.use_embedding_feats = use_embedding_feats
        # ids (a float batch of them is converted) or float features
        self.token_inputs = num_spk_embs > 0 or not use_embedding_feats
        if num_spk_embs > 0:
            if not concat_spk_emb and features != spk_emb_dim:
                raise ValueError(
                    f"an added speaker embedding needs in_channels "
                    f"({features}) == spk_emb_dim ({spk_emb_dim})")
            self.emb = Embed(num_embs + emb_pad, features,
                             generator=generator)
            self.spk_emb = Embed(num_spk_embs, spk_emb_dim,
                                 generator=generator)
            return features + (spk_emb_dim if concat_spk_emb else 0)
        if build_emb and not use_embedding_feats:
            self.emb = Embed(num_embs + emb_pad, features,
                             generator=generator)
        return features

    def check_ids(self, c: np.ndarray) -> None:
        """``check_ids`` on a batch's ids c (B, T, 2|1), a host array: the
        token column against ``emb``, the first frame's speaker id against
        ``spk_emb`` (float features pass)."""
        if not self.token_inputs:
            return
        c = np.asarray(c)
        check_ids(c[..., 0], self.emb.embedding.shape[0])
        if self.num_spk_embs > 0:
            check_ids(c[:, 0, 1], self.num_spk_embs)

    def _embed_tokens(self, c: torch.Tensor) -> torch.Tensor:
        """c (B, T, 2|1) ids (or (B, T, C) features) -> (B, T, C')."""
        if self.num_spk_embs > 0:
            if c.shape[-1] != 2:
                raise ValueError(f"expected (token, speaker) columns, got "
                                 f"{c.shape[-1]}")
            x = self.emb(c[..., 0].long())
            g = self.spk_emb(_speaker_ids(c))  # (B, D)
            if not self.concat_spk_emb:
                return x + g[:, None, :]
            return torch.cat([x, g[:, None, :].expand(-1, x.shape[1], -1)],
                             dim=-1)
        if self.use_embedding_feats:
            return c
        if c.shape[-1] != 1:
            raise ValueError(f"expected one token column, got {c.shape[-1]}")
        return self.emb(c[..., 0].long())


class DiscreteSymbolHiFiGANGenerator(_TokenEmbed):
    """ids (B, T, 2|1) -> wave (B, T x upsample_factor, out_channels)."""

    # the F0 subclass builds its input conv plain, as the reference does
    _input_conv_weight_norm = True

    def __init__(
        self,
        in_channels: int = 512,
        out_channels: int = 1,
        channels: int = 512,
        num_embs: int = 100,
        num_spk_embs: int = 128,
        spk_emb_dim: int = 128,
        concat_spk_emb: bool = False,
        use_embedding_feats: bool = False,
        kernel_size: int = 7,
        upsample_scales: Sequence[int] = (8, 8, 2, 2),
        upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
        resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
        resblock_dilations: Sequence[Sequence[int]] = (
            (1, 3, 5), (1, 3, 5), (1, 3, 5)),
        use_additional_convs: bool = True,
        bias: bool = True,
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: Optional[Dict[str, Any]] = None,
        use_weight_norm: bool = True,
        emb_pad: int = 0,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
        _extra_channels: int = 0,
        _build_emb: bool = True,
    ):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        # the embedded sequence's channels
        self.embed_channels = self._build_embed(
            in_channels, num_embs, num_spk_embs, spk_emb_dim, concat_spk_emb,
            use_embedding_feats, emb_pad, generator, _build_emb)
        self.trunk = _HiFiGANTrunk(
            self.embed_channels + _extra_channels, out_channels, channels, kernel_size,
            upsample_scales, upsample_kernel_sizes, resblock_kernel_sizes,
            resblock_dilations, use_additional_convs, bias,
            nonlinear_activation, nonlinear_activation_params,
            use_weight_norm, self._input_conv_weight_norm, folded=folded,
            generator=generator)

    @property
    def upsample_factor(self) -> int:
        return math.prod(self.trunk.upsample_scales)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return self.trunk(self._embed_tokens(c))


class DiscreteSymbolDurationGenerator(DiscreteSymbolHiFiGANGenerator):
    """(ids (B, T, 2|1), durations (B, T) or None) -> (wave (B, max_reg_len
    x upsample_factor, out_channels), predicted log-durations (B, T))."""

    def __init__(
        self,
        *,
        duration_layers: int = 2,
        duration_chans: int = 384,
        duration_kernel_size: int = 3,
        duration_offset: float = 1.0,
        duration_dropout_rate: float = 0.5,
        max_reg_len: int = 2048,
        emb_pad: int = 1,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ):
        """The base's arguments by keyword, and the predictor's."""
        super().__init__(emb_pad=emb_pad, folded=folded, generator=generator,
                         **kwargs)
        self.max_reg_len = int(max_reg_len)
        self.duration_offset = float(duration_offset)
        self.duration_predictor = DurationPredictor(
            self.embed_channels, duration_layers, duration_chans, duration_kernel_size,
            duration_dropout_rate, duration_offset, generator=generator)

    @property
    def dropout(self) -> float:
        """The duration predictor's dropout rate (the step reads it)."""
        return self.duration_predictor.dropout_rate

    def batch_dropout_masks(self, batch: Dict[str, torch.Tensor],
                            generator: Optional[torch.Generator] = None
                            ) -> List[torch.Tensor]:
        """The duration predictor's keep masks for a training forward of
        ``batch`` (its ids (B, T, .)): one (B, T, duration_chans) a layer."""
        B, T = batch["c"].shape[:2]
        return self.duration_predictor.draw_dropout_masks(B, T, generator)

    def log_durations(self, c: torch.Tensor) -> torch.Tensor:
        """The deterministic predictor's log-durations (B, T) of ids c."""
        return self.duration_predictor(self._embed_tokens(c))

    def forward(self, c: torch.Tensor, ds: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                masks: Optional[Sequence[torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self._embed_tokens(c)
        ds_out = self.duration_predictor(x, deterministic, masks)
        if ds is None:  # synthesis: the predicted durations
            ds = durations_from_log(ds_out, self.duration_offset) \
                if deterministic else self.duration_predictor.inference(x)
        x, _ = length_regulator(x, ds, self.max_reg_len)
        return self.trunk(x), ds_out


class DiscreteSymbolF0Generator(DiscreteSymbolHiFiGANGenerator):
    """(ids (B, T, 2|1|layer_num) or features, f0 (B, T, 1)) -> wave."""

    _input_conv_weight_norm = False  # the reference's plain input conv

    def __init__(
        self,
        *,
        linear_channel: int = 256,
        use_weight_sum: bool = False,
        layer_num: int = 12,
        use_fix_weight: bool = False,
        use_f0: bool = True,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ):
        """The base's arguments by keyword, and the f0 and layer-sum
        ones. The layer sum applies with no speakers and ids (as the JAX
        module's branch)."""
        weight_sum = use_weight_sum and kwargs.get("num_spk_embs", 128) <= 0 \
            and not kwargs.get("use_embedding_feats", False)
        super().__init__(folded=folded, generator=generator,
                         _extra_channels=linear_channel if use_f0 else 0,
                         _build_emb=not weight_sum, **kwargs)
        self.use_f0, self.use_fix_weight = use_f0, use_fix_weight
        self.weight_sum, self.layer_num = weight_sum, layer_num
        if weight_sum:
            self.layer_embs: List[Embed] = []
            for i in range(layer_num):
                table = Embed(self.num_embs, self.in_channels,
                              generator=generator)
                self.add_module(f"emb_{i}", table)
                self.layer_embs.append(table)
            self.weights = nn.Parameter(torch.ones(layer_num))
        if use_f0:
            self.f0_embedding = Dense(1, linear_channel, generator=generator)

    def check_ids(self, c: np.ndarray) -> None:
        if not self.weight_sum:
            return super().check_ids(c)
        check_ids(c, self.num_embs)  # every layer's ids, one table each

    def forward(self, c: torch.Tensor, f0: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if not self.weight_sum:
            x = self._embed_tokens(c)
        else:
            if c.shape[-1] != self.layer_num:
                raise ValueError(f"expected {self.layer_num} id columns, "
                                 f"got {c.shape[-1]}")
            stacked = torch.stack([emb(c[..., i].long()) for i, emb in
                                   enumerate(self.layer_embs)], dim=-1)
            w = self.weights.detach() if self.use_fix_weight \
                else torch.softmax(self.weights, dim=0)
            x = torch.einsum("btcl,l->btc", stacked, w.to(stacked.dtype))
        if self.use_f0:
            if f0 is None:
                raise ValueError("this generator takes the f0 (use_f0)")
            x = torch.cat([x, self.f0_embedding(f0.to(x.dtype))], dim=-1)
        return self.trunk(x)


class DiscreteSymbolStyleMelGANGenerator(_TokenEmbed):
    """(ids (B, T, 2), z (B, nf, in_channels)) -> wave (B, nf x
    noise_upsample_factor x upsample_factor, out_channels)."""

    def __init__(
        self,
        in_channels: int = 128,
        aux_channels: int = 128,
        channels: int = 64,
        out_channels: int = 1,
        num_embs: int = 100,
        num_spk_embs: int = 128,
        spk_emb_dim: int = 128,
        concat_spk_emb: bool = False,
        kernel_size: int = 9,
        dilation: int = 2,
        bias: bool = True,
        noise_upsample_scales: Sequence[int] = (11, 2, 2, 2),
        noise_upsample_activation: str = "LeakyReLU",
        noise_upsample_activation_params: Optional[Dict[str, Any]] = None,
        upsample_scales: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2, 1),
        upsample_mode: str = "nearest",
        gated_function: str = "softmax",
        use_weight_norm: bool = True,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if num_spk_embs <= 0:
            raise ValueError("the token StyleMelGAN takes speaker ids "
                             "(num_spk_embs > 0)")
        width = self._build_embed(aux_channels, num_embs, num_spk_embs,
                                  spk_emb_dim, concat_spk_emb, False, 0,
                                  generator)
        self.trunk = StyleMelGANGenerator(
            in_channels, width, channels, out_channels, kernel_size,
            dilation, bias, noise_upsample_scales, noise_upsample_activation,
            noise_upsample_activation_params, upsample_scales, upsample_mode,
            gated_function, use_weight_norm, folded=folded,
            generator=generator)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.noise_upsample_scales = self.trunk.noise_upsample_scales

    @property
    def noise_upsample_factor(self) -> int:
        return self.trunk.noise_upsample_factor

    @property
    def upsample_factor(self) -> int:
        return self.trunk.upsample_factor

    def noise_frames(self, frames: int) -> int:
        return self.trunk.noise_frames(frames)

    def draw_noise(self, batch: int, frames: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """z (batch, noise_frames(frames), in_channels), as the trunk's."""
        return self.trunk.draw_noise(batch, frames, generator)

    def forward(self, c: torch.Tensor, z: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.trunk(self._embed_tokens(c), z, generator)
