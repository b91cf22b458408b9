"""U-Net HiFi-GAN (UHiFiGAN) for singing voice, channels-last (B, T, C).

Counterpart of ``parallelwavegan_tpu/models/uhifigan.py``. The excitation
waveform (a sine excitation of f0, ``ops/sine.py``) runs down an encoder:
Conv7, LeakyReLU, dropout, then per scale the mean of the
multi-receptive-field residual blocks, a strided conv doubling the
channels, LeakyReLU and dropout, each output kept as a skip. The mel
enters at the bottleneck through a Conv7; the decoder concatenates the
skips in reverse, applies LeakyReLU, a transposed conv halving the
channels and the residual blocks' mean; LeakyReLU(0.01), Conv7 and tanh
give the wave. f0 is accepted and unused, as in the JAX package and the
reference.

Submodules carry the flax names (``input_conv``, ``downsamples_<i>``,
``downsamples_mrf_<n>``, ``hidden_conv``, ``upsamples_<i>``,
``upsamples_mrf_<n>``, ``output_conv``), so a converted tree loads with
``strict=True``. ``folded=True`` (the serving form) holds every kernel
with weight norm applied; ``folded=False`` holds ``kernel_v``/``kernel_g``.

Dropout: five layers, after the input conv and after each downsampling
conv, active only when ``deterministic`` is false. Their keep masks are
given (``masks``, bool, in that call order), never drawn inside the
forward: ``draw_dropout_masks`` draws them from a ``torch.Generator``
(uniform < keep probability, as flax's ``bernoulli``), so that a train
step, a test or a gradient check can hand several routes the same masks.
A kept entry is x / keep (the keep probability rounded to x's dtype, as
flax divides by a weakly typed scalar), a dropped one 0.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from parallelwavegan_torch.layers.common import (
    Conv1d,
    ConvTranspose1d,
    apply_dropout_mask,
    draw_keep_masks,
    get_activation,
    normal_init,
)
from parallelwavegan_torch.layers.residual_block import HiFiGANResidualBlock


class UHiFiGANGenerator(nn.Module):
    """Mel (B, T', in_channels) and excitation (B, T' * prod(scales), 1)
    -> wave (B, T' * prod(scales), out_channels)."""

    def __init__(
        self,
        in_channels: int = 80,
        out_channels: int = 1,
        channels: int = 512,
        kernel_size: int = 7,
        downsample_scales: Sequence[int] = (8, 8, 2, 2),
        downsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
        upsample_scales: Sequence[int] = (8, 8, 2, 2),
        upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
        resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
        resblock_dilations: Sequence[Sequence[int]] = (
            (1, 3, 5), (1, 3, 5), (1, 3, 5)),
        dropout: float = 0.3,
        use_additional_convs: bool = True,
        bias: bool = True,
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: Optional[Dict[str, Any]] = None,
        use_causal_conv: bool = False,
        use_weight_norm: bool = True,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if use_causal_conv:
            raise NotImplementedError("causal UHiFiGAN is not supported")
        if kernel_size % 2 != 1:
            raise ValueError("kernel_size must be odd")
        for a, b, what in (
                (downsample_scales, downsample_kernel_sizes, "downsample"),
                (upsample_scales, upsample_kernel_sizes, "upsample"),
                (resblock_dilations, resblock_kernel_sizes, "resblock")):
            if len(a) != len(b):
                raise ValueError(f"the {what} lists differ in length")
        if len(downsample_scales) != len(upsample_scales):
            raise ValueError("as many upsampling as downsampling scales")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.channels = channels
        self.downsample_scales = tuple(downsample_scales)
        self.downsample_kernel_sizes = tuple(downsample_kernel_sizes)
        self.upsample_scales = tuple(upsample_scales)
        self.dropout = float(dropout)
        act_params = dict(nonlinear_activation_params
                          or {"negative_slope": 0.1})
        self.act = get_activation(nonlinear_activation, act_params)
        kinit = normal_init(0.01)
        weight_norm = use_weight_norm and not folded
        # bias_init None: torch's uniform bias for the kernel's fan-in, the
        # JAX module's default
        conv_kw = dict(bias=bias, kernel_init=kinit, bias_init=None,
                       use_weight_norm=weight_norm, generator=generator)
        pad = (kernel_size - 1) // 2

        def mrf(prefix: str, idx: int, ch: int) -> List[nn.Module]:
            blocks = []
            for j, (k_res, dils) in enumerate(zip(resblock_kernel_sizes,
                                                  resblock_dilations)):
                block = HiFiGANResidualBlock(
                    kernel_size=k_res, channels=ch, dilations=tuple(dils),
                    bias=bias, use_additional_convs=use_additional_convs,
                    nonlinear_activation=nonlinear_activation,
                    nonlinear_activation_params=act_params,
                    use_weight_norm=weight_norm, kernel_init=kinit,
                    generator=generator)
                self.add_module(
                    f"{prefix}_mrf_{idx * len(resblock_kernel_sizes) + j}",
                    block)
                blocks.append(block)
            return blocks

        self.input_conv = Conv1d(out_channels, channels, kernel_size,
                                 padding=pad, **conv_kw)
        self.down_mrfs: List[List[nn.Module]] = []
        self.downsamples: List[Conv1d] = []
        ch = channels
        for i, (s, k) in enumerate(zip(self.downsample_scales,
                                       self.downsample_kernel_sizes)):
            self.down_mrfs.append(mrf("downsamples", i, ch))
            conv = Conv1d(ch, ch * 2, k, stride=s, padding=s // 2 + s % 2,
                          **conv_kw)
            self.add_module(f"downsamples_{i}", conv)
            self.downsamples.append(conv)
            ch *= 2
        self.hidden_conv = Conv1d(in_channels, ch, kernel_size, padding=pad,
                                  **conv_kw)
        self.upsamples: List[ConvTranspose1d] = []
        self.up_mrfs: List[List[nn.Module]] = []
        for i, (s, k) in enumerate(zip(self.upsample_scales,
                                       upsample_kernel_sizes)):
            up = ConvTranspose1d(2 * ch, ch // 2, k, stride=s,
                                 padding=s // 2 + s % 2, output_padding=s % 2,
                                 **conv_kw)
            self.add_module(f"upsamples_{i}", up)
            self.upsamples.append(up)
            self.up_mrfs.append(mrf("upsamples", i, ch // 2))
            ch //= 2
        self.output_conv = Conv1d(ch, out_channels, kernel_size, padding=pad,
                                  **conv_kw)

    @property
    def upsample_factor(self) -> int:
        return math.prod(self.upsample_scales)

    def dropout_shapes(self, batch: int, samples: int
                       ) -> List[Tuple[int, int, int]]:
        """The five dropout layers' input shapes, in call order, for an
        excitation of (batch, samples, 1)."""
        shapes = [(batch, samples, self.channels)]
        T, ch = samples, self.channels
        for s, k in zip(self.downsample_scales, self.downsample_kernel_sizes):
            T = (T + 2 * (s // 2 + s % 2) - k) // s + 1
            ch *= 2
            shapes.append((batch, T, ch))
        return shapes

    def draw_dropout_masks(self, batch: int, samples: int,
                           generator: Optional[torch.Generator] = None
                           ) -> List[torch.Tensor]:
        """Keep masks (bool, on ``generator``'s device) of the five dropout
        layers for an excitation of (batch, samples, 1), in call order:
        uniform < 1 - dropout. An empty list when the rate is 0."""
        return draw_keep_masks(self.dropout_shapes(batch, samples),
                               self.dropout, generator)

    def batch_dropout_masks(self, batch: Dict[str, torch.Tensor],
                            generator: Optional[torch.Generator] = None
                            ) -> List[torch.Tensor]:
        """``draw_dropout_masks`` for a training forward of ``batch`` (its
        excitation (B, T, 1))."""
        B, T = batch["excitation"].shape[:2]
        return self.draw_dropout_masks(B, T, generator)

    def _drop(self, x: torch.Tensor, masks: Optional[List[torch.Tensor]],
              i: int) -> torch.Tensor:
        if masks is None or self.dropout == 0.0:
            return x
        return apply_dropout_mask(x, masks[i], self.dropout)

    @staticmethod
    def _mrf(blocks: List[nn.Module], x: torch.Tensor) -> torch.Tensor:
        cs = 0.0
        for block in blocks:
            cs = cs + block(x)
        return cs / len(blocks)

    def forward(self, c: torch.Tensor, f0: Optional[torch.Tensor] = None,
                excitation: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """c (B, T', in_channels), excitation (B, T, out_channels) ->
        (B, T, out_channels). With ``deterministic`` false the dropout
        layers apply ``masks`` (``draw_dropout_masks``'s list)."""
        del f0  # accepted and unused, as in the JAX package
        if excitation is None:
            raise ValueError("UHiFiGAN takes an excitation signal")
        if deterministic:
            masks = None
        elif masks is None and self.dropout > 0.0:
            raise ValueError("dropout is on (deterministic=False): pass the "
                             "masks, drawn by draw_dropout_masks")
        else:
            masks = list(masks or [])
        hidden = self._drop(self.act(self.input_conv(excitation)), masks, 0)
        skips = []
        for i, (blocks, conv) in enumerate(zip(self.down_mrfs,
                                               self.downsamples)):
            hidden = self._mrf(blocks, hidden)
            hidden = self._drop(self.act(conv(hidden)), masks, i + 1)
            skips.append(hidden)
        hidden_mel = self.hidden_conv(c)
        for up, blocks, skip in zip(self.upsamples, self.up_mrfs,
                                    reversed(skips)):
            hidden_mel = self.act(torch.cat([hidden_mel, skip], dim=-1))
            hidden_mel = self._mrf(blocks, up(hidden_mel))
        x = F.leaky_relu(hidden_mel, negative_slope=0.01)
        return torch.tanh(self.output_conv(x))
