"""HiFi-GAN generator, channels-last (B, T, C).

Counterpart of ``HiFiGANGenerator`` in
``parallelwavegan_tpu/models/hifigan.py``: Conv7 -> per scale [LeakyReLU,
transposed conv (k = 2 s), the mean of the multi-receptive-field residual
blocks] -> LeakyReLU(0.01), Conv7, tanh. Submodule names follow the flax
tree (``input_conv``, ``upsamples_<i>``, ``blocks_<i * n + j>``,
``output_conv``), so a converted tree loads with ``strict=True``. The
discriminators are not ported yet.

``folded=True`` (the default, the serving form) holds every kernel with
weight norm applied; ``folded=False`` holds ``kernel_v``/``kernel_g``
where ``use_weight_norm`` asks for them. The serving path
(``ops/hifigan_infer.hifigan_fast_forward``) reads the folded kernels from
these modules.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from parallelwavegan_torch.layers.common import (
    Conv1d,
    ConvTranspose1d,
    get_activation,
    normal_init,
    uniform_bias_init_for,
)
from parallelwavegan_torch.layers.residual_block import HiFiGANResidualBlock


class HiFiGANGenerator(nn.Module):
    """Mel (B, T', in_channels) -> wave (B, T' * prod(scales), out)."""

    def __init__(
        self,
        in_channels: int = 80,
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
        use_causal_conv: bool = False,
        use_weight_norm: bool = True,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if use_causal_conv:
            raise NotImplementedError(
                "the causal HiFi-GAN generator is not ported yet")
        if kernel_size % 2 != 1:
            raise ValueError("kernel_size must be odd")
        if len(upsample_scales) != len(upsample_kernel_sizes):
            raise ValueError("upsample_scales and upsample_kernel_sizes "
                             "differ in length")
        if len(resblock_dilations) != len(resblock_kernel_sizes):
            raise ValueError("resblock_dilations and resblock_kernel_sizes "
                             "differ in length")
        weight_norm = use_weight_norm and not folded
        self.in_channels, self.out_channels = in_channels, out_channels
        self.channels, self.kernel_size = channels, kernel_size
        self.upsample_scales = tuple(upsample_scales)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilations = tuple(tuple(d) for d in resblock_dilations)
        self.use_additional_convs = use_additional_convs
        self.use_causal_conv = use_causal_conv
        self.nonlinear_activation_params = dict(
            {"negative_slope": 0.1}, **(nonlinear_activation_params or {}))
        self.act = get_activation(nonlinear_activation,
                                  self.nonlinear_activation_params)
        kinit = normal_init(0.01)
        conv_kw = dict(bias=bias, kernel_init=kinit,
                       use_weight_norm=weight_norm, generator=generator)
        pad = (kernel_size - 1) // 2
        self.input_conv = Conv1d(
            in_channels, channels, kernel_size, padding=pad,
            bias_init=uniform_bias_init_for(
                (kernel_size, in_channels, channels)), **conv_kw)
        self.upsamples: List[ConvTranspose1d] = []
        self.blocks: List[HiFiGANResidualBlock] = []
        num_blocks = len(self.resblock_kernel_sizes)
        for i, (s, k_up) in enumerate(zip(self.upsample_scales,
                                          self.upsample_kernel_sizes)):
            if k_up != 2 * s:
                raise ValueError("upsample kernel sizes must be twice the "
                                 "scales")
            out_ch = channels // (2 ** (i + 1))
            up = ConvTranspose1d(
                channels // (2 ** i), out_ch, k_up, stride=s,
                padding=s // 2 + s % 2, output_padding=s % 2, **conv_kw)
            self.add_module(f"upsamples_{i}", up)
            self.upsamples.append(up)
            for j, (k_res, dils) in enumerate(zip(
                    self.resblock_kernel_sizes, self.resblock_dilations)):
                block = HiFiGANResidualBlock(
                    kernel_size=k_res, channels=out_ch, dilations=dils,
                    bias=bias, use_additional_convs=use_additional_convs,
                    nonlinear_activation=nonlinear_activation,
                    nonlinear_activation_params=(
                        self.nonlinear_activation_params),
                    use_weight_norm=weight_norm, kernel_init=kinit,
                    generator=generator,
                )
                self.add_module(f"blocks_{i * num_blocks + j}", block)
                self.blocks.append(block)
        last = channels // (2 ** len(self.upsample_scales))
        self.output_conv = Conv1d(
            last, out_channels, kernel_size, padding=pad,
            bias_init=uniform_bias_init_for((kernel_size, last, out_channels)),
            **conv_kw)

    @property
    def upsample_factor(self) -> int:
        return math.prod(self.upsample_scales)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        c = self.input_conv(c)
        num_blocks = len(self.resblock_kernel_sizes)
        for i, up in enumerate(self.upsamples):
            c = up(self.act(c))
            cs = 0.0
            for block in self.blocks[i * num_blocks:(i + 1) * num_blocks]:
                cs = cs + block(c)
            c = cs / num_blocks
        # the official implementation uses the default slope (0.01) here
        c = F.leaky_relu(c, 0.01)
        return torch.tanh(self.output_conv(c))
