"""Causal convolutions, channels-last (B, T, C).

Counterpart of ``parallelwavegan_tpu/layers/causal_conv.py``.
``CausalConv1d`` pads (K - 1) d frames on both sides and keeps the first T
outputs, so output t sees inputs up to t only (the reference's form, which
keeps reflect and replicate pads exact). ``CausalConvTranspose1d`` pads
one frame on the left (replicating the edge by default), upsamples and
crops ``stride`` outputs from each end: T_in * stride frames. The convs
sit under ``conv`` / ``deconv`` as in the flax tree; with
``use_weight_norm`` they hold ``kernel_v`` / ``kernel_g``, else the folded
``kernel``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from parallelwavegan_torch.layers.common import (
    Conv1d,
    ConvTranspose1d,
    Initializer,
    pad_mode_from_torch,
    torch_conv_default_init,
)
from parallelwavegan_torch.ops.conv import pad1d


class CausalConv1d(nn.Module):
    """Conv whose output t depends on inputs up to t only."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int,
        dilation: int = 1,
        bias: bool = True,
        pad: str = "ConstantPad1d",
        use_weight_norm: bool = False,
        kernel_init: Initializer = torch_conv_default_init,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation
        self.pad_mode = pad_mode_from_torch(pad)
        self.conv = Conv1d(in_channels, features, kernel_size,
                           dilation=dilation, bias=bias,
                           kernel_init=kernel_init, bias_init=None,
                           use_weight_norm=use_weight_norm,
                           generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = x.shape[1]
        x = pad1d(x, (self.pad, self.pad), self.pad_mode)
        return self.conv(x)[:, :T]


class CausalConvTranspose1d(nn.Module):
    """Transposed conv cropped to T_in * stride (a causal upsampler)."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int,
        stride: int,
        bias: bool = True,
        pad: str = "ReplicationPad1d",
        use_weight_norm: bool = False,
        kernel_init: Initializer = torch_conv_default_init,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.stride = stride
        self.pad_mode = pad_mode_from_torch(pad)
        self.deconv = ConvTranspose1d(in_channels, features, kernel_size,
                                      stride=stride, bias=bias,
                                      kernel_init=kernel_init,
                                      use_weight_norm=use_weight_norm,
                                      generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.deconv(pad1d(x, (1, 0), self.pad_mode))
        return y[:, self.stride: -self.stride]
