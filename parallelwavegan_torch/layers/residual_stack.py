"""MelGAN residual stack, channels-last (B, T, C).

Counterpart of ``parallelwavegan_tpu/layers/residual_stack.py``:
activation -> pad -> dilated conv -> activation -> 1x1 conv, plus a 1x1
skip conv of the input. Names follow the flax tree (``conv_dilated``,
``conv1x1``, ``skip_layer``; a causal stack's dilated conv is a
``CausalConv1d``, so its kernel sits under ``conv_dilated.conv``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from parallelwavegan_torch.layers.causal_conv import CausalConv1d
from parallelwavegan_torch.layers.common import (
    Conv1d,
    Initializer,
    get_activation,
    pad_mode_from_torch,
    torch_conv_default_init,
)
from parallelwavegan_torch.ops.conv import pad1d


class ResidualStack(nn.Module):
    def __init__(
        self,
        kernel_size: int = 3,
        channels: int = 32,
        dilation: int = 1,
        bias: bool = True,
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: Optional[dict] = None,
        pad: str = "ReflectionPad1d",
        use_causal_conv: bool = False,
        use_weight_norm: bool = True,
        kernel_init: Initializer = torch_conv_default_init,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.act = get_activation(
            nonlinear_activation,
            nonlinear_activation_params or {"negative_slope": 0.2})
        conv_kw = dict(bias=bias, kernel_init=kernel_init,
                       use_weight_norm=use_weight_norm, generator=generator)
        if use_causal_conv:
            self.pad = None
            self.conv_dilated = CausalConv1d(channels, channels, kernel_size,
                                             dilation=dilation, pad=pad,
                                             **conv_kw)
        else:
            if (kernel_size - 1) % 2:
                raise ValueError("kernel_size must be odd")
            p = (kernel_size - 1) // 2 * dilation
            self.pad, self.pad_mode = (p, p), pad_mode_from_torch(pad)
            self.conv_dilated = Conv1d(channels, channels, kernel_size,
                                       dilation=dilation, bias_init=None,
                                       **conv_kw)
        self.conv1x1 = Conv1d(channels, channels, 1, bias_init=None,
                              **conv_kw)
        self.skip_layer = Conv1d(channels, channels, 1, bias_init=None,
                                 **conv_kw)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        x = self.act(c)
        if self.pad is not None:
            x = pad1d(x, self.pad, self.pad_mode)
        x = self.act(self.conv_dilated(x))
        return self.conv1x1(x) + self.skip_layer(c)
