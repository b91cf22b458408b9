"""Residual blocks, channels-last (B, T, C).

Counterparts of ``WaveNetResidualBlock`` and ``HiFiGANResidualBlock`` in
``parallelwavegan_tpu/layers/residual_block.py``: the per-layer (unfused)
forwards that the plain generators run. ``use_causal_conv`` pads the
dilated convs on the left only (the WaveNet block's conv by (K - 1) d
frames, the HiFi-GAN block's through ``CausalConv1d`` under
``convs1_<i>.conv`` / ``convs2_<i>.conv``, as in the flax tree). The
WaveNet block's dropout (on its input, before the dilated conv) takes a
keep mask from the caller (``apply_dropout_mask``), never drawn inside the
forward.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from parallelwavegan_torch.layers.causal_conv import CausalConv1d
from parallelwavegan_torch.layers.common import (
    Conv1d,
    Initializer,
    apply_dropout_mask,
    get_activation,
    kaiming_normal_relu_init,
    uniform_bias_init_for,
)


class WaveNetResidualBlock(nn.Module):
    """Dilated gated residual block: conv -> split -> +aux -> tanh*sigmoid
    -> 1x1 skip & 1x1 residual, residual scaled by sqrt(0.5)."""

    def __init__(
        self,
        kernel_size: int = 3,
        residual_channels: int = 64,
        gate_channels: int = 128,
        skip_channels: int = 64,
        aux_channels: int = 80,
        dropout: float = 0.0,
        dilation: int = 1,
        bias: bool = True,
        use_causal_conv: bool = False,
        use_weight_norm: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if use_causal_conv:
            padding = ((kernel_size - 1) * dilation, 0)
        elif (kernel_size - 1) % 2:
            raise ValueError("kernel_size must be odd")
        else:
            padding = (kernel_size - 1) // 2 * dilation
        self.dropout = float(dropout)
        gate_out = gate_channels // 2
        self.conv = Conv1d(
            residual_channels, gate_channels, kernel_size, dilation=dilation,
            bias=bias, padding=padding, use_weight_norm=use_weight_norm,
            generator=generator,
        )
        self.conv1x1_aux = (
            Conv1d(aux_channels, gate_channels, 1, bias=False,
                   use_weight_norm=use_weight_norm, generator=generator)
            if aux_channels > 0 else None
        )
        self.conv1x1_skip = Conv1d(gate_out, skip_channels, 1, bias=bias,
                                   use_weight_norm=use_weight_norm,
                                   generator=generator)
        self.conv1x1_out = Conv1d(gate_out, residual_channels, 1, bias=bias,
                                  use_weight_norm=use_weight_norm,
                                  generator=generator)

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``mask``: the keep mask (bool, x's shape) of a training forward
        with dropout; None for a deterministic one."""
        residual = x
        if mask is not None and self.dropout > 0.0:
            x = apply_dropout_mask(x, mask, self.dropout)
        x = self.conv(x)
        gate_out = x.shape[-1] // 2
        if c is not None:
            x = x + self.conv1x1_aux(c)
        x = torch.tanh(x[..., :gate_out]) * torch.sigmoid(x[..., gate_out:])
        s = self.conv1x1_skip(x)
        x = (self.conv1x1_out(x) + residual) * math.sqrt(0.5)
        return x, s


class HiFiGANResidualBlock(nn.Module):
    """Per dilation d: act + conv(k, d) [+ act + conv(k, 1)] + identity.
    Submodules are named ``convs1_<i>`` / ``convs2_<i>`` as in the flax
    tree."""

    def __init__(
        self,
        kernel_size: int = 3,
        channels: int = 512,
        dilations: Sequence[int] = (1, 3, 5),
        bias: bool = True,
        use_additional_convs: bool = True,
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: Optional[dict] = None,
        use_causal_conv: bool = False,
        use_weight_norm: bool = False,
        kernel_init: Initializer = kaiming_normal_relu_init,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("kernel_size must be odd")
        self.dilations = tuple(dilations)
        self.act = get_activation(
            nonlinear_activation,
            nonlinear_activation_params or {"negative_slope": 0.1},
        )
        bias_init = uniform_bias_init_for((kernel_size, channels, channels))
        self.convs1: List[nn.Module] = []
        self.convs2: List[nn.Module] = []
        for i, d in enumerate(self.dilations):
            for name, dil, convs in (("convs1", d, self.convs1),
                                     ("convs2", 1, self.convs2)):
                if name == "convs2" and not use_additional_convs:
                    continue
                if use_causal_conv:
                    # CausalConv1d's inner conv takes torch's uniform bias,
                    # as the JAX module's
                    conv = CausalConv1d(
                        channels, channels, kernel_size, dilation=dil,
                        bias=bias, use_weight_norm=use_weight_norm,
                        kernel_init=kernel_init, generator=generator)
                else:
                    conv = Conv1d(
                        channels, channels, kernel_size, dilation=dil,
                        bias=bias, padding=(kernel_size - 1) // 2 * dil,
                        kernel_init=kernel_init, bias_init=bias_init,
                        use_weight_norm=use_weight_norm, generator=generator,
                    )
                self.add_module(f"{name}_{i}", conv)
                convs.append(conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv1 in enumerate(self.convs1):
            xt = conv1(self.act(x))
            if self.convs2:
                xt = self.convs2[i](self.act(xt))
            x = xt + x
        return x
