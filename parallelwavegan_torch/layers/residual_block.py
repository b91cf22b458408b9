"""WaveNet gated residual block, channels-last (B, T, C).

Counterpart of ``WaveNetResidualBlock`` in
``parallelwavegan_tpu/layers/residual_block.py``: the per-layer (unfused)
forward that the plain generator runs. Non-causal, no dropout.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from parallelwavegan_torch.layers.common import Conv1d


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
            raise NotImplementedError("causal WaveNet blocks are not ported yet")
        if dropout > 0.0:
            raise NotImplementedError("dropout is not ported yet")
        if (kernel_size - 1) % 2:
            raise ValueError("kernel_size must be odd")
        gate_out = gate_channels // 2
        self.conv = Conv1d(
            residual_channels, gate_channels, kernel_size, dilation=dilation,
            bias=bias, padding=(kernel_size - 1) // 2 * dilation,
            use_weight_norm=use_weight_norm, generator=generator,
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

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        residual = x
        x = self.conv(x)
        gate_out = x.shape[-1] // 2
        if c is not None:
            x = x + self.conv1x1_aux(c)
        x = torch.tanh(x[..., :gate_out]) * torch.sigmoid(x[..., gate_out:])
        s = self.conv1x1_skip(x)
        x = (self.conv1x1_out(x) + residual) * math.sqrt(0.5)
        return x, s
