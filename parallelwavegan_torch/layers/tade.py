"""StyleMelGAN's TADE layers, channels-last (B, T, C).

Counterpart of ``parallelwavegan_tpu/layers/tade.py``. ``TADELayer``
instance-normalises x, upsamples it and the conditioning c by nearest
neighbour, and modulates x by two convs of c: y = gamma(c') * up(norm(x)) +
beta(c'), where c' = aux_conv(up(c)) and [gamma | beta] = gated_conv(c')
split as ``[..., :C]`` / ``[..., C:]``; it returns (y, c'). ``TADEResBlock``
is TADE -> gated conv -> TADE (upsampling) -> gated dilated conv, plus the
upsampled input, with a softmax over channels or a sigmoid as the gate;
the conditioning it returns feeds the next block. Names follow the flax
tree (``tade1``, ``gated_conv1``, ``tade2``, ``gated_conv2``; in a TADE
layer ``aux_conv``, ``gated_conv``); the convs take torch's default
uniform inits, as the JAX module's. ``use_weight_norm`` gives a conv
``kernel_v`` / ``kernel_g`` (the training form), else one folded ``kernel``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from parallelwavegan_torch.layers.common import (
    Conv1d,
    instance_norm_1d,
    torch_conv_default_init,
)
from parallelwavegan_torch.ops.conv import upsample_nearest_time

_GATES = {
    "softmax": lambda v: torch.softmax(v, dim=-1),
    "sigmoid": torch.sigmoid,
}


def _conv(cin: int, cout: int, kernel_size: int, bias: bool,
          use_weight_norm: bool, generator, dilation: int = 1) -> Conv1d:
    return Conv1d(cin, cout, kernel_size, dilation=dilation, bias=bias,
                  padding=(kernel_size - 1) // 2 * dilation,
                  kernel_init=torch_conv_default_init, bias_init=None,
                  use_weight_norm=use_weight_norm, generator=generator)


class TADELayer(nn.Module):
    def __init__(self, in_channels: int = 64, aux_channels: int = 80,
                 kernel_size: int = 9, bias: bool = True,
                 upsample_factor: int = 2, use_weight_norm: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.upsample_factor = upsample_factor
        self.aux_conv = _conv(aux_channels, in_channels, kernel_size, bias,
                              use_weight_norm, generator)
        self.gated_conv = _conv(in_channels, 2 * in_channels, kernel_size,
                                bias, use_weight_norm, generator)

    def forward(self, x: torch.Tensor, c: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = instance_norm_1d(x)
        c = self.aux_conv(upsample_nearest_time(c, self.upsample_factor))
        cg = self.gated_conv(c)
        C = self.in_channels
        y = cg[..., :C] * upsample_nearest_time(x, self.upsample_factor) \
            + cg[..., C:]
        return y, c


class TADEResBlock(nn.Module):
    def __init__(self, in_channels: int = 64, aux_channels: int = 80,
                 kernel_size: int = 9, dilation: int = 2, bias: bool = True,
                 upsample_factor: int = 2, gated_function: str = "softmax",
                 use_weight_norm: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if gated_function not in _GATES:
            raise ValueError(f"{gated_function} is not supported.")
        self.gate = _GATES[gated_function]
        self.in_channels = in_channels
        self.upsample_factor = upsample_factor
        kw = dict(bias=bias, use_weight_norm=use_weight_norm,
                  generator=generator)
        self.tade1 = TADELayer(in_channels, aux_channels, kernel_size,
                               upsample_factor=1, **kw)
        self.gated_conv1 = _conv(in_channels, 2 * in_channels, kernel_size,
                                 **kw)
        self.tade2 = TADELayer(in_channels, in_channels, kernel_size,
                               upsample_factor=upsample_factor, **kw)
        self.gated_conv2 = _conv(in_channels, 2 * in_channels, kernel_size,
                                 dilation=dilation, **kw)

    def _gated(self, x: torch.Tensor) -> torch.Tensor:
        C = self.in_channels
        return self.gate(x[..., :C]) * torch.tanh(x[..., C:])

    def forward(self, x: torch.Tensor, c: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        residual = x
        x, c = self.tade1(x, c)
        x = self._gated(self.gated_conv1(x))
        x, c = self.tade2(x, c)
        x = self._gated(self.gated_conv2(x))
        return upsample_nearest_time(residual, self.upsample_factor) + x, c
