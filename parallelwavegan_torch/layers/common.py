"""Core modules: the channels-last Conv1d, initializers, activations.

Counterpart of ``parallelwavegan_tpu/layers/common.py``. Kernels keep the
JAX package's (K..., Cin, Cout) layout. Initializers draw from an explicit
``torch.Generator`` and follow the JAX package's distributions: PWG convs
kaiming-normal (relu) with zero bias, the upsample smoothing conv a mean
filter. The modules hold the *folded* kernel (weight norm already applied,
see ``utils/params.py``): at initialisation weight norm sets g = ||v||, so
the folded kernel is the initializer's sample.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from parallelwavegan_torch.ops import conv as conv_ops
from parallelwavegan_torch.ops.conv import PadLike

Initializer = Callable[..., torch.Tensor]


def _fan_in(shape: Sequence[int]) -> int:
    return math.prod(shape[:-1])


def kaiming_normal_relu_init(shape, generator=None, dtype=torch.float32):
    """torch.nn.init.kaiming_normal_(nonlinearity='relu'): N(0, 2/fan_in)."""
    std = math.sqrt(2.0 / _fan_in(shape))
    return std * torch.randn(shape, generator=generator, dtype=dtype)


def zeros_init(shape, generator=None, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def mean_filter_init(shape, generator=None, dtype=torch.float32):
    """Smoothing-conv init to a mean filter over all but the last two axes."""
    return torch.full(shape, 1.0 / math.prod(shape[:-2]), dtype=dtype)


def get_activation(name: Optional[str], params: Optional[dict] = None):
    """Map a torch.nn activation class name (as configs spell it) to a
    function; the slice covers None, ReLU and LeakyReLU."""
    params = dict(params or {})
    if name is None:
        return lambda x: x
    if name == "LeakyReLU":
        return partial(F.leaky_relu,
                       negative_slope=params.get("negative_slope", 0.01))
    if name == "ReLU":
        return F.relu
    raise NotImplementedError(f"activation {name} is not ported yet")


class Conv1d(nn.Module):
    """Conv1d on (B, T, Cin) -> (B, T', Cout) with zero padding; the
    kernel is a plain (folded) parameter. The default inits are PWG's (the
    JAX module's default, torch's uniform init, has no caller in the port)."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int = 1,
        dilation: int = 1,
        bias: bool = True,
        padding: PadLike = 0,
        kernel_init: Initializer = kaiming_normal_relu_init,
        bias_init: Initializer = zeros_init,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dilation, self.padding = dilation, padding
        shape = (kernel_size, in_channels, features)
        self.kernel = nn.Parameter(kernel_init(shape, generator))
        if bias:
            self.bias = nn.Parameter(bias_init((features,), generator))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_ops.conv1d(x, self.kernel, self.bias, self.padding,
                               self.dilation)
