"""1-D convolution primitives, channels-last (B, T, C), torch-style math.

Counterpart of ``parallelwavegan_tpu/ops/conv.py``. The kernel layout is the
JAX package's (K, Cin, Cout), so converted parameters load unchanged; the
calls map it onto ``torch.nn.functional``'s (B, C, T) layout. The polyphase
form of the transposed conv is not ported: no layer of the JAX package
uses it.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

PadLike = Union[int, Tuple[int, int]]


def pad1d(x: torch.Tensor, pad: Tuple[int, int]) -> torch.Tensor:
    """Zero padding of the time axis of (B, T, C)."""
    if tuple(pad) == (0, 0):
        return x
    return F.pad(x, (0, 0, pad[0], pad[1]))


def conv1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding: PadLike = 0,
    dilation: int = 1,
) -> torch.Tensor:
    """x (B, T, Cin) * kernel (K, Cin, Cout) -> (B, T', Cout), stride 1,
    zero padding of ``padding`` frames (an int, or (left, right))."""
    lo, hi = (padding, padding) if isinstance(padding, int) else padding
    if lo != hi:
        x = pad1d(x, (lo, hi))
        lo = 0
    y = F.conv1d(x.transpose(1, 2), kernel.permute(2, 1, 0), bias,
                 padding=lo, dilation=dilation)
    return y.transpose(1, 2)


def conv_transpose1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 0,
    output_padding: int = 0,
) -> torch.Tensor:
    """Transposed conv with torch's length semantics,
    out = (T - 1) * stride - 2 * padding + K + output_padding:
    x (B, T, Cin) * kernel (K, Cin, Cout) -> (B, out, Cout), with
    y[n] = sum_t x[t] . kernel[n + padding - t * stride]."""
    y = F.conv_transpose1d(x.transpose(1, 2), kernel.permute(1, 2, 0), bias,
                           stride=stride, padding=padding,
                           output_padding=output_padding)
    return y.transpose(1, 2)
