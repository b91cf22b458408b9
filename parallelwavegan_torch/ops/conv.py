"""Convolution and pooling primitives, channels-last, torch-style math.

Counterpart of ``parallelwavegan_tpu/ops/conv.py``, of the 2-d conv inside
the JAX package's ``layers/common.Conv2d`` and of ``avg_pool1d`` in its
``models/melgan.py``. The kernel layouts are the JAX package's,
(K, Cin / groups, Cout) and (KH, KW, Cin, Cout), so converted
parameters load unchanged; the calls map them onto
``torch.nn.functional``'s channels-first layouts. The polyphase form of the
transposed conv is not ported: no layer of the JAX package uses it.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

PadLike = Union[int, Tuple[int, int]]


def pad1d(x: torch.Tensor, pad: Tuple[int, int], mode: str = "zeros"
          ) -> torch.Tensor:
    """Pad the time axis of (B, T, C) with zeros, by reflection or by
    replicating the edge frames."""
    if tuple(pad) == (0, 0):
        return x
    if mode == "zeros":
        return F.pad(x, (0, 0, pad[0], pad[1]))
    if mode in ("reflect", "replicate"):
        return F.pad(x.transpose(1, 2), tuple(pad), mode=mode).transpose(1, 2)
    raise ValueError(f"unsupported pad mode: {mode}")


def conv1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding: PadLike = 0,
    dilation: int = 1,
    stride: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """x (B, T, Cin) * kernel (K, Cin / groups, Cout) -> (B, T', Cout),
    zero padding of ``padding`` frames (an int, or (left, right))."""
    lo, hi = (padding, padding) if isinstance(padding, int) else padding
    if lo != hi:
        x = pad1d(x, (lo, hi))
        lo = 0
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        # PyTorch's bf16 conv1d on the CPU returns wrong sums for some
        # shapes (Cin * K of 64 or 128, e.g. PQMF's (16, 4, 4) kernel); a
        # bf16 conv sums in f32 and rounds once, which this does
        y = conv1d(x.float(), kernel.float(),
                   None if bias is None else bias.float(), lo, dilation,
                   stride, groups)
        return y.to(torch.bfloat16)
    y = F.conv1d(x.transpose(1, 2), kernel.permute(2, 1, 0), bias,
                 stride=stride, padding=lo, dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv1d_product(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, padding: int = 0
                   ) -> torch.Tensor:
    """``conv1d`` at stride 1, dilation 1 and one group as one matrix
    product: the K shifted frames of the zero-padded x side by side,
    (B, T', K * Cin), times the kernel as (K * Cin, Cout). On the card
    this is cuBLAS's f32 product, which lies from float64 as the CPU's
    conv does; cuDNN's f32 algorithm for a few dozen frames of 384
    channels (the duration predictor on tokens) lay 2-5 x further
    (ROADMAP C-5)."""
    K = kernel.shape[0]
    frames = pad1d(x, (padding, padding)).unfold(1, K, 1)  # (B, T', C, K)
    y = frames.transpose(2, 3).reshape(*frames.shape[:2], -1) @ \
        kernel.reshape(-1, kernel.shape[-1])
    return y if bias is None else y + bias


def conv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: Tuple[int, int] = (1, 1),
    padding: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """x (B, H, W, Cin) * kernel (KH, KW, Cin, Cout) -> (B, H', W', Cout),
    zero padding of ``padding`` = (rows, columns) on both sides. The
    kernel goes in contiguous: the CPU's float64 conv (``slow_conv2d``)
    refuses the weight gradient of a permuted (Cout 1, K, 1) kernel."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1)
                 .contiguous(), bias, stride=tuple(stride),
                 padding=tuple(padding))
    return y.permute(0, 2, 3, 1)


def avg_pool1d(x: torch.Tensor, kernel_size: int = 4, stride: int = 2,
               padding: int = 1, count_include_pad: bool = False
               ) -> torch.Tensor:
    """torch.nn.AvgPool1d on (B, T, C), written as the JAX package writes
    it: window sums over the zero-padded time axis, divided by the
    window's size or, without ``count_include_pad``, by its count of
    frames inside the signal. Not ``F.avg_pool1d``: on an H100 (PyTorch
    2.11, CUDA 12.8) its backward with ``count_include_pad=False`` returns
    input gradients up to 100 % of their largest entry wrong on some input
    layouts, while its forward is right."""
    sums = pad1d(x, (padding, padding)).unfold(1, kernel_size, stride).sum(-1)
    if count_include_pad:
        return sums / kernel_size
    inside = pad1d(torch.ones((1, x.shape[1], 1), dtype=x.dtype,
                              device=x.device), (padding, padding))
    return sums / inside.unfold(1, kernel_size, stride).sum(-1)


def upsample_nearest_time(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-neighbour upsampling along the time axis of (B, T, C)."""
    if scale == 1:
        return x
    B, T, C = x.shape
    return x[:, :, None, :].expand(B, T, scale, C).reshape(B, T * scale, C)


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
