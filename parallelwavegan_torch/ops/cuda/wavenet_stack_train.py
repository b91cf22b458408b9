"""Trainable fused WaveNet stack: the forward kernel with saved inputs and
the hand-written backward kernel, tied together by autograd.

Counterpart of ``parallelwavegan_tpu/ops/pallas/wavenet_stack_train.py``.
``wavenet_stack_train`` has the contract of ``wavenet_stack`` and is
differentiable in x, c and every weight. For CUDA tensors its forward runs
``csrc/wavenet_stack.cu`` with ``save_inputs`` (each layer's input, rounded
to the weight dtype, goes to xs (L, B, T, R)) and its backward runs
``csrc/wavenet_stack_bwd.cu`` (its design and bound are in the note at the
head of that file); CPU tensors take ``wavenet_stack_train_reference``,
autograd through the plain forward.

Backward math per layer, last layer first, with D = dL/dx_{l+1} and
dskip = dL/dskip:
    z, ta = tanh(z[:R]), sig = sigmoid(z[R:]), g = ta * sig    # recomputed
    dso   = [dskip | D * sqrt(.5)]
    dg    = dso @ Wso^T
    dz    = [dg * sig * (1 - ta^2) | dg * ta * sig * (1 - sig)]
    dWt  += xcat^T @ dz   dbt += sum dz   dWa += c^T @ dz
    dWso += g^T @ dso     dbso += sum dso
    dc   += dz @ Wa^T
    dx_l  = D * sqrt(.5) + the three taps of dz @ Wt^T shifted by +d, 0, -d

The weight gradients are sums over all B*T rows: the kernel writes one f32
partial per slab of rows and the wrapper adds the slabs with one
``torch.sum``, which is deterministic. xs is allocated once per call and
freed with the autograd graph after the backward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

from parallelwavegan_torch.ops.cuda.build import load_library
from parallelwavegan_torch.ops.cuda.wavenet_stack import (
    _DTYPE_CODES,
    wavenet_stack,
    wavenet_stack_reference,
)

_WEIGHT_KEYS = ("w_tap", "b_tap", "w_aux", "w_so", "b_so")
# slabs of rows the weight-gradient launch splits B*T into: enough blocks
# (slabs x 6 output tiles) to fill 132 SMs twice over at the training shape
_MAX_SLABS = 64
_MIN_ROWS_PER_SLAB = 256


def wavenet_stack_train_reference(
    x: torch.Tensor, c: torch.Tensor, w: Dict[str, torch.Tensor],
    dilations: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the plain forward, differentiated by autograd."""
    return wavenet_stack_reference(x, c, w, dilations)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("wavenet_stack_bwd")
    fn = lib.pwg_wavenet_stack_backward
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 16
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 5
        + [ctypes.c_void_p]
    )
    lib.pwg_cuda_error_string.restype = ctypes.c_char_p
    lib.pwg_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def wavenet_stack_backward(
    xs: torch.Tensor, c: torch.Tensor, w: Dict[str, torch.Tensor],
    dilations: Sequence[int], dx_out: torch.Tensor, dskip: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Launch the backward kernel: (dx, dc, {weight grads}) from the saved
    inputs xs (L, B, T, R), c (B, T, A), the forward's weights (``w_so``'s
    bias is not needed) and the cotangents of x_out (B, T, R) and skip
    (B, T, S). CUDA tensors only. Each layer is a data-gradient and a
    weight-gradient launch; ``wavenet_stack_backward.launches`` counts
    layers, as the forward's count does."""
    if xs.device.type != "cuda":
        raise ValueError(f"the backward kernel needs CUDA tensors, got "
                         f"{xs.device}")
    L, B, T, R = xs.shape
    A = c.shape[-1]
    G, SR = w["w_tap"].shape[-1], w["w_so"].shape[-1]
    dt = xs.dtype
    if len(dilations) != L or dt not in _DTYPE_CODES:
        raise ValueError(f"xs {tuple(xs.shape)} {dt} vs {L} dilations")
    f32 = torch.float32
    with torch.cuda.device(xs.device):
        # layouts the kernel reads its transposed products from
        w_so_t = w["w_so"].transpose(1, 2).contiguous()
        w_cat_t = torch.cat(
            [w["w_tap"].reshape(L, 3 * R, G), w["w_aux"]], dim=1
        ).transpose(1, 2).contiguous()
        inputs = {"xs": xs, "c": c, "w_tap": w["w_tap"], "b_tap": w["b_tap"],
                  "w_aux": w["w_aux"]}
        for name, t in inputs.items():
            if t.dtype != dt or t.device != xs.device:
                raise TypeError(f"{name} is {t.dtype} on {t.device}, xs is "
                                f"{dt} on {xs.device}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(
                    f"{name} must be contiguous and 16-byte aligned")
        n_slabs = max(1, min(_MAX_SLABS, B * T // _MIN_ROWS_PER_SLAB))
        n_tiles = 3 + -(-A // 64) + 1
        dev = xs.device
        # D starts as the cotangent of x_out and carries dL/dx_l downwards
        D = dx_out.to(f32).contiguous().clone()
        dskip = dskip.to(f32).contiguous()
        taps = [torch.empty((B, T, 3 * R), dtype=f32, device=dev)
                for _ in range(2)]
        dc = torch.empty((B, T, A), dtype=f32, device=dev)
        dz = torch.empty((B, T, G), dtype=f32, device=dev)
        g = torch.empty((B, T, R), dtype=f32, device=dev)
        partial = torch.empty((L, n_slabs, n_tiles, 65, 128), dtype=f32,
                              device=dev)
        dx = torch.empty((B, T, R), dtype=dt, device=dev)
        dil = (ctypes.c_int * L)(*[int(d) for d in dilations])
        lib = _library()
        err = lib.pwg_wavenet_stack_backward(
            _DTYPE_CODES[dt], xs.data_ptr(), c.data_ptr(),
            w["w_tap"].data_ptr(), w["b_tap"].data_ptr(),
            w["w_aux"].data_ptr(), w_so_t.data_ptr(), w_cat_t.data_ptr(),
            dskip.data_ptr(), D.data_ptr(), taps[0].data_ptr(),
            taps[1].data_ptr(), dc.data_ptr(), dz.data_ptr(), g.data_ptr(),
            partial.data_ptr(), dx.data_ptr(), dil, L, B, T, A, n_slabs,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(
                "wavenet_stack backward kernel launch failed: "
                + lib.pwg_cuda_error_string(err).decode()
            )
        wavenet_stack_backward.launches += L
        p = partial.sum(dim=1)  # (L, n_tiles, 65, 128)
    nc = n_tiles - 4
    dw = {
        "w_tap": p[:, 0:3, :64],
        "b_tap": p[:, 0, 64],
        "w_aux": p[:, 3:3 + nc, :64].reshape(L, nc * 64, G)[:, :A],
        "w_so": p[:, n_tiles - 1, :64],
        "b_so": p[:, n_tiles - 1, 64],
    }
    return dx, dc.to(c.dtype), {k: v.to(dt) for k, v in dw.items()}


wavenet_stack_backward.launches = 0


class _WaveNetStackTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, w_tap, b_tap, w_aux, w_so, b_so, dilations):
        w = dict(zip(_WEIGHT_KEYS, (w_tap, b_tap, w_aux, w_so, b_so)))
        x_out, skip, xs = wavenet_stack(x, c, w, dilations, save_inputs=True)
        ctx.save_for_backward(xs, c, w_tap, b_tap, w_aux, w_so)
        ctx.dilations = tuple(dilations)
        return x_out, skip

    @staticmethod
    def backward(ctx, dx_out, dskip):
        xs, c, w_tap, b_tap, w_aux, w_so = ctx.saved_tensors
        w = {"w_tap": w_tap, "b_tap": b_tap, "w_aux": w_aux, "w_so": w_so}
        dx, dc, dw = wavenet_stack_backward(xs, c, w, ctx.dilations, dx_out,
                                            dskip)
        return (dx, dc, *(dw[k] for k in _WEIGHT_KEYS), None)


def wavenet_stack_train(
    x: torch.Tensor, c: torch.Tensor, w: Dict[str, torch.Tensor],
    dilations: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wavenet_stack`` with a gradient: returns (x_out (B, T, R),
    skip sum (B, T, S) float32), differentiable in x, c and w.

    CPU tensors take the plain version. CUDA tensors launch the forward
    kernel with saved inputs and, in the backward, the backward kernel, or
    raise; where no gradient is recorded (``torch.no_grad``, or nothing
    requires one) they take the forward kernel alone and save nothing.
    """
    if x.device.type == "cpu":
        return wavenet_stack_train_reference(x, c, w, dilations)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, c, *(w[k] for k in _WEIGHT_KEYS))
    )
    if not needs_grad:
        return wavenet_stack(x, c, w, dilations)
    return _WaveNetStackTrain.apply(
        x, c, *(w[k] for k in _WEIGHT_KEYS), tuple(dilations)
    )
