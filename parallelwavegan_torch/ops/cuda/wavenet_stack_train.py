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

In bfloat16 the kernel rounds dso and dz to bf16 just before the products
that take them, where the TPU kernel rounds them;
:func:`wavenet_stack_backward_reference` is this math step by step, rounded
where the kernel rounds it.

The weight gradients are sums over all B*T rows: the kernel writes one f32
partial per slab of rows (and, in bf16, the bias gradients' column sums per
block) and the wrapper adds them with ``torch.sum``, which is deterministic.
xs is allocated once per call and freed with the autograd graph after the
backward.

:func:`backward_launch_plan` says which body runs: float32 on tensor cores
with split-TF32 products, bfloat16 on tensor cores with one bf16 product
each.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Sequence, Tuple

import torch

from parallelwavegan_torch.ops.cuda.build import load_library
from parallelwavegan_torch.ops.cuda.wavenet_stack import (
    _DTYPE_CODES,
    _SMEM_LIMIT,
    _TILE_ROWS,
    KERNEL_CHANNELS,
    _shift,
    wavenet_stack,
    wavenet_stack_reference,
)

_WEIGHT_KEYS = ("w_tap", "b_tap", "w_aux", "w_so", "b_so")
# the bodies of csrc/wavenet_stack_bwd.cu, as its C entry point numbers them
_BODY_CODES = {"tensor_cores_tf32x3": 1, "tensor_cores_bf16": 2}
# the weight launch splits B*T into as many slabs of rows as keep every
# block of the launch resident at once (two a SM), so it is one wave
_MIN_ROWS_PER_SLAB = 256
_WEIGHT_BLOCKS_PER_SM = 2
# the f32 body's layout, as the constants of namespace tc in
# csrc/wavenet_stack_bwd.cu set it (f32 words)
_TC_STAGES, _TC_CHUNK = 3, 32   # data launch: ring slots, rows of a chunk
_TC_ROW_STAGES = 4              # weight launch: ring slots
# the bf16 body's, as namespace bf sets it (bytes)
_BF_STAGES = 2                  # data launch: ring slots
_BF_ROW_STAGES = 4              # weight launch: ring slots
# rows of a weight-launch chunk; a slab's rows round up to whole chunks
_ROW_CHUNK = {"tensor_cores_tf32x3": 32, "tensor_cores_bf16": 64}


def backward_smem_bytes(A: int, body: str) -> Dict[str, int]:
    """Shared memory of the data and the weight launch of one layer.

    tensor_cores_tf32x3: a ring of three chunks, each 32 weight rows of 128
    columns (padded to 136) and the matching 32 activation columns of 64
    rows (padded to 36), beside the dso / dz tile [64][132], in f32; the
    weight launch's ring of four 32-row chunks of [64 | 128] columns
    (padded to 72 and 136). Neither launch grows with A: activations and
    weights stream in chunks.

    tensor_cores_bf16, all bf16 but the sums: the layer's resident weights
    [Wt; Wa padded to 16 rows; Wso] [4R + AP][128], the bias (f32), the
    column sums of a tile ([8][R] + [2][G] f32), the tiles of
    bf16(D_in sqrt(1/2)) [64][R] and bf16(dz) [64][G], and a ring of two
    slots, each three xs windows [64][R], dskip [64][S] and c [64][AP], every
    staged row padded by 16 bytes; the weight launch's ring of four 64-row
    chunks of [64 | 128] columns (rows padded by 16 bytes)."""
    R, G = KERNEL_CHANNELS["residual"], KERNEL_CHANNELS["gate"]
    S, T = KERNEL_CHANNELS["skip"], _TILE_ROWS
    if body == "tensor_cores_tf32x3":
        stage = _TC_CHUNK * (G + 8) + T * (_TC_CHUNK + 4)
        return {"data": 4 * (_TC_STAGES * stage + T * (G + 4)),
                "weight": 4 * _TC_ROW_STAGES * _TC_CHUNK
                * (64 + 8 + G + 8)}
    ap = -(-A // 16) * 16
    x_row, z_row = 2 * R + 16, 2 * G + 16
    stage = 4 * T * x_row + T * (2 * ap + 16)
    chunk = _ROW_CHUNK[body]
    return {"data": (4 * R + ap) * G * 2 + 4 * G + 4 * (8 * R + 2 * G)
            + T * x_row + T * z_row + _BF_STAGES * stage,
            "weight": _BF_ROW_STAGES * chunk * (x_row + z_row)}


def backward_launch_plan(B: int, T: int, A: int, L: int, dtype: torch.dtype,
                         sms: int = 132) -> dict:
    """How one ``wavenet_stack_backward`` call runs on the card.

    The body follows from dtype alone: float32 runs
    ``tensor_cores_tf32x3`` (every product as three TF32 mma.sync products,
    f32 accuracy), bfloat16 runs ``tensor_cores_bf16`` (one bf16 mma.sync
    product each, the cotangents rounded as the TPU kernel rounds them).
    Each layer is a data launch and a weight launch over ``weight_grid``
    (slabs of rows x output tiles); one last launch forms dx. The f32 data
    launch runs a block per tile over ``data_grid`` (64-row tiles x items);
    the bf16 one runs ``blocks`` persistent blocks (one an SM: its shared
    memory holds the layer's weights) over ``data_grid`` = (blocks,).
    ``launches`` is the count the wrapper adds to
    ``wavenet_stack_backward.launches`` (one a layer). Raises
    NotImplementedError where a launch would need more shared memory than
    a block may have (bf16: A above 112), or where A is not a multiple of 4
    (the kernels move c in 4-channel pieces)."""
    if dtype not in _DTYPE_CODES:
        raise NotImplementedError(f"no backward body for {dtype}")
    if A % 4:
        raise NotImplementedError(
            f"aux channels must be a multiple of 4, got {A}")
    body = ("tensor_cores_tf32x3" if dtype == torch.float32
            else "tensor_cores_bf16")
    smem = backward_smem_bytes(A, body)
    if max(smem.values()) > _SMEM_LIMIT:
        raise NotImplementedError(
            f"aux channels {A} need {max(smem.values())} bytes of shared "
            f"memory a block on the {body} body, more than {_SMEM_LIMIT}")
    rows = B * T
    tiles = B * -(-T // _TILE_ROWS)
    n_tiles = 3 + -(-A // 64) + 1
    slabs = max(1, min((_WEIGHT_BLOCKS_PER_SM * sms) // n_tiles,
                       rows // _MIN_ROWS_PER_SLAB))
    per_slab = -(-rows // slabs)
    chunk = _ROW_CHUNK[body]
    blocks = tiles if body == "tensor_cores_tf32x3" else min(tiles, sms)
    data_grid = ((-(-T // _TILE_ROWS), B) if body == "tensor_cores_tf32x3"
                 else (blocks,))
    return {"body": body, "launches": L, "launches_per_layer": 2,
            "tiles": tiles, "blocks": blocks, "data_grid": data_grid,
            "weight_grid": (slabs, n_tiles), "slabs": slabs,
            "rows_per_slab": -(-per_slab // chunk) * chunk,
            "data_smem": smem["data"], "weight_smem": smem["weight"]}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def wavenet_stack_train_reference(
    x: torch.Tensor, c: torch.Tensor, w: Dict[str, torch.Tensor],
    dilations: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the plain forward, differentiated by autograd."""
    return wavenet_stack_reference(x, c, w, dilations)


def wavenet_stack_backward_reference(
    xs: torch.Tensor, c: torch.Tensor, w: Dict[str, torch.Tensor],
    dilations: Sequence[int], dx_out: torch.Tensor, dskip: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain version of ``wavenet_stack_backward``: the same inputs and
    outputs, its math step by step (module docstring), every product
    accumulated in the wider of f32 and the matmul type. In bfloat16 the
    cotangents are rounded where the kernel and the TPU kernel round them:
    dso before dg and dWso, dz before dWt, dWa, dc and the taps, g before
    dWso; the bias gradients sum the unrounded dz and dso. In float32 (and
    float64) nothing is rounded."""
    mm = xs.dtype
    acc = torch.promote_types(torch.float32, mm)

    def rnd(t):  # to the matmul type and back
        return t.to(mm).to(acc)

    L, _, _, R = xs.shape
    G, SR = w["w_tap"].shape[-1], w["w_so"].shape[-1]
    A = c.shape[-1]
    half = math.sqrt(0.5)
    cm = c.to(acc).reshape(-1, A)
    dsk = dskip.to(acc)
    D = dx_out.to(acc)
    dc = torch.zeros(cm.shape, dtype=acc, device=xs.device)
    grads = {k: [None] * L for k in _WEIGHT_KEYS}
    for i in reversed(range(L)):
        d = dilations[i]
        x = xs[i].to(acc)
        xcat = torch.cat([_shift(x, d), x, _shift(x, -d)], dim=-1)
        xcat = xcat.reshape(-1, 3 * R)
        wcat = torch.cat([w["w_tap"][i].reshape(3 * R, G), w["w_aux"][i]],
                         dim=0).to(acc)
        z = xcat @ wcat[:3 * R] + cm @ wcat[3 * R:] + w["b_tap"][i].to(acc)
        ta, sig = torch.tanh(z[:, :R]), torch.sigmoid(z[:, R:])
        dso = torch.cat([dsk, D * half], dim=-1).reshape(-1, SR)
        dg = rnd(dso) @ w["w_so"][i].to(acc).T
        dz = torch.cat([dg * sig * (1 - ta * ta),
                        dg * ta * sig * (1 - sig)], dim=-1)
        dzm = rnd(dz)
        grads["w_tap"][i] = (xcat.T @ dzm).reshape(3, R, G)
        grads["w_aux"][i] = cm.T @ dzm
        grads["b_tap"][i] = dz.sum(0)
        grads["w_so"][i] = rnd(ta * sig).T @ rnd(dso)
        grads["b_so"][i] = dso.sum(0)
        back = dzm @ wcat.T  # [tap0 | tap1 | tap2 | dc]
        dc = dc + back[:, 3 * R:]
        taps = back[:, :3 * R].reshape(D.shape[:2] + (3 * R,))
        D = (D * half + _shift(taps[..., :R], -d) + taps[..., R:2 * R]
             + _shift(taps[..., 2 * R:], d))
    dw = {k: torch.stack(v).to(mm) for k, v in grads.items()}
    return D.to(mm), dc.reshape(c.shape).to(c.dtype), dw


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("wavenet_stack_bwd")
    fn = lib.pwg_wavenet_stack_backward
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 19
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 6
        + [ctypes.c_void_p]
    )
    lib.pwg_wavenet_stack_bwd_bf16_smem.restype = ctypes.c_size_t
    lib.pwg_wavenet_stack_bwd_bf16_smem.argtypes = [ctypes.c_int]
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
        inputs = {"xs": xs, "c": c, "w_tap": w["w_tap"], "b_tap": w["b_tap"],
                  "w_aux": w["w_aux"], "w_so": w["w_so"]}
        for name, t in inputs.items():
            if t.dtype != dt or t.device != xs.device:
                raise TypeError(f"{name} is {t.dtype} on {t.device}, xs is "
                                f"{dt} on {xs.device}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(
                    f"{name} must be contiguous and 16-byte aligned")
        dev = xs.device
        plan = backward_launch_plan(B, T, A, L, dt, _sm_count(dev.index))
        n_slabs, n_tiles = plan["weight_grid"]
        f32_body = plan["body"] == "tensor_cores_tf32x3"
        # D starts as the cotangent of x_out and carries dL/dx_l downwards
        D = dx_out.to(f32).contiguous().clone()
        dskip = dskip.to(f32).contiguous()
        taps = [torch.empty((B, T, 3 * R), dtype=f32, device=dev)
                for _ in range(2)]
        dc = torch.empty((B, T, A), dtype=f32, device=dev)
        dx = torch.empty((B, T, R), dtype=dt, device=dev)
        if f32_body:
            # layouts the f32 body reads its transposed products from
            w_so_t = w["w_so"].transpose(1, 2).contiguous()
            w_cat_t = torch.cat(
                [w["w_tap"].reshape(L, 3 * R, G), w["w_aux"]], dim=1
            ).transpose(1, 2).contiguous()
            dskip_in, dres, colsum = dskip, None, None
            dz = torch.empty((B, T, G), dtype=f32, device=dev)
            g = torch.empty((B, T, R), dtype=f32, device=dev)
        else:
            # the bf16 body reads the weights as the forward lays them out,
            # and dskip rounded once for every layer's products
            w_so_t = w_cat_t = None
            dskip_in = dskip.to(dt)
            dz = torch.empty((B, T, G), dtype=dt, device=dev)
            g = torch.empty((B, T, R), dtype=dt, device=dev)
            dres = torch.empty((B, T, R), dtype=dt, device=dev)
            colsum = torch.empty((L, plan["blocks"], G + R), dtype=f32,
                                 device=dev)
        partial = torch.empty((L, n_slabs, n_tiles, 65 if f32_body else 64,
                               128), dtype=f32, device=dev)

        def ptr(t):
            return None if t is None else t.data_ptr()

        dil = (ctypes.c_int * L)(*[int(d) for d in dilations])
        lib = _library()
        err = lib.pwg_wavenet_stack_backward(
            _DTYPE_CODES[dt], _BODY_CODES[plan["body"]], xs.data_ptr(),
            c.data_ptr(), w["w_tap"].data_ptr(), w["b_tap"].data_ptr(),
            w["w_aux"].data_ptr(), w["w_so"].data_ptr(), ptr(w_so_t),
            ptr(w_cat_t), dskip_in.data_ptr(), D.data_ptr(),
            taps[0].data_ptr(), taps[1].data_ptr(), dc.data_ptr(),
            dz.data_ptr(), g.data_ptr(), ptr(dres), ptr(colsum),
            partial.data_ptr(), dx.data_ptr(), dil, L, B, T, A, n_slabs,
            plan["blocks"], torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(
                "wavenet_stack backward kernel launch failed: "
                + lib.pwg_cuda_error_string(err).decode()
            )
        wavenet_stack_backward.launches += L
        p = partial.sum(dim=1)  # (L, n_tiles, 64 or 65, 128)
        if f32_body:  # row 64: the column sums
            b_tap, b_so = p[:, 0, 64], p[:, n_tiles - 1, 64]
        else:  # the data launch's column sums; dskip's, once for all layers
            sums = colsum.sum(dim=1)  # (L, G + R)
            b_tap = sums[:, :G]
            b_so = torch.cat([dskip.sum(dim=(0, 1)).expand(L, -1),
                              sums[:, G:]], dim=1)
    nc = n_tiles - 4
    dw = {
        "w_tap": p[:, 0:3, :64],
        "b_tap": b_tap,
        "w_aux": p[:, 3:3 + nc, :64].reshape(L, nc * 64, G)[:, :A],
        "w_so": p[:, n_tiles - 1, :64],
        "b_so": b_so,
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
