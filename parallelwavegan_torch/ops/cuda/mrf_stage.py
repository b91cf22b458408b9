"""Fused HiFi-GAN MRF stage: CUDA kernel, weight packs and plain version.

Counterpart of ``parallelwavegan_tpu/ops/pallas/mrf_stage.py``. One stage of
the generator's multi-receptive-field fusion, x (B, T, C) -> (B, T, C):

    per branch b (kernel size k_b), per layer (dilation d):
        xt = conv_{k_b, d}(leaky(xb));  xt = conv_{k_b, 1}(leaky(xt))
        xb = xb + xt                                  # xb starts as x
    out = mean over branches

``mrf_stage`` runs it through the hand-written kernel ``csrc/mrf_stage.cu``
(on the body :func:`mrf_stage_plan` picks: layers + 1 launches with the
conv pair fused on chip for bf16 and int8 packs at C 32 to 256, else
2 * layers + 1; the design and bound are in the note at the head of that
file) for CUDA tensors and through ``mrf_stage_reference`` for CPU
tensors. Each conv is one contraction of depth k_b * C over the tap-shifted
input, int8 x int8 -> int32 with the per-input-channel activation scales of
``ops/hifigan_infer.py`` folded into the weights (``quant=True``), or in the
pack's float type with float32 accumulation.

Numerics, the same in the kernel and the plain version: the residual stream
and every conv output are float32 whatever ``x.dtype`` is; the activation is
rounded to the matmul type (or quantised, q = clip(round_half_even(v *
(1 / sx)), +-127)) only as a conv's input; the int8 epilogue is
float32(acc) * sw + bias as two roundings; the branch sum is taken in
float32, divided by n_branches and rounded to ``x.dtype`` once. That is the JAX
``mrf_stage_reference``; the Pallas kernel differs from it in bfloat16 only
(it rounds the running mean after every branch).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from parallelwavegan_torch.ops.cuda.build import load_library

_MM_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_BRANCHES = 4
# dynamic shared memory a block may use on sm_90
_SMEM_LIMIT = 232448


def _numpy_to_torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def kernel_weight_layout(w: torch.Tensor) -> torch.Tensor:
    """(n_layers, 2, k*C, C) pack weights -> the CUDA kernel's layout
    (n_layers, 2, C, kpad): transposed so that the contraction index is
    contiguous, zero-padded from k*C to a multiple of 32."""
    K = w.shape[2]
    kpad = -(-K // 32) * 32
    wt = w.transpose(2, 3)
    if kpad != K:
        wt = F.pad(wt, (0, kpad - K))
    return wt.contiguous()


def build_stage_pack(
    weights: Sequence[Sequence[Tuple[np.ndarray, np.ndarray]]],
    scales: Sequence[Sequence[np.ndarray]],
    *,
    quant: bool = True,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Pack one stage's MRF weights.

    weights[b][li*2+ci] = (w (k, Cin, Cout), bias (Cout,)) as numpy arrays;
    scales[b][li*2+ci] = per-input-channel activation scale sx (Cin,)
    (ignored when ``quant`` is false).

    Returns, per branch b, ``w{b}`` (n_layers, 2, k_b*C, C) int8 or
    ``dtype`` and ``s{b}`` (n_layers, 2, 4, C) float32 rows [1/sx, sw, bias,
    0], equal to the JAX package's pack, and ``wt{b}``, the same weights in
    the CUDA kernel's layout (:func:`kernel_weight_layout`). Weight fold:
    w'[k, ci, co] = w[k, ci, co] * sx[ci], then per-output-channel int8
    quantisation, as ``qconv`` of ``ops/hifigan_infer.py`` does, so that
    conv(x_q, w_q) * sw == conv.
    """
    pack: Dict[str, torch.Tensor] = {}
    for b, branch in enumerate(weights):
        w_rows, s_rows = [], []
        for li in range(len(branch) // 2):
            w_ci, s_ci = [], []
            for ci in range(2):
                w, bias = branch[li * 2 + ci]
                k, Cin, Cout = w.shape
                if quant:
                    sx = np.asarray(scales[b][li * 2 + ci], np.float32)
                    sx = np.broadcast_to(sx, (Cin,)).astype(np.float32)
                    wf = np.asarray(w, np.float32) * sx[None, :, None]
                    sw = np.maximum(
                        np.abs(wf).max(axis=(0, 1)) / 127.0, 1e-12
                    )
                    wq = np.clip(np.round(wf / sw), -127, 127).astype(np.int8)
                    w_ci.append(wq.reshape(k * Cin, Cout))
                    s_ci.append(np.stack([
                        1.0 / sx,
                        sw.astype(np.float32),
                        np.asarray(bias, np.float32),
                        np.zeros((Cout,), np.float32),
                    ]))
                else:
                    w_ci.append(
                        np.asarray(w, np.float32).reshape(k * Cin, Cout)
                    )
                    s_ci.append(np.stack([
                        np.ones((Cin,), np.float32),
                        np.ones((Cout,), np.float32),
                        np.asarray(bias, np.float32),
                        np.zeros((Cout,), np.float32),
                    ]))
            w_rows.append(np.stack(w_ci))
            s_rows.append(np.stack(s_ci))
        w_t = _numpy_to_torch(np.stack(w_rows),
                              torch.int8 if quant else dtype)
        pack[f"w{b}"] = w_t.to(device)
        pack[f"wt{b}"] = kernel_weight_layout(w_t).to(device)
        pack[f"s{b}"] = _numpy_to_torch(np.stack(s_rows),
                                        torch.float32).to(device)
    return pack


def mrf_stage_reference(
    x: torch.Tensor,
    pack: Dict[str, torch.Tensor],
    *,
    kernels: Sequence[int] = (3, 7, 11),
    dils: Sequence[int] = (1, 3, 5),
    quant: bool = True,
    slope: float = 0.1,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same inputs, same output.

    Each conv is a sum over taps of (B, T, C) @ (C, C) products of the
    shifted input, so no (B, T, k*C) window is ever materialised. The int8
    products run in float64, where they are exact (|sum| <= k*C*127^2 <
    2^53) on every device, and are rounded to float32 as an int32 would be.
    """
    f32 = torch.float32
    T, C = x.shape[1], x.shape[2]
    acc = None
    for b, k in enumerate(kernels):
        half = (k - 1) // 2
        xb = x.to(f32)
        for li, d in enumerate(dils):
            xt = xb
            for ci, dd in enumerate((d, 1)):
                xt = F.leaky_relu(xt, slope)
                w = pack[f"w{b}"][li, ci].reshape(k, C, C)
                sc = pack[f"s{b}"][li, ci]
                if quant:
                    a = torch.clamp(torch.round(xt * sc[0]), -127.0, 127.0)
                    a, wm = a.double(), w.double()
                else:
                    a, wm = xt.to(w.dtype).to(f32), w.to(f32)
                a = F.pad(a, (0, 0, half * dd, half * dd))
                y = None
                for t in range(k):
                    part = a[:, t * dd: t * dd + T] @ wm[t]
                    y = part if y is None else y + part
                if quant:
                    xt = y.to(f32) * sc[1] + sc[2]
                else:
                    xt = y + sc[2]
            xb = xb + xt
        acc = xb if acc is None else acc + xb
    # a true division: by a tensor on acc's device, because a division of a
    # CUDA tensor by a host scalar is computed as a product with 1 / n
    n = torch.full((), float(len(kernels)), dtype=f32, device=acc.device)
    return (acc / n).to(x.dtype)


# the fused-pair body's instantiation for each width, C -> (warps along the
# rows WM and the columns WN, 16-row m-tiles per warp MI); a block computes
# all C columns, its tile has WM * 16 * MI rows, its block WM * WN warps
# (csrc/mrf_stage.cu, run_pair_c)
_FUSED_CONFIG = {32: (8, 1, 2), 64: (8, 1, 2), 128: (4, 2, 2), 256: (4, 2, 2)}
_FUSED_STAGES = 3       # weight ring slots
_CHUNK_BYTES = 128      # weight bytes per output row and ring chunk
_ROW_PAD = 16           # per-row padding of shared-memory tiles
_PER_CONV_ROWS = 128    # the per-conv body's time tile


def _item(mm_dtype: torch.dtype) -> int:
    return torch.empty((), dtype=mm_dtype).element_size()


def fused_smem_bytes(C: int, kernels: Sequence[int], d: int,
                     mm_dtype: torch.dtype) -> int:
    """Shared memory of one fused-pair launch with dilation d: the window
    (rows + (kmax - 1) d rows; y1 goes over it) and the weight ring."""
    wm, _, mi = _FUSED_CONFIG[C]
    rows = wm * 16 * mi
    win = (rows + (max(kernels) - 1) * d) * (C * _item(mm_dtype) + _ROW_PAD)
    return win + _FUSED_STAGES * C * (_CHUNK_BYTES + _ROW_PAD)


def _per_conv_smem_bytes(C: int, kernels: Sequence[int], dils: Sequence[int],
                         mm_dtype: torch.dtype) -> int:
    # a weight chunk of min(C, 64) rows of 128 + 16 bytes and a window of
    # 128 + (k - 1) d rows of C elements + 16
    return min(C, 64) * (_CHUNK_BYTES + _ROW_PAD) + (
        _PER_CONV_ROWS + (max(kernels) - 1) * max(dils)) * (
        C * _item(mm_dtype) + _ROW_PAD)


def _generic_reason(C, kernels, dils, mm_dtype) -> Optional[str]:
    if C < 8 or C > 256 or C & (C - 1):
        return f"channels {C} (a power of two from 8 to 256 is needed)"
    if not 1 <= len(kernels) <= MAX_BRANCHES:
        return f"{len(kernels)} branches (1 to {MAX_BRANCHES} are supported)"
    if any(k < 1 or k % 2 != 1 for k in kernels):
        return f"kernel sizes {tuple(kernels)} (odd sizes are needed)"
    if len(dils) < 1 or any(d < 1 for d in dils):
        return f"dilations {tuple(dils)}"
    if mm_dtype not in _MM_CODES:
        return f"weights of type {mm_dtype}"
    return None


def _fused_fits(C, kernels, dils, mm_dtype) -> bool:
    if mm_dtype not in (torch.bfloat16, torch.int8) or C not in _FUSED_CONFIG:
        return False
    wm, _, mi = _FUSED_CONFIG[C]
    return (wm * 16 * mi - (max(kernels) - 1) >= 16
            and fused_smem_bytes(C, kernels, max(dils), mm_dtype)
            <= _SMEM_LIMIT)


def unsupported_shape(C: int, kernels: Sequence[int], dils: Sequence[int],
                      mm_dtype: torch.dtype) -> Optional[str]:
    """Why neither body of the CUDA kernel can run this stage (None if one
    can)."""
    bad = _generic_reason(C, kernels, dils, mm_dtype)
    if bad or _fused_fits(C, kernels, dils, mm_dtype):
        return bad
    smem = _per_conv_smem_bytes(C, kernels, dils, mm_dtype)
    if smem > _SMEM_LIMIT:
        return (f"a window of {smem} bytes of shared memory (C={C}, "
                f"k={max(kernels)}, d={max(dils)}, {mm_dtype})")
    return None


def mrf_stage_plan(B: int, T: int, C: int, kernels: Sequence[int],
                   dils: Sequence[int], mm_dtype: torch.dtype
                   ) -> Dict[str, object]:
    """How ``mrf_stage`` runs a stage on the card, from the shape and types
    alone: {"body", "launches", "tile", "blocks", "threads", "smem"}, and
    for the fused body "ring_stages".

    "fused_pair" (bf16 and int8 weights, C 32 to 256, where the window, y1
    and the weight ring fit a block): one launch per layer and the mean.
    "per_conv" (float32 weights, C 8 and 16, or what the fused body cannot
    hold): one launch per conv and the mean. "tile" is the time rows a
    block computes ("out_rows" per branch for the fused body, whose conv
    pair spends k - 1 of them on the halo), "blocks" the grid of one conv
    launch, "smem" its largest dynamic shared memory. Raises
    NotImplementedError for what neither body takes."""
    bad = unsupported_shape(C, kernels, dils, mm_dtype)
    if bad:
        raise NotImplementedError(
            f"the mrf_stage kernel does not support {bad}")
    n_b, n_l = len(kernels), len(dils)
    if _fused_fits(C, kernels, dils, mm_dtype):
        wm, wn, mi = _FUSED_CONFIG[C]
        rows = wm * 16 * mi
        out_rows = [rows - (k - 1) for k in kernels]
        return {
            "body": "fused_pair", "launches": n_l + 1,
            "tile": {"rows": rows, "out_rows": out_rows, "columns": C,
                     "warps": (wm, wn), "m_tiles_per_warp": mi},
            "blocks": B * sum(-(-T // tt) for tt in out_rows),
            "threads": wm * wn * 32, "ring_stages": _FUSED_STAGES,
            "smem": fused_smem_bytes(C, kernels, max(dils), mm_dtype),
        }
    nt = min(C, 64)
    return {
        "body": "per_conv", "launches": 2 * n_l + 1,
        "tile": {"rows": _PER_CONV_ROWS, "columns": nt},
        "blocks": -(-T // _PER_CONV_ROWS) * B * n_b * (C // nt),
        "threads": 128,
        "smem": _per_conv_smem_bytes(C, kernels, dils, mm_dtype),
    }


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("mrf_stage")
    fn = lib.pwg_mrf_stage_forward
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        + [ctypes.POINTER(ctypes.c_void_p)] * 2
        + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_int] * 5
        + [ctypes.c_float] + [ctypes.c_void_p] * 3
    )
    lib.pwg_mrf_cuda_error_string.restype = ctypes.c_char_p
    lib.pwg_mrf_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def mrf_stage(
    x: torch.Tensor,
    pack: Dict[str, torch.Tensor],
    *,
    kernels: Sequence[int] = (3, 7, 11),
    dils: Sequence[int] = (1, 3, 5),
    chunk: Optional[int] = None,
    quant: bool = True,
    slope: float = 0.1,
) -> torch.Tensor:
    """Run one fused MRF stage over x (B, T, C) -> (B, T, C).

    ``pack`` comes from :func:`build_stage_pack` (on x's device); x is
    float32 or bfloat16. ``chunk`` is the JAX kernel's time-chunk size (a
    memory budget of that kernel) and is accepted and ignored. CPU tensors
    take the plain version; CUDA tensors launch the kernel on the body
    that :func:`mrf_stage_plan` chooses (its "launches", counted in
    ``mrf_stage.launches``) or raise: a shape the kernel lacks is never
    rerouted.
    """
    del chunk
    if x.device.type == "cpu":
        return mrf_stage_reference(x, pack, kernels=kernels, dils=dils,
                                   quant=quant, slope=slope)
    if x.device.type != "cuda":
        raise ValueError(f"no mrf_stage for device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    B, T, C = x.shape
    n_b, n_l = len(kernels), len(dils)
    mm_dtype = pack["w0"].dtype
    plan = mrf_stage_plan(B, T, C, kernels, dils, mm_dtype)
    if (mm_dtype == torch.int8) != bool(quant):
        raise TypeError(f"quant={quant} with weights of type {mm_dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {x.dtype}")
    if not 1 <= B <= 65535 or T < 1:
        raise ValueError(f"unsupported shape B={B} T={T}")
    wts, scs = [], []
    for b, k in enumerate(kernels):
        w, sc = pack[f"w{b}"], pack[f"s{b}"]
        kpad = -(-k * C // 32) * 32
        if tuple(w.shape) != (n_l, 2, k * C, C):
            raise ValueError(f"w{b} {tuple(w.shape)} != {(n_l, 2, k * C, C)}")
        if tuple(sc.shape) != (n_l, 2, 4, C) or sc.dtype != torch.float32:
            raise ValueError(f"s{b} must be float32 {(n_l, 2, 4, C)}")
        wt = pack.get(f"wt{b}")
        if wt is None:
            wt = kernel_weight_layout(w)
        if tuple(wt.shape) != (n_l, 2, C, kpad) or wt.dtype != mm_dtype:
            raise ValueError(f"wt{b} must be {mm_dtype} {(n_l, 2, C, kpad)}")
        wts.append(wt)
        scs.append(sc)
    for name, t in [("x", x)] + [(f"wt{b}", t) for b, t in enumerate(wts)] \
            + [(f"s{b}", t) for b, t in enumerate(scs)]:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    lib = _library()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        # f32 scratch, one plane per branch: the residual and y1 (per-conv
        # body) or the residual's ping-pong pair (fused body); freed on
        # return, which the caching allocator orders after the launches on
        # this stream
        xb = torch.empty((n_b, B, T, C), dtype=torch.float32, device=x.device)
        y1 = torch.empty_like(xb)
        err = lib.pwg_mrf_stage_forward(
            int(plan["body"] == "fused_pair"),
            int(x.dtype == torch.bfloat16), _MM_CODES[mm_dtype],
            x.data_ptr(), out.data_ptr(),
            (ctypes.c_void_p * n_b)(*[t.data_ptr() for t in wts]),
            (ctypes.c_void_p * n_b)(*[t.data_ptr() for t in scs]),
            (ctypes.c_int * n_b)(*[int(k) for k in kernels]),
            (ctypes.c_int * n_l)(*[int(d) for d in dils]),
            n_b, n_l, B, T, C, float(slope), xb.data_ptr(), y1.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "mrf_stage kernel launch failed: "
            + lib.pwg_mrf_cuda_error_string(err).decode()
        )
    mrf_stage.launches += plan["launches"]
    return out


mrf_stage.launches = 0
