"""Experiment variants of the fused WaveNet stack: CUDA kernel and plain
version.

Counterpart of ``variant_stack`` in the JAX package's
``tools/int8_wavenet_experiment.py``: the serving stack's layer math
(``wavenet_stack.py``) with two knobs. ``gate="mul"`` replaces the
tanh/sigmoid gate by a plain product (wrong math on purpose: a timing bound
on what removing every transcendental could save). ``int8_taps=True`` takes
the tap product in int8: the packed window [x(t-d) | x(t) | x(t+d)] is
quantised from the f32 state with one static scale, multiplied by
pre-quantised weights (:func:`quantize_taps`) with exact int32 sums, and
rescaled in f32; the aux and skip|out products stay bf16. ``variant_stack``
runs ``csrc/wavenet_variant.cu`` for CUDA tensors (one launch per layer on
the body :func:`variant_launch_plan` names: bf16 taps on the serving
stack's tensor-core layer body, ``csrc/wavenet_tc_layer.cuh``, int8 taps on
a SIMT body that reproduces this module's plain arithmetic; design and
bound in the notes at the head of those files) and
``variant_stack_reference`` for CPU tensors.

Math per layer, with the rounding points of the kernels:
    xcat = [x[t-d] | x | x[t+d]]                        # f32 state
    int8:  xq = clip(round(xcat * s_tap[l, 0]), -127, 127)   # half to even
           z  = f32(xq @ w_tap_q[l]) * s_tap[l, 1]
    else:  z  = bf16(xcat) @ w_tap[l]                   # f32 accumulation
    z   += c @ w_aux[l] + b_tap[l]
    tanh:  g = tanh(z[:, :R]) * (0.5 * (1 + tanh(z[:, R:])))
    mul:   g = z[:, :R] * z[:, R:]
    so   = bf16(g) @ w_so[l] + b_so[l]
    skip += so[:, :S];  x = (so[:, S:] + x) * sqrt(0.5)

sigmoid(u) = 0.5 (1 + tanh(u / 2)), and the 0.5 inside is folded into the
gate half of ``w_tap``, ``w_aux`` and ``b_tap`` (for int8 before the
quantisation) by the wrapper, as the JAX wrapper does; the fold is exact.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Sequence, Tuple

import torch

from parallelwavegan_torch.ops.cuda.build import load_library
from parallelwavegan_torch.ops.cuda.wavenet_stack import (
    _SMEM_LIMIT,
    _SMEM_PER_SM,
    _TILE_ROWS,
    KERNEL_CHANNELS,
    _shift,
    check_kernel_channels,
    tc_smem_bytes,
)
from parallelwavegan_torch.ops.spectral import _full_f32

GATES = ("tanh", "mul")
# layer bodies of csrc/wavenet_variant.cu, by tap type
BODIES = {False: "tensor_cores_bf16", True: "simt_int8_taps"}


def variant_smem_bytes(A: int, x_dtype: torch.dtype, int8_taps: bool) -> int:
    """Shared memory of one launch of the variant's layer body. bf16 taps:
    the serving stack's tensor-core body (:func:`tc_smem_bytes`). int8
    taps: the SIMT body's ``simt_smem_floats`` in ``csrc/wavenet_variant.cu``,
    f32 words of the quantised taps [3R / 4][64], c [A padded to 16][64], a
    weight chunk [16][G] and g [R][64], whatever x's type."""
    if not int8_taps:
        return tc_smem_bytes(A, x_dtype)
    R, G, T = (KERNEL_CHANNELS["residual"], KERNEL_CHANNELS["gate"],
               _TILE_ROWS)
    return 4 * T * (3 * R // 4 + -(-A // 16) * 16 + R) + 4 * 16 * G


def variant_launch_plan(B: int, T: int, A: int, L: int, gate: str,
                        int8_taps: bool, sms: int = 132) -> dict:
    """How one ``variant_stack`` call runs on the card: one launch per layer
    (``launches``, the exact count the wrapper adds to
    ``variant_stack.launches``) on the body ``body`` over ``blocks``
    blocks, each with ``smem`` bytes of shared memory (the largest of the
    layer's instantiations: the first layer reads bf16 x, the others the
    f32 residual), over ``tiles`` tiles of ``tile_rows`` rows. bf16 taps run
    ``tensor_cores_bf16``, the serving stack's tensor-core body (mma.sync
    m16n8k16), on persistent blocks, as many as fit ``sms`` SMs at once and
    at most one a tile, each holding the layer's weights and a ring of
    tiles. int8 taps run ``simt_int8_taps`` (dp4a taps, f32 FMAs in k order:
    the plain version's arithmetic), one block a tile. Either gate. Raises
    NotImplementedError where no body fits a block's shared memory."""
    _check_gate(gate)
    tiles = B * -(-T // _TILE_ROWS)
    body = BODIES[bool(int8_taps)]
    smem = max(variant_smem_bytes(A, torch.bfloat16, int8_taps),
               variant_smem_bytes(A, torch.float32, int8_taps)
               if L > 1 else 0)
    if smem > _SMEM_LIMIT:
        raise NotImplementedError(
            f"aux channels {A} need {smem} bytes of shared memory a block on "
            f"the {body} body, more than {_SMEM_LIMIT}")
    per_sm = max(1, _SMEM_PER_SM // (smem + 1024))
    blocks = tiles if int8_taps else min(tiles, per_sm * sms)
    return {"body": body, "gate": gate, "launches": L, "tiles": tiles,
            "blocks": blocks, "smem": smem, "tile_rows": _TILE_ROWS}


def int8_tap_layout(w_tap_q: torch.Tensor) -> torch.Tensor:
    """The int8 tap weights as the kernel takes them: (L, 3R, G) from
    :func:`quantize_taps` -> (L, 3R/4, G, 4), four consecutive contraction
    rows of one column a 32-bit word, the operand of one __dp4a."""
    L, K, G = w_tap_q.shape
    return w_tap_q.reshape(L, K // 4, 4, G).transpose(2, 3).contiguous()


def _gate_scale(R: int, G: int, device=None, dtype=torch.float32
                ) -> torch.Tensor:
    """1 on the tanh half, 0.5 on the gate half of the G gate columns."""
    return torch.cat([torch.ones(R, dtype=dtype, device=device),
                      torch.full((G - R,), 0.5, dtype=dtype, device=device)])


def quantize_taps(w_tap: torch.Tensor, act_max: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-quantise the tap weights for ``int8_taps``.

    w_tap (L, 3, R, G) or (L, 3R, G) float32, unfolded; ``act_max`` bounds
    |x| of the residual state over the whole run. The 0.5 of the gate half
    is folded in before the quantisation; one symmetric weight scale per
    layer, one static activation scale. Returns (w_tap_q (L, 3R, G) int8,
    s_tap (L, 2) float32 with s_tap[l] = (1 / act_scale,
    w_scale[l] * act_scale)). Computed in float64, as the JAX tool does.
    """
    L, G = w_tap.shape[0], w_tap.shape[-1]
    w = w_tap.detach().double().reshape(L, -1, G)
    R = w.shape[1] // 3
    w = w * _gate_scale(R, G, w.device, torch.float64)
    w_scale = w.abs().amax(dim=(1, 2)) / 127.0
    w_q = torch.clamp(torch.round(w / w_scale[:, None, None]), -127, 127)
    act_scale = float(act_max) / 127.0
    s_tap = torch.stack([torch.full_like(w_scale, 1.0 / act_scale),
                         w_scale * act_scale], dim=1)
    return w_q.to(torch.int8), s_tap.float()


def _prepared_weights(w: Dict[str, torch.Tensor], R: int, int8_taps: bool
                      ) -> Dict[str, torch.Tensor]:
    """The weights as both versions consume them: gate fold, (L, 3R, G)
    taps, bf16 matrices, f32 biases."""
    bf16, f32 = torch.bfloat16, torch.float32
    w_tap = w["w_tap_q" if int8_taps else "w_tap"]
    L, G = w_tap.shape[0], w_tap.shape[-1]
    scale = _gate_scale(R, G, w_tap.device)
    w_tap = w_tap.reshape(L, 3 * R, G)
    if not int8_taps:  # the int8 taps were folded before their quantisation
        w_tap = (w_tap.to(f32) * scale).to(bf16)
    return {
        "w_tap": w_tap.contiguous(),
        "b_tap": (w["b_tap"].to(f32) * scale).contiguous(),
        "w_aux": (w["w_aux"].to(f32) * scale).to(bf16).contiguous(),
        "w_so": w["w_so"].to(bf16).contiguous(),
        "b_so": w["b_so"].to(f32).contiguous(),
    }


def _check_gate(gate: str) -> None:
    if gate not in GATES:
        raise ValueError(f"gate must be one of {GATES}, got {gate!r}")


def variant_stack_reference(
    x: torch.Tensor, c: torch.Tensor, w: Dict[str, torch.Tensor],
    s_tap: torch.Tensor, dilations: Sequence[int], gate: str = "tanh",
    int8_taps: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: same inputs, same outputs, the
    rounding points of the module docstring. The int8 tap products are taken
    in float32 with TF32 off, where they are exact (every partial sum is an
    integer below 3R * 127^2 < 2^24)."""
    _check_gate(gate)
    f32, bf16 = torch.float32, torch.bfloat16
    R = x.shape[-1]
    p = _prepared_weights(w, R, int8_taps)
    S = p["w_so"].shape[-1] - R
    s_tap = s_tap.to(f32)
    h = x.to(f32)
    cf = c.to(f32)
    skip = None
    for i, d in enumerate(dilations):
        if int8_taps:
            xcat = torch.cat([_shift(h, d), h, _shift(h, -d)], dim=-1)
            xq = torch.clamp(torch.round(xcat * s_tap[i, 0]), -127, 127)
            with _full_f32():
                z = (xq @ p["w_tap"][i].to(f32)) * s_tap[i, 1]
        else:
            hm = h.to(bf16).to(f32)
            xcat = torch.cat([_shift(hm, d), hm, _shift(hm, -d)], dim=-1)
            z = xcat @ p["w_tap"][i].to(f32)
        z = z + cf @ p["w_aux"][i].to(f32)
        z = z + p["b_tap"][i]
        if gate == "tanh":
            t = torch.tanh(z)
            g = t[..., :R] * (0.5 * (1.0 + t[..., R:]))
        else:
            g = z[..., :R] * z[..., R:]
        so = g.to(bf16).to(f32) @ p["w_so"][i].to(f32) + p["b_so"][i]
        skip = so[..., :S] if skip is None else skip + so[..., :S]
        h = (so[..., S:] + h) * math.sqrt(0.5)
    return h.to(x.dtype), skip


def _check_cuda_args(x, c, p, s_tap, dilations, int8_taps):
    B, T, R = x.shape
    if c.dim() != 3 or c.shape[:2] != (B, T):
        raise ValueError(f"c {tuple(c.shape)} does not match x {tuple(x.shape)}")
    A = c.shape[-1]
    L = len(dilations)
    G, S = p["w_tap"].shape[-1], p["w_so"].shape[-1] - R
    check_kernel_channels(R, G, S)
    if x.dtype != torch.bfloat16 or c.dtype != torch.bfloat16:
        raise TypeError(
            f"the kernel takes bfloat16 x and c, got {x.dtype}, {c.dtype}")
    if A % 4 or not 1 <= B <= 65535 or T < 1 or L < 1:
        raise ValueError(f"unsupported shape B={B} T={T} A={A} L={L}")
    f32, bf16 = torch.float32, torch.bfloat16
    expected = {
        "w_tap": ((L, 3 * R, G), torch.int8 if int8_taps else bf16),
        "b_tap": ((L, G), f32), "w_aux": ((L, A, G), bf16),
        "w_so": ((L, R, S + R), bf16), "b_so": ((L, S + R), f32),
        "s_tap": ((L, 2), f32),
    }
    tensors = dict(p, s_tap=s_tap, x=x, c=c)
    for name, t in tensors.items():
        if name in expected:
            shape, dtype = expected[name]
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
            if t.dtype != dtype:
                raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("wavenet_variant")
    fn = lib.pwg_wavenet_variant_forward
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4
        + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.pwg_wavenet_variant_smem.restype = ctypes.c_size_t
    lib.pwg_wavenet_variant_smem.argtypes = [ctypes.c_int] * 3
    q = lib.pwg_wavenet_variant_quantize
    q.restype = ctypes.c_int
    q.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    lib.pwg_variant_cuda_error_string.restype = ctypes.c_char_p
    lib.pwg_variant_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def variant_stack(
    x: torch.Tensor, c: torch.Tensor, w: Dict[str, torch.Tensor],
    s_tap: torch.Tensor, dilations: Sequence[int], gate: str = "tanh",
    int8_taps: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run L layers of the experiment's WaveNet variant (forward only).

    x (B, T, R) and c (B, T, A) bfloat16; ``w`` holds the unfolded float32
    weights ``w_tap`` (L, 3, R, G) or (L, 3R, G) (with ``int8_taps``:
    ``w_tap_q`` int8 from :func:`quantize_taps`), ``b_tap`` (L, G),
    ``w_aux`` (L, A, G), ``w_so`` (L, R, S+R), ``b_so`` (L, S+R); ``s_tap``
    (L, 2) float32 (read only with ``int8_taps``). Returns (x_out (B, T, R)
    in x.dtype, skip sum (B, T, S) float32). CPU tensors take the plain
    version; CUDA tensors launch the kernel (one launch per layer on the
    body :func:`variant_launch_plan` names, counted in
    ``variant_stack.launches``) or raise.
    """
    _check_gate(gate)
    if x.device.type == "cpu":
        return variant_stack_reference(x, c, w, s_tap, dilations, gate,
                                       int8_taps)
    if x.device.type != "cuda":
        raise ValueError(f"no variant_stack for device {x.device}")
    B, T, R = x.shape
    L = len(dilations)
    p = _prepared_weights(w, R, int8_taps)
    s_tap = s_tap.to(torch.float32).contiguous()
    _check_cuda_args(x, c, p, s_tap, dilations, int8_taps)
    S = p["w_so"].shape[-1] - R
    w_tap = int8_tap_layout(p["w_tap"]) if int8_taps else p["w_tap"]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = variant_launch_plan(B, T, c.shape[-1], L, gate, int8_taps, sms)
    lib = _library()
    dil = (ctypes.c_int * L)(*[int(d) for d in dilations])
    with torch.cuda.device(x.device):
        # the f32 residual ping-pongs between two scratch buffers, freed on
        # return (the caching allocator orders that after the launches)
        x_out = torch.empty_like(x)
        skip = torch.empty((B, T, S), dtype=torch.float32, device=x.device)
        bufs = [
            torch.empty((B, T, R), dtype=torch.float32, device=x.device)
            if L >= n else None
            for n in (2, 3)
        ]
        err = lib.pwg_wavenet_variant_forward(
            int(gate == "mul"), int(int8_taps), x.data_ptr(), c.data_ptr(),
            w_tap.data_ptr(), p["b_tap"].data_ptr(), p["w_aux"].data_ptr(),
            p["w_so"].data_ptr(), p["b_so"].data_ptr(), s_tap.data_ptr(),
            dil, L, B, T, c.shape[-1], x_out.data_ptr(), skip.data_ptr(),
            None if bufs[0] is None else bufs[0].data_ptr(),
            None if bufs[1] is None else bufs[1].data_ptr(),
            plan["blocks"], torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(lib, err)
    variant_stack.launches += plan["launches"]
    return x_out, skip


variant_stack.launches = 0


def _raise_on(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            "wavenet_variant kernel launch failed: "
            + lib.pwg_variant_cuda_error_string(err).decode()
        )


def quantize_words_reference(x: torch.Tensor, s: float) -> torch.Tensor:
    """Plain version of the int8 body's quantiser: x (..., 4 n)
    float32 or bfloat16 -> (..., n) int32 words, each four
    clip(round_half_even(x * s), +-127) as bytes, the first the lowest, as
    the plain stack quantises its tap window (x * s in float32)."""
    scale = torch.tensor(s, dtype=torch.float32)
    q = torch.clamp(torch.round(x.float() * scale), -127, 127).to(torch.int8)
    return q.contiguous().view(torch.int32)


def quantize_words(x: torch.Tensor, s: float) -> torch.Tensor:
    """The int8 body's quantiser (``quant_word`` in
    ``csrc/wavenet_variant.cu``) over x: CPU tensors take
    :func:`quantize_words_reference`; CUDA tensors launch the quantiser
    kernel (counted in ``quantize_words.launches``) or raise."""
    if x.device.type == "cpu":
        return quantize_words_reference(x, s)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_words takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if (x.shape[-1] % 4 or not x.is_contiguous() or x.data_ptr() % 16
            or x.numel() == 0):
        raise ValueError("x must be contiguous, 16-byte aligned and hold "
                         "whole words of four values")
    lib = _library()
    with torch.cuda.device(x.device):
        out = torch.empty(x.shape[:-1] + (x.shape[-1] // 4,),
                          dtype=torch.int32, device=x.device)
        err = lib.pwg_wavenet_variant_quantize(
            int(x.dtype == torch.bfloat16), x.data_ptr(), out.numel(),
            float(s), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err)
    quantize_words.launches += 1
    return out


quantize_words.launches = 0
