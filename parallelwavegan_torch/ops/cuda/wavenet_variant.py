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
runs ``csrc/wavenet_variant.cu`` (one launch per layer; design and bound in
the note at the head of that file) for CUDA tensors and
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
    _shift,
    check_kernel_channels,
)
from parallelwavegan_torch.ops.spectral import _no_tf32

GATES = ("tanh", "mul")


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
            with _no_tf32():
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
        + [ctypes.c_void_p] * 5
    )
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
    version; CUDA tensors launch the kernel (one launch per layer, counted
    in ``variant_stack.launches``) or raise.
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
    G, S = p["w_tap"].shape[-1], p["w_so"].shape[-1] - R
    w_tap = p["w_tap"]
    if int8_taps:
        # four consecutive contraction rows a 32-bit word: (L, 3R/4, G, 4)
        w_tap = w_tap.reshape(L, 3 * R // 4, 4, G).transpose(2, 3).contiguous()
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
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "wavenet_variant kernel launch failed: "
            + lib.pwg_variant_cuda_error_string(err).decode()
        )
    variant_stack.launches += L
    return x_out, skip


variant_stack.launches = 0
