"""Fused WaveNet dilated gated residual stack: CUDA kernel and plain version.

Counterpart of ``parallelwavegan_tpu/ops/pallas/wavenet_stack.py``. The
Parallel WaveGAN generator's hot loop is 30 gated residual layers over small
channel counts (R=64, G=128, S=64). ``wavenet_stack`` runs a group of them
through the hand-written kernel ``csrc/wavenet_stack.cu`` for CUDA tensors
(one launch per layer, on the body :func:`stack_launch_plan` names: bf16 on
tensor cores over persistent blocks, f32 on tensor cores in three TF32
products per product, one block per 64-row tile; the design and bound are
in the note at the head of that file), and through
``wavenet_stack_reference`` for CPU tensors.

Math per layer (WaveNetResidualBlock with k=3, non-causal):
    z    = [x[t-d] | x | x[t+d]] @ Wt + c @ Wa + bt        # (T, G)
    g    = tanh(z[:, :R]) * sigmoid(z[:, R:])              # (T, R)
    skip += g @ Ws + bs                                    # (T, S), f32
    x    = (g @ Wo + bo + x) * sqrt(0.5)                   # (T, R), f32

The residual state stays f32 across the layers of one call and is rounded to
``x.dtype`` once, at the end; matmul inputs are rounded to the weight dtype
and products accumulate in f32 (the TPU kernel's semantics, which for bf16
differ from the JAX per-layer reference, which rounds x every layer).

With ``save_inputs=True`` both versions also return xs (L, B, T, R): every
layer's input rounded to the weight dtype, exactly what its tap product
consumed. The backward kernel (``wavenet_stack_train.py``) recomputes the
gate from it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from parallelwavegan_torch.ops.cuda.build import load_library

# channel widths the CUDA kernel is compiled for (PWG v1)
KERNEL_CHANNELS = {"residual": 64, "gate": 128, "skip": 64}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# layer bodies of csrc/wavenet_stack.cu, as its C entry point numbers them
_BODY_CODES = {"tensor_cores": 0, "tensor_cores_tf32x3": 1}
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use (sm_90)
_SMEM_PER_SM = 233472
_TILE_ROWS = 64       # time rows of one tile (both layer bodies)
_TC_STAGES = 2        # ring of activation tiles (bf16 tensor-core body)
_TF32_STAGES, _TF32_CHUNK = 3, 32  # split-TF32 body: ring slots, chunk rows


def tc_smem_bytes(A: int, x_dtype: torch.dtype) -> int:
    """Shared memory of one launch of the bf16 tensor-core layer body, as
    ``tc_smem_bytes`` in ``csrc/wavenet_stack.cu`` lays it out: the layer's
    weights [3R + A padded to 16 + R][G] in bf16, both biases in f32, the
    gate of one tile in bf16, and a ring of two activation tiles, each three
    x windows (rows of 64 channels in x's type, padded) and one c window
    (bf16, padded)."""
    R, G = KERNEL_CHANNELS["residual"], KERNEL_CHANNELS["gate"]
    aux = -(-A // 16) * 16
    x_row = R * 4 + 32 if x_dtype == torch.float32 else R * 2 + 16
    stage = 3 * _TILE_ROWS * x_row + _TILE_ROWS * (aux * 2 + 16)
    return ((3 * R + aux + R) * G * 2 + 2 * G * 4 + _TILE_ROWS * R * 2
            + _TC_STAGES * stage)


def tf32_smem_bytes() -> int:
    """Shared memory of one launch of the f32 split-TF32 layer body, as
    namespace ``tf32`` in ``csrc/wavenet_stack.cu`` lays it out: a ring of
    three chunks, each 32 weight rows of 128 f32 columns (padded to 136)
    and the matching 32 activation columns of the tile's 64 rows (padded to
    36), then the tile's centre rows x(t) and its gate g, each [64][64] f32
    (padded to 68). Nothing grows with A: weights and c stream in
    chunks."""
    R, G, T = KERNEL_CHANNELS["residual"], KERNEL_CHANNELS["gate"], _TILE_ROWS
    stage = _TF32_CHUNK * (G + 8) + T * (_TF32_CHUNK + 4)
    return 4 * (_TF32_STAGES * stage + 2 * T * (R + 4))


def stack_launch_plan(B: int, T: int, A: int, L: int, dtype: torch.dtype,
                      sms: int = 132) -> dict:
    """How one ``wavenet_stack`` call runs on the card: one launch per
    layer (``launches``, the exact count the wrapper adds to
    ``wavenet_stack.launches``) over ``tiles`` tiles of ``tile_rows`` time
    rows, on the layer body ``body``, which the kernel's C entry point is
    told to run.

    float32 runs ``tensor_cores_tf32x3``: every product as three TF32
    mma.sync products (f32 accuracy), one block of ``smem`` bytes per
    64-row tile (128-row tiles were slower at both main-path shapes).
    bfloat16 runs ``tensor_cores`` on ``blocks`` persistent blocks (as many
    as fit ``sms`` SMs at once, at most one per tile), each holding the
    layer's weights and a ring of tiles in ``smem`` bytes of shared memory
    (the largest of the layer's instantiations: the first layer reads bf16
    x, the others the f32 residual). Raises NotImplementedError where a
    launch would exceed a block's shared memory."""
    tiles = B * -(-T // _TILE_ROWS)
    if dtype == torch.float32:
        body, smem, blocks = "tensor_cores_tf32x3", tf32_smem_bytes(), tiles
    else:
        body = "tensor_cores"
        smem = max(tc_smem_bytes(A, torch.bfloat16),
                   tc_smem_bytes(A, torch.float32) if L > 1 else 0)
        per_sm = max(1, _SMEM_PER_SM // (smem + 1024))
        blocks = min(tiles, per_sm * sms)
    if smem > _SMEM_LIMIT:
        raise NotImplementedError(
            f"aux channels {A} need {smem} bytes of shared memory a block on "
            f"the {body} body, more than {_SMEM_LIMIT}")
    return {"body": body, "launches": L, "tiles": tiles, "blocks": blocks,
            "smem": smem, "tile_rows": _TILE_ROWS}


def check_kernel_channels(residual: int, gate: int, skip: int) -> None:
    """Raise NotImplementedError unless the kernel is built for these widths."""
    if (residual, gate, skip) != tuple(KERNEL_CHANNELS.values()):
        raise NotImplementedError(
            "the CUDA kernel is built for residual/gate/skip channels "
            f"{tuple(KERNEL_CHANNELS.values())}, got "
            f"{(residual, gate, skip)}"
        )


def fuse_wavenet_stack_params(blocks: Sequence[torch.nn.Module]
                              ) -> Dict[str, torch.Tensor]:
    """Stack one layer group's kernels into the kernel's layout.

    ``blocks`` are WaveNetResidualBlocks (kernels (K, Cin, Cout), folded
    here when the block holds kernel_v/kernel_g, so the result is
    differentiable in them). Returns w_tap (L, 3, R, G), b_tap (L, G),
    w_aux (L, A, G), w_so (L, R, S+R) (skip|out 1x1s side by side) and
    b_so (L, S+R).
    """
    taps = [b.conv.folded_kernel() for b in blocks]
    if any(k.shape[0] != 3 for k in taps):
        raise ValueError("the fused stack requires kernel_size=3")
    return {
        "w_tap": torch.stack(taps),
        "b_tap": torch.stack([b.conv.bias for b in blocks]),
        "w_aux": torch.stack([b.conv1x1_aux.folded_kernel()[0]
                              for b in blocks]),
        "w_so": torch.stack([
            torch.cat([b.conv1x1_skip.folded_kernel()[0],
                       b.conv1x1_out.folded_kernel()[0]], -1)
            for b in blocks
        ]),
        "b_so": torch.stack([
            torch.cat([b.conv1x1_skip.bias, b.conv1x1_out.bias]) for b in blocks
        ]),
    }


def _shift(x: torch.Tensor, d: int) -> torch.Tensor:
    """s[t] = x[t - d] along axis 1, zero-filled (d < 0 shifts left)."""
    T = x.shape[1]
    if abs(d) >= T:
        return torch.zeros_like(x)
    if d > 0:
        return F.pad(x[:, : T - d], (0, 0, d, 0))
    return F.pad(x[:, -d:], (0, 0, 0, -d))


def wavenet_stack_reference(
    x: torch.Tensor, c: torch.Tensor, w: Dict[str, torch.Tensor],
    dilations: Sequence[int], save_inputs: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel: same inputs, same outputs.
    Differentiable in x, c and w (autograd). Sums are f32, as in the
    kernel; float64 inputs and weights run the same math in float64 (the
    yardstick of the kernel's accuracy)."""
    mm = w["w_tap"].dtype
    acc = torch.promote_types(torch.float32, mm)
    R = x.shape[-1]
    S = w["w_so"].shape[-1] - R
    h = x.to(acc)
    cm = c.to(mm).to(acc)
    skip = None
    xs = []
    for i, d in enumerate(dilations):
        xm = h.to(mm).to(acc)
        if save_inputs:
            xs.append(xm.to(mm))
        xcat = torch.cat([_shift(xm, d), xm, _shift(xm, -d)], dim=-1)
        z = xcat @ w["w_tap"][i].reshape(3 * R, -1).to(acc)
        z = z + cm @ w["w_aux"][i].to(acc)
        z = z + w["b_tap"][i].to(acc)
        g = torch.tanh(z[..., :R]) * torch.sigmoid(z[..., R:])
        so = g.to(mm).to(acc) @ w["w_so"][i].to(acc) + w["b_so"][i].to(acc)
        skip = so[..., :S] if skip is None else skip + so[..., :S]
        h = (so[..., S:] + h) * math.sqrt(0.5)
    if save_inputs:
        return h.to(x.dtype), skip, torch.stack(xs)
    return h.to(x.dtype), skip


def _check_cuda_args(x, c, w, dilations):
    B, T, R = x.shape
    if c.dim() != 3 or c.shape[:2] != (B, T):
        raise ValueError(f"c {tuple(c.shape)} does not match x {tuple(x.shape)}")
    A = c.shape[-1]
    L = len(dilations)
    G, S = w["w_tap"].shape[-1], w["w_so"].shape[-1] - R
    check_kernel_channels(R, G, S)
    shapes = {
        "w_tap": (L, 3, R, G), "b_tap": (L, G), "w_aux": (L, A, G),
        "w_so": (L, R, S + R), "b_so": (L, S + R),
    }
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if A % 4 or not 1 <= B <= 65535 or T < 1 or L < 1:
        raise ValueError(f"unsupported shape B={B} T={T} A={A} L={L}")
    for name, t in [("x", x), ("c", c)] + [(k, w[k]) for k in shapes]:
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} {tuple(t.shape)} != {shapes[name]}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("wavenet_stack")
    fn = lib.pwg_wavenet_stack_forward
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4
        + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.pwg_wavenet_stack_tc_smem.restype = ctypes.c_size_t
    lib.pwg_wavenet_stack_tc_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.pwg_wavenet_stack_tf32_smem.restype = ctypes.c_size_t
    lib.pwg_wavenet_stack_tf32_smem.argtypes = []
    lib.pwg_cuda_error_string.restype = ctypes.c_char_p
    lib.pwg_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def wavenet_stack(
    x: torch.Tensor, c: torch.Tensor, w: Dict[str, torch.Tensor],
    dilations: Sequence[int], save_inputs: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Run a fused group of WaveNet layers (forward only, no gradient:
    the differentiable entry is ``wavenet_stack_train``).

    x (B, T, R) residual input and c (B, T, A) upsampled conditioning, in
    the weights' dtype (float32 or bfloat16); ``w`` from
    :func:`fuse_wavenet_stack_params`. Returns (x_out (B, T, R) in x.dtype,
    skip sum (B, T, S) float32) and, with ``save_inputs``, xs (L, B, T, R)
    in x.dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernel (one launch per layer, counted in ``wavenet_stack.launches``) or
    raise.
    """
    if x.device.type == "cpu":
        return wavenet_stack_reference(x, c, w, dilations, save_inputs)
    if x.device.type != "cuda":
        raise ValueError(f"no wavenet_stack for device {x.device}")
    _check_cuda_args(x, c, w, dilations)
    B, T, R = x.shape
    L = len(dilations)
    S = w["w_so"].shape[-1] - R
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = stack_launch_plan(B, T, c.shape[-1], L, x.dtype, sms)
    lib = _library()
    dil = (ctypes.c_int * L)(*[int(d) for d in dilations])
    with torch.cuda.device(x.device):
        # the f32 residual ping-pongs between two scratch buffers; they are
        # freed on return, which the caching allocator orders after the
        # launches on this stream
        x_out = torch.empty_like(x)
        skip = torch.empty((B, T, S), dtype=torch.float32, device=x.device)
        bufs = [
            torch.empty((B, T, R), dtype=torch.float32, device=x.device)
            if L >= n else None
            for n in (2, 3)
        ]
        xs = (torch.empty((L, B, T, R), dtype=x.dtype, device=x.device)
              if save_inputs else None)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pwg_wavenet_stack_forward(
            _DTYPE_CODES[x.dtype], _BODY_CODES[plan["body"]], x.data_ptr(),
            c.data_ptr(), w["w_tap"].data_ptr(), w["b_tap"].data_ptr(),
            w["w_aux"].data_ptr(), w["w_so"].data_ptr(), w["b_so"].data_ptr(),
            dil, L, B, T, c.shape[-1], x_out.data_ptr(), skip.data_ptr(),
            None if bufs[0] is None else bufs[0].data_ptr(),
            None if bufs[1] is None else bufs[1].data_ptr(),
            None if xs is None else xs.data_ptr(),
            plan["blocks"], stream,
        )
    if err != 0:
        raise RuntimeError(
            "wavenet_stack kernel launch failed: "
            + lib.pwg_cuda_error_string(err).decode()
        )
    wavenet_stack.launches += plan["launches"]
    if save_inputs:
        return x_out, skip, xs
    return x_out, skip


wavenet_stack.launches = 0
