"""Row-tiled matrix product at the MRF contraction shapes: CUDA kernel and
plain version.

Counterpart of ``pallas_matmul_bench`` in the JAX package's
``tools/int8_stage_roofline.py``: (M, K) @ (K, N) with int8 inputs and an
int32 result, or bfloat16 inputs and a float32 result, at the tall, short
and narrow shapes of the convs inside ``mrf_stage``. It measures what a
hand-written tensor-core product delivers at those shapes
(``tools/int8_stage_roofline.py`` times it beside ``torch._int_mm`` and
``torch.matmul``); nothing on a serving path calls it. ``matmul_bench`` runs
``csrc/matmul_bench.cu`` (one launch; design and bound in the note at the
head of that file) for CUDA tensors and ``matmul_bench_reference`` for CPU
tensors.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from parallelwavegan_torch.ops.cuda.build import load_library

# the contraction shapes (M, K, N) of HiFi-GAN v1's narrow MRF stages
MRF_SHAPES = (
    (131072, 96, 32), (131072, 352, 32), (65536, 192, 64),
    (32768, 384, 128), (32768, 128, 128),
)
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use (sm_90)
_ROW_PAD = 16         # bytes added to each staged row (csrc/mma_common.cuh)
_MAX_STAGES = 4


def matmul_plan(M: int, K: int, N: int, dtype: torch.dtype) -> dict:
    """The kernel's tiling for one product, as ``csrc/matmul_bench.cu``'s
    ``make_plan`` lays it out: the n-tile (N rounded up to 8, 16, 32, 64 or
    128), the row tile (128 rows where N <= 32, else 64), the most ring
    stages (2 to 4) whose shared memory fits a block, and that many bytes.
    The epilogue reuses a warp's own staged A rows where they are at least
    as wide as a padded output row, else it takes a scratch tile.
    Raises NotImplementedError where not even two stages fit."""
    if M < 1 or K < 1 or N % 8 or not 8 <= N <= 128:
        raise NotImplementedError(
            f"the matmul_bench kernel needs N a multiple of 8 up to 128, "
            f"got M={M} K={K} N={N}")
    item = 1 if dtype == torch.int8 else 2
    step = 32 // item  # the mma depth: 32 bytes of k
    n_tile = next(n for n in (8, 16, 32, 64, 128) if N <= n)
    row_tile = 128 if n_tile <= 32 else 64
    stride = -(-K // step) * step * item + _ROW_PAD
    alias = stride >= (n_tile + 8) * 4
    scratch = 0 if alias else row_tile * (n_tile + 8) * 4
    for stages in range(_MAX_STAGES, 1, -1):
        smem = (n_tile + stages * row_tile) * stride + scratch
        if smem <= _SMEM_LIMIT:
            return {"n_tile": n_tile, "row_tile": row_tile, "stages": stages,
                    "stride": stride, "alias": alias, "smem": smem,
                    "tiles": -(-M // row_tile)}
    raise NotImplementedError(
        f"K={K} needs {(n_tile + 2 * row_tile) * stride + scratch} bytes of "
        f"shared memory a block")


def matmul_bench_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: int8 -> int32 (exact, through float64, whose
    53-bit mantissa holds every |sum| <= K * 128^2) or bf16 -> float32
    (exact products of the bf16 values, float32 accumulation)."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("matmul_bench")
    fn = lib.pwg_matmul_bench
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    occ = lib.pwg_matmul_bench_occupancy
    occ.restype = ctypes.c_int
    occ.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.pwg_matmul_cuda_error_string.restype = ctypes.c_char_p
    lib.pwg_matmul_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"matmul_bench {what} failed: "
                           + lib.pwg_matmul_cuda_error_string(err).decode())


@functools.lru_cache(maxsize=None)
def _launch_config(dtype: torch.dtype, M: int, K: int, N: int,
                   device: int) -> tuple:
    """(stages, blocks) of one launch: the plan's ring, and persistent
    blocks as many as fit the card at once (registers, threads and shared
    memory together, as the CUDA runtime reckons), at most one per row
    tile. Cached: the call path of a short product stays short."""
    plan = matmul_plan(M, K, N, dtype)
    lib = _library()
    occ = ctypes.c_int(0)
    with torch.cuda.device(device):
        _raise_on(lib, lib.pwg_matmul_bench_occupancy(
            int(dtype == torch.int8), K, N, plan["stages"],
            ctypes.byref(occ)), "occupancy query")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    if occ.value < 1:
        raise NotImplementedError(f"matmul_bench K={K} N={N} fits no SM")
    return plan["stages"], min(plan["tiles"], occ.value * sms)


def matmul_bench(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N): int8 x int8 -> int32 or bf16 x bf16 -> float32.

    N must be a multiple of 8, at most 128; M and K are free as far as two
    ring stages fit a block's shared memory (:func:`matmul_plan`). CPU
    tensors take the plain version; CUDA tensors launch the kernel (one
    launch of persistent blocks, counted in ``matmul_bench.launches``) or
    raise.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"unsupported dtypes {a.dtype}, {b.dtype}")
    if a.device.type == "cpu":
        return matmul_bench_reference(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"no matmul_bench for devices {a.device}, {b.device}")
    (M, K), N = a.shape, b.shape[1]
    is_int8 = a.dtype == torch.int8
    stages, blocks = _launch_config(a.dtype, M, K, N, a.device.index)
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    lib = _library()
    out = torch.empty((M, N), device=a.device,
                      dtype=torch.int32 if is_int8 else torch.float32)
    with contextlib.ExitStack() as stack:
        if a.device.index != torch.cuda.current_device():
            stack.enter_context(torch.cuda.device(a.device))
        err = lib.pwg_matmul_bench(
            int(is_int8), a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
            stages, blocks, torch.cuda.current_stream(a.device).cuda_stream,
        )
    _raise_on(lib, err, "kernel launch")
    matmul_bench.launches += 1
    return out


matmul_bench.launches = 0
