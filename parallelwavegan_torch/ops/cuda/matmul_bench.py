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

import ctypes
import functools

import torch

from parallelwavegan_torch.ops.cuda.build import load_library

# the contraction shapes (M, K, N) of HiFi-GAN v1's narrow MRF stages
MRF_SHAPES = (
    (131072, 96, 32), (131072, 352, 32), (65536, 192, 64),
    (32768, 384, 128), (32768, 128, 128),
)
_SMEM_LIMIT = 232448
_ROW_TILE = 64


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
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.pwg_matmul_cuda_error_string.restype = ctypes.c_char_p
    lib.pwg_matmul_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def matmul_bench(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N): int8 x int8 -> int32 or bf16 x bf16 -> float32.

    N must be a multiple of 8, at most 128; M and K are free as far as the
    operands fit a block's shared memory. CPU tensors take the plain
    version; CUDA tensors launch the kernel (one launch, counted in
    ``matmul_bench.launches``) or raise.
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
    if M < 1 or K < 1 or N % 8 or not 8 <= N <= 128:
        raise NotImplementedError(
            f"the matmul_bench kernel needs N a multiple of 8 up to 128, "
            f"got M={M} K={K} N={N}")
    step = 32 if is_int8 else 16
    n_tile = next(n for n in (8, 16, 32, 64, 128) if N <= n)
    smem = (n_tile + _ROW_TILE) * (-(-K // step) * step * a.element_size()
                                   + 16)
    if smem > _SMEM_LIMIT:
        raise NotImplementedError(
            f"K={K} needs {smem} bytes of shared memory a block")
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    lib = _library()
    with torch.cuda.device(a.device):
        out = torch.empty((M, N), device=a.device,
                          dtype=torch.int32 if is_int8 else torch.float32)
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        blocks = min(-(-M // _ROW_TILE), 4 * sms)
        err = lib.pwg_matmul_bench(
            int(is_int8), a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
            blocks, torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "matmul_bench kernel launch failed: "
            + lib.pwg_matmul_cuda_error_string(err).decode()
        )
    matmul_bench.launches += 1
    return out


matmul_bench.launches = 0
