#!/usr/bin/env python3
"""Per-stage int8 vs bf16 measurements for the HiFi-GAN v1 serving path.

Counterpart of the JAX package's ``tools/int8_stage_roofline.py``. It times
one MRF stage in isolation (C = 256 / 128 / 64 / 32 at the sequence lengths
of 512 mel frames) in four modes: the bf16 conv chain (cuDNN), the int8
conv chain (``torch._int_mm``), and the fused ``mrf_stage`` kernel with
bf16 and with int8 packs. It also times the hand-written ``matmul_bench``
kernel at the stage kernel's contraction shapes beside ``torch._int_mm``
and ``torch.matmul``.

    python -m parallelwavegan_torch.tools.int8_stage_roofline \\
        [--stages 2,3] [--batch 32] [--modes bf16,int8,kernel_bf16,kernel_int8] \\
        [--matmuls]

Needs a GPU. Prints one JSON line per measurement, each with the device's
name; rates are set against the published dense peaks of an H100 SXM.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from parallelwavegan_torch.ops.conv import conv1d
from parallelwavegan_torch.ops.cuda.matmul_bench import (
    MRF_SHAPES,
    matmul_bench,
)
from parallelwavegan_torch.ops.cuda.mrf_stage import (
    build_stage_pack,
    mrf_stage,
)
from parallelwavegan_torch.ops.hifigan_infer import (
    _quant_w,
    _quant_x,
    int8_conv1d,
)

# HiFi-GAN v1 stages at 512 mel frames: stage -> (C, T per utterance)
STAGES = {0: (256, 4096), 1: (128, 32768), 2: (64, 65536), 3: (32, 131072)}
KERNELS = (3, 7, 11)
DILS = (1, 3, 5)
MODES = ("bf16", "int8", "kernel_bf16", "kernel_int8")
# published dense peaks of an H100 SXM at 700 W (NVIDIA data sheet)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12


def time_ms(fn: Callable[[], object], reps: int = 5, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms (CUDA events, after a warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def stage_weights(stage: int) -> Dict[Tuple[int, int, int], np.ndarray]:
    """Seeded weights (k, C, C) of one stage, keyed (branch, layer, conv)."""
    C, _ = STAGES[stage]
    rng = np.random.default_rng(stage)
    return {
        (bi, li, j): (rng.standard_normal((k, C, C))
                      * (0.3 / np.sqrt(k * C))).astype(np.float32)
        for bi, k in enumerate(KERNELS)
        for li in range(len(DILS))
        for j in range(2)
    }


def stage_flops(C: int, rows: int) -> float:
    return 2.0 * rows * 2 * len(DILS) * sum(KERNELS) * C * C


def stage_bound_ms(C: int, rows: int, mode: str) -> Tuple[float, str]:
    """Least time for one stage: its operations at the mode's peak rate vs
    one read and one write of (rows, C) in bf16 at the memory rate."""
    t_ops = stage_flops(C, rows) / PEAK_OPS["int8" if "int8" in mode
                                            else "bf16"]
    t_bytes = 2.0 * rows * C * 2 / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def tower_forward(x: torch.Tensor, weights, scales=None, slope: float = 0.1
                  ) -> torch.Tensor:
    """One MRF stage as the conv chain: bf16 convs (cuDNN), or, given
    per-conv activation ``scales``, the int8 chain of
    ``ops/hifigan_infer.py`` with pre-quantised weights."""
    def q_conv(xin, key, k, d):
        pad = (k - 1) // 2 * d
        if scales is None:
            return conv1d(xin, weights[key], None, padding=pad, dilation=d)
        wq, sw, sx = scales[key]
        y = int8_conv1d(_quant_x(xin, sx.to(xin.dtype)), wq, pad, d)
        return (y.float() * sw).to(xin.dtype)

    acc = 0.0
    for bi, k in enumerate(KERNELS):
        xb = x
        for li, d in enumerate(DILS):
            xt = q_conv(F.leaky_relu(xb, slope), (bi, li, 0), k, d)
            xt = q_conv(F.leaky_relu(xt, slope), (bi, li, 1), k, 1)
            xb = xt + xb
        acc = acc + xb
    return acc / len(KERNELS)


def stage_functions(stage: int, batch: int, device="cuda",
                    dtype=torch.bfloat16):
    """(x, {mode: fn}) for one stage at ``batch`` x T rows: every mode of
    :data:`MODES` as a function of no arguments on the same seeded input
    and weights. Activation scales for the int8 modes are the per-channel
    max of this input over 127, for every conv."""
    C, T = STAGES[stage]
    gen = torch.Generator().manual_seed(stage)
    x = torch.randn((batch, T, C), generator=gen).to(device, dtype)
    w_np = stage_weights(stage)
    w_dev = {key: torch.from_numpy(w).to(device, dtype)
             for key, w in w_np.items()}
    sx = (x.float().abs().amax(dim=(0, 1)) / 127.0 + 1e-8)
    q = {}
    for key, w in w_np.items():
        wq, sw = _quant_w(torch.from_numpy(w).to(device)
                          * sx.reshape(1, -1, 1))
        q[key] = (wq, sw, sx)
    zeros = np.zeros((C,), np.float32)
    branches = [[(w_np[(bi, li, j)], zeros) for li in range(len(DILS))
                 for j in range(2)] for bi in range(len(KERNELS))]
    sxs = [[sx.cpu().numpy()] * (2 * len(DILS))] * len(KERNELS)
    packs = {
        "kernel_bf16": build_stage_pack(branches, sxs, quant=False,
                                        dtype=dtype, device=device),
        "kernel_int8": build_stage_pack(branches, sxs, quant=True,
                                        device=device),
    }
    fns = {
        "bf16": lambda: tower_forward(x, w_dev),
        "int8": lambda: tower_forward(x, w_dev, q),
        "kernel_bf16": lambda: mrf_stage(x, packs["kernel_bf16"],
                                         kernels=KERNELS, dils=DILS,
                                         quant=False),
        "kernel_int8": lambda: mrf_stage(x, packs["kernel_int8"],
                                         kernels=KERNELS, dils=DILS,
                                         quant=True),
    }
    return x, fns


@torch.inference_mode()
def stage_bench(stage: int, batch: int, mode: str, reps: int = 3) -> float:
    """Time one stage in one mode; prints a JSON line, returns ms."""
    C, T = STAGES[stage]
    _, fns = stage_functions(stage, batch)
    ms = time_ms(fns[mode], reps=reps, warmup=1)
    bound, by = stage_bound_ms(C, batch * T, mode)
    print(json.dumps({
        "measure": f"stage{stage}_C{C}", "mode": mode, "batch": batch,
        "ms": ms, "tflops_per_s": stage_flops(C, batch * T) / ms / 1e9,
        "bound_ms": bound, "bound_by": by,
        "device": torch.cuda.get_device_name(0),
    }))
    return ms


def matmul_inputs(M: int, K: int, N: int, mode: str, device="cuda"):
    rng = np.random.default_rng(0)
    if mode == "int8":
        a = rng.integers(-127, 127, (M, K)).astype(np.int8)
        b = rng.integers(-127, 127, (K, N)).astype(np.int8)
        return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    return a.to(device, torch.bfloat16), b.to(device, torch.bfloat16)


def matmul_bound_ms(M: int, K: int, N: int, mode: str) -> Tuple[float, str]:
    """Least time for the product: 2 M K N operations at the mode's peak vs
    a, b read once and the 4-byte result written once."""
    item = 1 if mode == "int8" else 2
    t_ops = 2.0 * M * K * N / PEAK_OPS[mode]
    t_bytes = ((M * K + K * N) * item + M * N * 4) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def library_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The single PyTorch call that computes matmul_bench's function."""
    if a.dtype == torch.int8:
        return torch._int_mm(a, b)
    return torch.matmul(a, b).float()


@torch.inference_mode()
def matmul_bench_time(M: int, K: int, N: int, mode: str) -> float:
    a, b = matmul_inputs(M, K, N, mode)
    ms = time_ms(lambda: matmul_bench(a, b), reps=20)
    lib_ms = time_ms(lambda: library_matmul(a, b), reps=20)
    bound, by = matmul_bound_ms(M, K, N, mode)
    print(json.dumps({
        "measure": f"matmul_M{M}_K{K}_N{N}", "mode": mode, "us": ms * 1e3,
        "library_us": lib_ms * 1e3, "bound_us": bound * 1e3, "bound_by": by,
        "tflops_per_s": 2.0 * M * K * N / ms / 1e9,
        "device": torch.cuda.get_device_name(0),
    }))
    return ms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", default="0,1,2,3")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--matmuls", action="store_true",
                    help="also time the matmul_bench kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int8_stage_roofline needs a CUDA device")
    if args.matmuls:
        for mode in ("int8", "bf16"):
            for M, K, N in MRF_SHAPES:
                matmul_bench_time(M, K, N, mode)
    for s in [int(x) for x in args.stages.split(",") if x != ""]:
        for mode in args.modes.split(","):
            stage_bench(s, args.batch, mode)


if __name__ == "__main__":
    main()
