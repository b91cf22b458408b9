#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and builds every CUDA
   kernel of the serving path from csrc/ with nvcc;
2. holds each kernel against its plain PyTorch version on the card (f32 and
   bf16, small and Parallel WaveGAN v1 shapes, ragged T, dilations past T);
3. drives the main path at full PWG v1 width with seeded weights written to
   and read back from a .gckpt: InferenceModel on cuda, (a) batch 1 in f32
   against the unfused plain generator, (b) batch 32 x 512 frames in bf16,
   whose run must launch every kernel of the path;
4. times the forward, each kernel and its plain version with CUDA events,
   prints a JSON line of kernels, the card line, and as the last line
   {"ok": true, "device": {...}}.

Exits non-zero, printing no result, on any failure or without a GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published dense peaks of an H100 SXM at 700 W (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
HOP, SR, BENCH_BATCH, BENCH_FRAMES = 256, 22050, 32, 512
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # x (1 + max|plain|)

# Parallel WaveGAN v1 (egs/ljspeech/voc1/conf/parallel_wavegan.v1.yaml)
PWG_V1 = {
    "sampling_rate": SR,
    "hop_size": HOP,
    "generator_type": "ParallelWaveGANGenerator",
    "generator_params": {
        "in_channels": 1, "out_channels": 1, "kernel_size": 3, "layers": 30,
        "stacks": 3, "residual_channels": 64, "gate_channels": 128,
        "skip_channels": 64, "aux_channels": 80, "aux_context_window": 2,
        "dropout": 0.0, "use_weight_norm": True,
        "upsample_net": "ConvInUpsampleNetwork",
        "upsample_params": {"upsample_scales": [4, 4, 4, 4]},
    },
}


def time_ms(fn, reps: int, warmup: int = 1) -> float:
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


def max_err(a: torch.Tensor, b: torch.Tensor, dtype) -> tuple:
    """(max |a - b|, allowed) with allowed = tol * (1 + max |b|)."""
    a, b = a.float(), b.float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite values")
    return (a - b).abs().max().item(), TOL[dtype] * (1 + b.abs().max().item())


def stack_inputs(gen: torch.Generator, B, T, L, dtype, dev):
    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    w = {"w_tap": rnd(L, 3, 64, 128, scale=0.1), "b_tap": rnd(L, 128, scale=0.1),
         "w_aux": rnd(L, 80, 128, scale=0.1), "w_so": rnd(L, 64, 128, scale=0.1),
         "b_so": rnd(L, 128, scale=0.1)}
    return rnd(B, T, 64), rnd(B, T, 80), w


def stack_bound_ms(B, T, L, dtype) -> tuple:
    """Least time for the stack call: operations at the type's peak vs
    bytes (x, c in; x out; skip out f32; weights) at the memory rate."""
    R, G, S, A = 64, 128, 64, 80
    flops = 2 * (3 * R * G + A * G + R * (S + R)) * B * T * L
    item = torch.finfo(dtype).bits // 8
    weights = L * (3 * R * G + G + A * G + R * (S + R) + S + R) * item
    nbytes = B * T * ((2 * R + A) * item + S * 4) + weights
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from parallelwavegan_torch.engine.checkpoint import (
        save_generator_checkpoint,
    )
    from parallelwavegan_torch.models import ParallelWaveGANGenerator
    from parallelwavegan_torch.ops.cuda.build import build_libraries
    from parallelwavegan_torch.ops.cuda.pwg_infer import _conv1x1
    from parallelwavegan_torch.ops.cuda.wavenet_stack import (
        wavenet_stack,
        wavenet_stack_reference,
    )
    from parallelwavegan_torch.utils.model_loader import load_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    # 1. build
    t0 = time.perf_counter()
    built = build_libraries(["wavenet_stack"])
    print(f"build: {time.perf_counter() - t0:.1f} s wall")
    for name, info in built.items():
        print(f"  {name}: {info['seconds']:.1f} s -> {info['path']}")
        for line in str(info["log"]).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. kernel against plain on the card
    gen = torch.Generator().manual_seed(0)
    cases = [  # (dtype, B, T, dilations)
        (torch.float32, 2, 1000, (1, 2, 4, 1, 2, 4)),
        (torch.bfloat16, 2, 1000, (1, 2, 4, 1, 2, 4)),
        (torch.float32, 3, 300, tuple(2 ** (i % 10) for i in range(30))),
        (torch.bfloat16, 2, 4133, tuple(2 ** (i % 10) for i in range(30))),
        (torch.float32, 1, 77, (3,)),
        (torch.bfloat16, 1, 130, (512, 1)),
    ]
    for dtype, B, T, dils in cases:
        x, c, w = stack_inputs(gen, B, T, len(dils), dtype, dev)
        xo, sk = wavenet_stack(x, c, w, dils)
        torch.cuda.synchronize()
        xo_p, sk_p = wavenet_stack_reference(x, c, w, dils)
        for what, a, b in (("x", xo, xo_p), ("skip", sk, sk_p)):
            err, allowed = max_err(a, b, dtype)
            print(f"stack {str(dtype)[6:]} B={B} T={T} L={len(dils)} "
                  f"max_d={max(dils)} {what}: max_abs_err {err:.3e} "
                  f"(allowed {allowed:.3e})")
            if err > allowed:
                raise AssertionError(f"wavenet_stack disagrees on {what}")

    # 3. main path at full PWG v1 width, through a .gckpt the port writes
    model_gen = ParallelWaveGANGenerator(
        **PWG_V1["generator_params"], generator=torch.Generator().manual_seed(0)
    )
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "generator.gckpt")
        save_generator_checkpoint(ckpt, model_gen)
        model32 = load_model(ckpt, PWG_V1, dtype=torch.float32, device="cuda")
        model16 = load_model(ckpt, PWG_V1, dtype=torch.bfloat16,
                             device="cuda")
    if model32.stack_params is None or model16.stack_params is None:
        raise AssertionError("InferenceModel does not route to the kernel")

    # (a) batch 1, f32: fused serving path vs the unfused plain generator
    mel = rng.standard_normal((60, 80)).astype(np.float32)
    noise = lambda: torch.Generator(device=dev).manual_seed(7)  # noqa: E731
    wave = model32.synthesize_batch([mel], generator=noise(), bucket_size=1)[0]
    _, (c1, z1), _ = model32.prepare_batch([mel], generator=noise(),
                                           bucket_size=1)
    with torch.inference_mode():
        y_plain = model32.generator(z1, c1)[0].float().cpu()
    err, allowed = max_err(torch.from_numpy(wave), y_plain, torch.float32)
    print(f"main path (a) f32 batch 1 x 60 frames: max_abs_err {err:.3e} vs "
          f"plain generator (allowed {allowed:.3e})")
    if wave.shape != (60 * HOP, 1) or err > allowed:
        raise AssertionError("fused f32 forward disagrees with the plain one")

    # (b) bench shape, bf16: the counted run of the main path
    mels = [rng.standard_normal((BENCH_FRAMES, 80)).astype(np.float32)
            for _ in range(BENCH_BATCH)]
    torch.cuda.synchronize()
    wavenet_stack.launches = 0
    t0 = time.perf_counter()
    waves = model16.synthesize_batch(mels)
    wall = time.perf_counter() - t0
    launches = wavenet_stack.launches
    print(f"main path (b) bf16 {BENCH_BATCH} x {BENCH_FRAMES} frames: "
          f"synthesize_batch {wall * 1e3:.1f} ms wall (first call), "
          f"wavenet_stack launches {launches}")
    if launches != model16.generator.layers:
        raise AssertionError(f"expected {model16.generator.layers} launches")
    for w in waves:
        if w.shape != (BENCH_FRAMES * HOP, 1) or not np.isfinite(w).all():
            raise AssertionError("bad bf16 output")

    # 4. timing at the main path's shapes
    fn, (c, z), _ = model16.prepare_batch(mels)
    fwd_ms = time_ms(lambda: fn(c, z), reps=3)
    g16 = model16.generator
    with torch.inference_mode():
        c_up = g16.upsample_net(c).contiguous()
        x0 = _conv1x1(g16.first_conv, z).contiguous()
        w = model16.stack_params
        dils = g16.dilations
        xo, sk = wavenet_stack(x0, c_up, w, dils)
        xo_p, sk_p = wavenet_stack_reference(x0, c_up, w, dils)
        errs = [max_err(a, b, torch.bfloat16) for a, b in
                ((xo, xo_p), (sk, sk_p))]
        del xo, sk, xo_p, sk_p
        stack_ms = time_ms(lambda: wavenet_stack(x0, c_up, w, dils), reps=3)
        plain_ms = time_ms(lambda: wavenet_stack_reference(x0, c_up, w, dils),
                           reps=2)
    for what, (err, allowed) in zip(("x", "skip"), errs):
        print(f"stack at main-path shape bf16 {what}: max_abs_err {err:.3e} "
              f"(allowed {allowed:.3e})")
        if err > allowed:
            raise AssertionError(f"wavenet_stack disagrees on {what}")
    B, T = x0.shape[:2]
    bound_ms, bound_by = stack_bound_ms(B, T, len(dils), torch.bfloat16)
    audio_s = BENCH_BATCH * BENCH_FRAMES * HOP / SR
    print(f"forward bf16 {BENCH_BATCH} x {BENCH_FRAMES} frames: "
          f"{fwd_ms:.2f} ms, {audio_s / (fwd_ms / 1e3):.1f} audio-s/s; "
          f"wavenet_stack {stack_ms:.2f} ms (plain {plain_ms:.2f} ms, bound "
          f"{bound_ms:.2f} ms by {bound_by}) on {smi}")
    print(json.dumps({"kernels": [{
        "name": "wavenet_stack",
        "route": "cuda",
        "source": "parallelwavegan_torch/csrc/wavenet_stack.cu",
        "replaces": "parallelwavegan_tpu/ops/pallas/wavenet_stack.py:113",
        "launches": launches,
        "max_abs_err": max(e for e, _ in errs),
        "ms": stack_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes the stack
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
