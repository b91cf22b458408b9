#!/usr/bin/env python3
"""Time and profile the PWG v1 (G, adv, D) training step on the card.

    python -m parallelwavegan_torch.tools.train_step_profile [--reps 3]

Run from the root of a checkout (GPU and nvcc). Builds the step from
``chip_smoke.PWG_V1`` (the recipe's widths, its batch of 6 x 25,600
samples) with seeded weights and a seeded batch, in float32 and in mixed
precision, and prints one JSON line for each: the step's time (CUDA events,
mean of ``--reps`` steps after a warm-up), its device busy time and the
device time of its largest kernels (torch.profiler over two steps, per
step), and the stack backward kernel alone at that shape in the step's
matmul type (three groups of ten layers as the step calls it, seeded
weights and cotangents, CUDA events). Numbers of two trees compare only
within one run on one card; each line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _events_ms(fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time(step, n: int = 2, top: int = 12) -> dict:
    """torch.profiler over ``n`` calls of ``step``: per call, the host's
    wall ms under the profiler, the device's busy ms and the ``top``
    kernels by device ms (name cut to 90 characters, calls)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    rows = [(e.key, getattr(e, "device_time_total", 0.0) / 1e3 / n,
             e.count / n)
            for e in prof.key_averages()
            if "cuda" in str(getattr(e, "device_type", "")).lower()]
    rows.sort(key=lambda r: -r[1])
    return {"profiled_wall_ms": wall,
            "device_busy_ms": sum(ms for _, ms, _ in rows),
            "kernels": [{"name": k[:90], "ms": ms, "calls": c}
                        for k, ms, c in rows[:top]]}


def backward_ms(gen, batch, dtype, reps: int) -> float:
    """The stack backward kernel alone on the step's inputs: three groups
    of ten layers in ``dtype``, on one group's saved inputs."""
    from parallelwavegan_torch.ops.cuda import pwg_infer
    from parallelwavegan_torch.ops.cuda.wavenet_stack import wavenet_stack
    from parallelwavegan_torch.ops.cuda.wavenet_stack_train import (
        wavenet_stack_backward,
    )

    with torch.no_grad():
        w = pwg_infer.fuse_wavenet_stack_params(gen.conv_layers)
        c = gen.upsample_net(batch["c"]).contiguous().to(dtype)
        x0 = pwg_infer._conv1x1(gen.first_conv, batch["z"]).contiguous()
    L = len(gen.dilations)
    groups = [({k: v[g0:g0 + 10].to(dtype).contiguous()
                for k, v in w.items()}, tuple(gen.dilations[g0:g0 + 10]))
              for g0 in range(0, L, 10)]
    xs = wavenet_stack(x0.to(dtype), c, groups[0][0], groups[0][1],
                       save_inputs=True)[2]
    seeded = torch.Generator().manual_seed(3)
    ux = torch.randn(x0.shape, generator=seeded).to(x0.device)
    us = torch.randn(x0.shape, generator=seeded).to(x0.device)

    def run():
        for wg, dg in groups:
            wavenet_stack_backward(xs, c, wg, dg, ux, us)

    return _events_ms(run, reps)


def main(argv=None) -> int:
    import chip_smoke
    from parallelwavegan_torch.engine.build import (
        example_batch,
        init_train_state,
    )
    from parallelwavegan_torch.engine.criterion import build_criterion
    from parallelwavegan_torch.engine.step import build_steps

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_step_profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _card()
    for mixed in (False, True):
        config = dict(chip_smoke.PWG_V1, mixed_precision=mixed)
        state, gen, dis, opt_g, opt_d = init_train_state(config, seed=0,
                                                         device=dev)
        factory, _ = build_steps(config, gen, dis, build_criterion(config),
                                 opt_g, opt_d)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in example_batch(
            config, batch_size=chip_smoke.TRAIN_BATCH).items()}
        step = factory(True, True, True)
        out = {"precision": "mixed" if mixed else "f32",
               "batch": [chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SAMPLES],
               "step_ms": _events_ms(lambda: step(state, batch), args.reps)}
        out.update(device_time(lambda: step(state, batch)))
        out["backward_ms"] = backward_ms(
            gen, batch, torch.bfloat16 if mixed else torch.float32,
            args.reps)
        out["card"] = card
        print(json.dumps(out), flush=True)
        del state, gen, dis, opt_g, opt_d, factory, step, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
