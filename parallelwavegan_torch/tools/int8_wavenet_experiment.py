#!/usr/bin/env python3
"""int8 and gate experiment for the fused Parallel WaveGAN serving kernel.

Counterpart of the JAX package's ``tools/int8_wavenet_experiment.py``. The
serving kernel (``ops/cuda/wavenet_stack.py``) is bound by operations at
batch 32, so precision looks like a lever; but if the tanh/sigmoid gate
dominates a layer, faster tap products buy little. On one dilation cycle
(10 layers, d = 1 .. 512) at the serving shape this measures:

  1. baseline      the serving kernel ``wavenet_stack`` as it is, bf16
  2. gate=mul      ``variant_stack`` with the gate replaced by a plain
                   product: wrong math on purpose, a timing bound on what
                   removing every transcendental could save (no SNR)
  3. variant bf16  ``variant_stack`` with the true gate: the variant kernel
                   reproduces the baseline's math
  4. int8 taps     tap weights pre-quantised per layer, the packed tap
                   window quantised in the kernel with a static scale taken
                   from the baseline's residual range, int32 sums, f32
                   rescale; the aux and skip|out products stay bf16

    python -m parallelwavegan_torch.tools.int8_wavenet_experiment \\
        [--batch 32] [--frames 512]

Needs a GPU. Prints one JSON line per measurement: device time in ms (CUDA
events), the layer body that ran (``body``: the serving kernel's or the
variant's, as ``stack_launch_plan`` and ``variant_launch_plan`` name
them), as ``vs_baseline`` the SNR in dB of the skip sum against the
float32 plain reference, and as ``over_baseline`` the time over the
baseline's, with the card's name and power limit. The bf16 variants run
the serving kernel's own tensor-core layer body, so ``over_baseline`` of
the bf16 tanh variant compares the two entry points on one body; int8 taps
run a SIMT body (``simt_int8_taps``). Weights and
inputs are drawn from ``numpy.random.default_rng(0)`` in the JAX tool's
order and scales. A variant that fails to launch fails the run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from parallelwavegan_torch.ops.cuda.wavenet_stack import (
    stack_launch_plan,
    wavenet_stack,
    wavenet_stack_reference,
)
from parallelwavegan_torch.ops.cuda.wavenet_variant import (
    quantize_taps,
    variant_launch_plan,
    variant_stack,
)
from parallelwavegan_torch.tools.int8_stage_roofline import time_ms

LAYERS, R, G, A, S = 10, 64, 128, 80, 64
HOP = 256
REPS = 10  # timed calls per measurement, after one warm-up


def make_inputs(batch: int, frames: int, layers: int = LAYERS
                ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
    """(weights, x, c) as float32 numpy arrays: the JAX tool's seed-0 draws
    in its order (w_tap, b_tap, w_aux, w_so, b_so, x, c) and scales. The
    tool rounds x and c to bfloat16."""
    rng = np.random.default_rng(0)
    T = frames * HOP
    f32 = np.float32
    w = {
        "w_tap": (rng.standard_normal((layers, 3, R, G)) * 0.08).astype(f32)
        .reshape(layers, 3 * R, G),
        "b_tap": (rng.standard_normal((layers, G)) * 0.01).astype(f32),
        "w_aux": (rng.standard_normal((layers, A, G)) * 0.08).astype(f32),
        "w_so": (rng.standard_normal((layers, R, S + R)) * 0.08).astype(f32),
        "b_so": (rng.standard_normal((layers, S + R)) * 0.01).astype(f32),
    }
    x = (rng.standard_normal((batch, T, R)) * 0.3).astype(f32)
    c = (rng.standard_normal((batch, T, A)) * 0.5).astype(f32)
    return w, x, c


def snr_db(skip: torch.Tensor, ref_skip: torch.Tensor) -> float:
    err = skip.float() - ref_skip
    return float(10 * torch.log10(
        (ref_skip ** 2).mean() / torch.clamp((err ** 2).mean(), min=1e-30)))


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


@torch.inference_mode()
def main(argv=None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=512,
                    help="mel frames per item (256 samples each)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int8_wavenet_experiment needs a CUDA device")
    dev = torch.device("cuda")
    device_line = card()
    dilations = tuple(2 ** i for i in range(LAYERS))
    bf16 = torch.bfloat16

    w_np, x_np, c_np = make_inputs(args.batch, args.frames)
    w = {k: torch.from_numpy(v).to(dev) for k, v in w_np.items()}
    x = torch.from_numpy(x_np).to(dev, bf16)
    c = torch.from_numpy(c_np).to(dev, bf16)
    del x_np, c_np

    # float32 plain reference of the serving stack for the SNR
    w_prod = dict(w, w_tap=w["w_tap"].reshape(LAYERS, 3, R, G))
    _, ref_skip = wavenet_stack_reference(x.float(), c.float(), w_prod,
                                          dilations)
    results: List[Dict[str, Any]] = []
    B, T = x.shape[:2]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def emit(name: str, ms: float, body: str, snr=None) -> None:
        results.append({
            "metric": name, "value": ms, "unit": "ms",
            "vs_baseline": None if snr is None else round(snr, 1),
            "over_baseline": ms / results[0]["value"] if results else 1.0,
            "body": body, "batch": args.batch, "frames": args.frames,
            "device": device_line,
        })
        print(json.dumps(results[-1]))

    def body(gate: str, int8_taps: bool) -> str:
        return variant_launch_plan(B, T, A, LAYERS, gate, int8_taps,
                                   sms)["body"]

    def measure(fn):
        out = fn()
        torch.cuda.synchronize()
        return time_ms(fn, reps=REPS, warmup=1), out

    # 1. baseline: the serving kernel (it takes every tensor in one type, so
    # the biases are rounded to bf16 here, which the variants keep in f32)
    w_base = {k: v.to(bf16).contiguous() for k, v in w_prod.items()}
    t_base, out = measure(lambda: wavenet_stack(x, c, w_base, dilations))
    emit("wavenet_bf16_baseline_ms", t_base,
         stack_launch_plan(B, T, A, LAYERS, bf16, sms)["body"],
         snr_db(out[1], ref_skip))
    # the static activation scale of step 3: the residual range seen here
    act_max = float(out[0].float().abs().max()) * 1.05

    s_dummy = torch.ones((LAYERS, 2), dtype=torch.float32, device=dev)

    # 2. gate=mul timing bound (wrong math on purpose; no SNR)
    t_mul, _ = measure(lambda: variant_stack(x, c, w, s_dummy, dilations,
                                             gate="mul"))
    emit("wavenet_no_transcendental_bound_ms", t_mul, body("mul", False))

    # the bf16 variant path reproduces the baseline's math
    t_var, out = measure(lambda: variant_stack(x, c, w, s_dummy, dilations,
                                               gate="tanh"))
    emit("wavenet_variant_bf16_ms", t_var, body("tanh", False),
         snr_db(out[1], ref_skip))

    # 3. int8 taps
    w_tap_q, s_tap = quantize_taps(w["w_tap"], act_max)
    w_i8 = dict(w, w_tap_q=w_tap_q)
    t_i8, out = measure(lambda: variant_stack(x, c, w_i8, s_tap, dilations,
                                              gate="tanh", int8_taps=True))
    emit("wavenet_int8_taps_ms", t_i8, body("tanh", True),
         snr_db(out[1], ref_skip))
    return results


if __name__ == "__main__":
    main()
