#!/usr/bin/env python3
"""What binds the fused-pair body of ``csrc/mrf_stage.cu``: ablations.

Builds variants of the kernel source, each with one part of the fused-pair
body taken out or swapped, and times each over the four MRF stages of
HiFi-GAN v1 at batch 32 x 512 frames (C 256/128/64/32, T 4,096 to 131,072;
kernel sizes 3/7/11, dilations 1/3/5; bf16 x, bf16 and int8 packs, seeded
weights):

    base               the kernel as it is
    no_weight_bytes    the ring's weight copies are issued but zero-fill:
                       their instructions without their L2 traffic
    no_residual_loads  the second conv's epilogue reads no residual
    no_window_loads    the window is staged without reading global memory
    no_products        no mma.sync: everything but the products

A variant computes the wrong function; only its time means something. Each variant's time below the base's is what that part
costs (they overlap, so the parts do not add up to the whole).

    python -m parallelwavegan_torch.tools.mrf_stage_ablation [--reps 3]

Needs a GPU and nvcc. Prints one JSON line per variant, stage and pack type
with the card's name and power limit; the variants are built under
``_build/ablation/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from typing import Dict, List, Tuple

import numpy as np
import torch

from parallelwavegan_torch.ops.cuda import build
from parallelwavegan_torch.ops.cuda import mrf_stage as ms

# variant -> [(text in csrc/mrf_stage.cu, its replacement)]
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "base": [],
    "no_weight_bytes": [("const bool ok = kk < kpad;",
                         "const bool ok = false;")],
    "no_residual_loads": [("res[mi][h] = r < tt && t0 + r < T",
                           "res[mi][h] = false")],
    "no_window_loads": [("if (i < n4 && t >= 0 && t < T)", "if (false)")],
    "no_products": [
        ("          mma_tile<MT>(acc[mi][2 * np], af[mi], bf);", ""),
        ("          mma_tile<MT>(acc[mi][2 * np + 1], af[mi], bf + 2);", "")],
}
# (C, T) of the four stages at batch 32 x 512 frames
STAGES = ((256, 4096), (128, 32768), (64, 65536), (32, 131072))
KERNELS, DILS = (3, 7, 11), (1, 3, 5)


def build_variants(names) -> Dict[str, str]:
    """Write and compile every variant in parallel; {name: library path}."""
    source = (build.CSRC_DIR / "mrf_stage.cu").read_text()
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source no longer "
                                   f"holds {old!r}")
            text = text.replace(old, new)
        src = out_dir / f"mrf_stage_{name}.cu"
        src.write_text(text)
        lib = out_dir / f"libmrf_stage_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
               "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = str(lib)
    return libs


def stage_inputs(C: int, T: int, device, B: int = 32, seed: int = 0):
    """Seeded bf16 x and the stage's weights and activation scales."""
    rng = np.random.default_rng(seed)
    weights = [[(rng.standard_normal((k, C, C)).astype(np.float32)
                 * (0.6 / np.sqrt(k * C)),
                 rng.standard_normal(C).astype(np.float32) * 0.05)
                for _ in range(2 * len(DILS))] for k in KERNELS]
    scales = [[np.abs(rng.standard_normal(C)).astype(np.float32) * 0.02
               + 0.01 for _ in range(2 * len(DILS))] for _ in KERNELS]
    x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(
        np.float32)).to(device, torch.bfloat16)
    packs = {mode: ms.build_stage_pack(weights, scales, quant=mode == "int8",
                                       dtype=torch.bfloat16, device=device)
             for mode in ("bf16", "int8")}
    return x, packs


def time_ms(fn, reps: int) -> float:
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


@torch.inference_mode()
def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mrf_stage_ablation needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    libs = build_variants(args.variants.split(","))
    device = torch.device("cuda", 0)
    kept = ms.load_library
    results = []
    try:
        for C, T in STAGES:
            x, packs = stage_inputs(C, T, device)
            for mode, pack in packs.items():
                for name, path in libs.items():
                    ms.load_library = lambda _name, p=path: ctypes.CDLL(p)
                    ms._library.cache_clear()
                    t = time_ms(lambda: ms.mrf_stage(
                        x, pack, kernels=KERNELS, dils=DILS,
                        quant=mode == "int8"), args.reps)
                    results.append({"variant": name, "C": C, "T": T,
                                    "packs": mode, "ms": t,
                                    "batch": x.shape[0], "card": card})
                    print(json.dumps(results[-1]), flush=True)
            del x, packs
    finally:
        ms.load_library = kept
        ms._library.cache_clear()
    return results


if __name__ == "__main__":
    main()
