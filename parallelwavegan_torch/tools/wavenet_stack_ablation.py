#!/usr/bin/env python3
"""What binds the bf16 layer body of ``csrc/wavenet_stack.cu``: ablations.

Builds variants of the kernel source, each with one part of the tensor-core
layer body taken out, and times each over the PWG v1 serving stack (30
layers, dilations 2^(i mod 10), batch 32 x 512 frames x hop 256, bf16,
seeded weights):

    base          the kernel as it is
    gate_product  tanh(a) sigmoid(b) replaced by a * b: no transcendentals
    no_loads      the ring loads only each block's first tile and then
                  reuses it: no activation traffic after the first tile
    no_load_bytes the ring's x copies are issued but zero-fill: their
                  instructions without their bytes
    no_epilogue   nothing written back: no skip, x or xs traffic
    no_skip_read  skip written but not read: a third of the epilogue's bytes

A variant computes the wrong function; only its time means something. Each
variant's time below the base's is what that part costs (they overlap, so
the parts do not add up to the whole).

    python -m parallelwavegan_torch.tools.wavenet_stack_ablation [--reps 3]

Needs a GPU and nvcc. Prints one JSON line per variant with the card's name
and power limit; the variants are built under ``_build/ablation/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from typing import Dict, List, Tuple

import torch

from parallelwavegan_torch.ops.cuda import build
from parallelwavegan_torch.ops.cuda import wavenet_stack as ws

# variant -> [(text in csrc/wavenet_stack.cu, its replacement)]
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "base": [],
    "gate_product": [("        gv[e] = gate(za, zb);", "        gv[e] = za * zb;")],
    "no_loads": [(
        "    fill(tile + gridDim.x, slot ^ 1);",
        "    if (tile == blockIdx.x) fill(tile + gridDim.x, slot ^ 1);\n"
        "    else pwgpipe::cp_async_commit();")],
    "no_load_bytes": [(
        "            st + q * XS + ch * 16,\n"
        "            ok ? reinterpret_cast<const unsigned char*>(x_in + (row0 + t) * R) +\n"
        "                     ch * 16\n"
        "               : reinterpret_cast<const unsigned char*>(x_in),\n"
        "            ok);",
        "            st + q * XS + ch * 16,\n"
        "            reinterpret_cast<const unsigned char*>(x_in), false);")],
    "no_epilogue": [(
        "        if (t >= T) continue;\n        const int ch = 8 * j + 2 * t4;",
        "        if (t >= 0) continue;\n        const int ch = 8 * j + 2 * t4;")],
    "no_skip_read": [("if (half == 0 && !first_layer && t < T)",
                      "if (half == 0 && !first_layer && t < 0)")],
}


def build_variants(names) -> Dict[str, str]:
    """Write and compile every variant in parallel; {name: library path}."""
    source = (build.CSRC_DIR / "wavenet_stack.cu").read_text()
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
        src = out_dir / f"wavenet_stack_{name}.cu"
        src.write_text(text)
        lib = out_dir / f"libwavenet_stack_{name}.so"
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


def serving_inputs(device, B=32, T=131072, L=30, A=80, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(
            device, torch.bfloat16)

    w = {"w_tap": rnd(L, 3, 64, 128, scale=0.1),
         "b_tap": rnd(L, 128, scale=0.1), "w_aux": rnd(L, A, 128, scale=0.1),
         "w_so": rnd(L, 64, 128, scale=0.1), "b_so": rnd(L, 128, scale=0.1)}
    dils = tuple(2 ** (i % 10) for i in range(L))
    return rnd(B, T, 64), rnd(B, T, A), w, dils


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
        raise SystemExit("wavenet_stack_ablation needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    libs = build_variants(args.variants.split(","))
    x, c, w, dils = serving_inputs(torch.device("cuda", 0))
    kept = ws.load_library
    results = []
    try:
        for name, path in libs.items():
            ws.load_library = lambda _name, p=path: ctypes.CDLL(p)
            ws._library.cache_clear()
            ms = time_ms(lambda: ws.wavenet_stack(x, c, w, dils), args.reps)
            results.append({"variant": name, "ms": ms, "layers": len(dils),
                            "batch": x.shape[0], "samples": x.shape[1],
                            "card": card})
            print(json.dumps(results[-1]))
    finally:
        ws.load_library = kept
        ws._library.cache_clear()
    return results


if __name__ == "__main__":
    main()
