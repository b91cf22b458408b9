#!/usr/bin/env python3
"""What binds the layer bodies of ``csrc/wavenet_stack.cu``: ablations.

Builds variants of the kernel source (``csrc/wavenet_stack.cu`` and the
bf16 body it includes, ``csrc/wavenet_tc_layer.cuh``), each with one part
of a layer body taken out, and times each over the PWG v1 serving stack (30 layers,
dilations 2^(i mod 10), batch 32 x 512 frames x hop 256, seeded weights).
The bf16 tensor-core body (``--dtype bfloat16``, the default):

    base          the kernel as it is
    gate_product  tanh(a) sigmoid(b) replaced by a * b: no transcendentals
    no_loads      the ring loads only each block's first tile and then
                  reuses it: no activation traffic after the first tile
    no_load_bytes the ring's x copies are issued but zero-fill: their
                  instructions without their bytes
    no_epilogue   nothing written back: no skip, x or xs traffic
    no_skip_read  skip written but not read: a third of the epilogue's bytes

The f32 split-TF32 body (``--dtype float32``):

    base          the kernel as it is
    gate_product  tanh(a) sigmoid(b) replaced by a * b
    one_product   one TF32 product (hi . hi) a k-step instead of three:
                  what the split's two extra products and lo parts cost
    no_epilogue   nothing written back: no skip or x traffic
    in_place      each k-step's products added straight into the running
                  sums, where the tensor core truncates what it adds: the
                  same function, less accurately

Each variant's time below the base's is what that part costs (they
overlap, so the parts do not add up to the whole). Every variant is also
held against the float64 stack on a cut of the inputs (2 items x 20,000
samples): max |a - b| / (1 + max |b|) of x, for the variants that compute
the layer's function (base, in_place) its accuracy, for the others only a
sign of what was taken out.

    python -m parallelwavegan_torch.tools.wavenet_stack_ablation \
        [--dtype float32] [--reps 3]

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

# the sources a variant edits: the kernel and its bf16 layer body
SOURCES = ("wavenet_stack.cu", "wavenet_tc_layer.cuh")
# variant -> [(text in one of SOURCES, its replacement)]
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "base": [],
    "gate_product": [("        gv[e] = gate_value<GATE>(za, zb);",
                      "        gv[e] = za * zb;")],
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

_ONE_PRODUCT = """
template <int MT, int NT, typename ColFn>
__device__ __forceinline__ void mma_tiles_hi(float (*c)[NT][4],
                                             uint32_t (*a_hi)[4],
                                             uint32_t (*)[4], const float* b,
                                             int ldb, ColFn col, int gq,
                                             int tq) {
  uint32_t b_hi[NT][2], lo;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    pwgmma::split_tf32(b[col(j) + tq * ldb + gq], b_hi[j][0], lo);
    pwgmma::split_tf32(b[col(j) + (tq + 4) * ldb + gq], b_hi[j][1], lo);
  }
#pragma unroll
  for (int ij = 0; ij < MT * NT; ++ij) {
    float t[4] = {};
    pwgmma::mma_tf32(t, a_hi[ij / NT], b_hi[ij % NT]);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[ij / NT][ij % NT][e] += t[e];
  }
}

}  // namespace tf32"""
F32_VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "base": [],
    "gate_product": [(
        "          gv[e] = tanhf(za) * (1.f / (1.f + expf(-zb)));",
        "          gv[e] = za * zb;")],
    "one_product": [
        ("}  // namespace tf32", _ONE_PRODUCT),
        ("      mma_tiles<2, 4, true>(\n          acc,",
         "      mma_tiles_hi<2, 4>(\n          acc,"),
        ("      mma_tiles<2, 4, true>(acc,", "      mma_tiles_hi<2, 4>(acc,"),
    ],
    "no_epilogue": [(
        "        if (t >= T) continue;\n        const size_t row = row0 + t;",
        "        if (t >= 0) continue;\n        const size_t row = row0 + t;")],
    "in_place": [
        ("      mma_tiles<2, 4, true>(\n          acc,",
         "      mma_tiles<2, 4>(\n          acc,"),
        ("      mma_tiles<2, 4, true>(acc,", "      mma_tiles<2, 4>(acc,"),
    ],
}
BODY_VARIANTS = {torch.bfloat16: VARIANTS, torch.float32: F32_VARIANTS}


def variant_sources(name: str, dtype=torch.bfloat16) -> Dict[str, str]:
    """{file name: text} of SOURCES with variant ``name``'s edits, each
    applied to the one source that holds it."""
    texts = {f: (build.CSRC_DIR / f).read_text() for f in SOURCES}
    for old, new in BODY_VARIANTS[dtype][name]:
        holders = [f for f, t in texts.items() if old in t]
        if len(holders) != 1:
            raise RuntimeError(f"variant {name}: {len(holders)} sources "
                               f"hold {old!r}")
        texts[holders[0]] = texts[holders[0]].replace(old, new)
    return texts


def build_variants(names, dtype=torch.bfloat16) -> Dict[str, str]:
    """Write and compile every variant of the body that runs ``dtype`` in
    parallel; {name: library path}. Each variant's sources go to a
    directory of their own, so its edited layer body is the one its
    kernel includes."""
    out_dir = build.BUILD_DIR / "ablation"
    tag = str(dtype)[6:]
    procs = {}
    for name in names:
        src_dir = out_dir / f"{tag}_{name}"
        src_dir.mkdir(parents=True, exist_ok=True)
        for fname, text in variant_sources(name, dtype).items():
            (src_dir / fname).write_text(text)
        src = src_dir / SOURCES[0]
        lib = out_dir / f"libwavenet_stack_{tag}_{name}.so"
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


def serving_inputs(device, dtype=torch.bfloat16, B=32, T=131072, L=30, A=80,
                   seed=0):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device, dtype)

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
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default=None,
                    help="comma-separated (default: every variant of the "
                         "body)")
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    names = (args.variants.split(",") if args.variants
             else list(BODY_VARIANTS[dtype]))
    if not torch.cuda.is_available():
        raise SystemExit("wavenet_stack_ablation needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    libs = build_variants(names, dtype)
    x, c, w, dils = serving_inputs(torch.device("cuda", 0), dtype)
    x_cut, c_cut = x[:2, :20000].contiguous(), c[:2, :20000].contiguous()
    exact = ws.wavenet_stack_reference(
        x_cut.double(), c_cut.double(),
        {k: v.double() for k, v in w.items()}, dils)[0]
    kept = ws.load_library
    results = []
    try:
        for name, path in libs.items():
            ws.load_library = lambda _name, p=path: ctypes.CDLL(p)
            ws._library.cache_clear()
            ms = time_ms(lambda: ws.wavenet_stack(x, c, w, dils), args.reps)
            got = ws.wavenet_stack(x_cut, c_cut, w, dils)[0].double()
            err = ((got - exact).abs().max()
                   / (1 + exact.abs().max())).item()
            results.append({"variant": name, "dtype": args.dtype, "ms": ms,
                            "x_rel_err_vs_float64": err,
                            "layers": len(dils),
                            "batch": x.shape[0], "samples": x.shape[1],
                            "card": card})
            print(json.dumps(results[-1]))
    finally:
        ws.load_library = kept
        ws._library.cache_clear()
    return results


if __name__ == "__main__":
    main()
