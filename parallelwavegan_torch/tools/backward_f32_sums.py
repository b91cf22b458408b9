#!/usr/bin/env python3
"""What the f32 stack backward's tensor-core sums cost and buy.

The f32 body of ``csrc/wavenet_stack_bwd.cu`` takes every product as three
TF32 products on the tensor cores, which truncate what they add into their
accumulator. This tool builds variants of that source, each summing
otherwise, holds every output of each against the float64 plain backward
(through ``wavenet_stack_train``, forward kernel included) next to the plain
f32 version, and times the backward at the PWG v1 training shape:

    base            the kernel as it is: each k-step's three products summed
                    in a zeroed tile and added in f32 (mma_tiles with
                    FRESH), the bias column sums taken per 32-row chunk
    in_place        every product added straight into the running sums and
                    the bias columns summed in one running sum
    chunk_partials  one zeroed tile per 32-row ring chunk (four k-steps)
                    instead of one per k-step

    python -m parallelwavegan_torch.tools.backward_f32_sums [--reps 5]

Needs a GPU and nvcc. Prints one JSON line per variant and case with each
output's max |a - e| / (1 + max |e|) over the plain f32 version's
(``chip_smoke.py`` holds the base to at most 2), then one line per timed
run of the 30-layer backward at batch 6 x 25,600 (three calls of ten
layers, seeded weights; the variants in turns, each twice), with the
card's name and power limit. The variants are built under
``_build/f32_sums/``.
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
from parallelwavegan_torch.ops.cuda import wavenet_stack_train as wst
from parallelwavegan_torch.ops.cuda.wavenet_stack import wavenet_stack
from parallelwavegan_torch.tools.float64_check import rel_err

SOURCE = "wavenet_stack_bwd.cu"

_ADD_PART = """
// c += p over MT x NT accumulator tiles, in f32
template <int MT, int NT>
__device__ __forceinline__ void add_part(float (*c)[NT][4],
                                         float (*p)[NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][j][e] += p[i][j][e];
}
"""

# the four product loops of the f32 body: (text up to the accumulator,
# the accumulator, text after it, the tile shape) as the source has them
_GATE = ("""      const float* st = next_chunk();
#pragma unroll
      for (int kk = 0; kk < KCH; kk += 8) {
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          load_a_split(a_hi[i], a_lo[i],
                       st + KCH * WB_LD + (32 * wm + 16 * i) * ACT_LD + kk,
                       ACT_LD, gq, tq);
        mma_tiles<2, 4, true>(
            acc, a_hi, a_lo, st + kk * WB_LD + 16 * wq, WB_LD,
            [](int j) { return (j >> 1) * R + 8 * (j & 1); }, gq, tq);
      }""", "acc", "2, 4")
_DG = ("""      const float* st = next_chunk();
#pragma unroll
      for (int kk = 0; kk < KCH; kk += 8) {
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          load_a_split(a_hi[i], a_lo[i],
                       row_s + (32 * wm + 16 * i) * ROW_LD + q * KCH + kk,
                       ROW_LD, gq, tq);
        mma_tiles<2, 2, true>(dg, a_hi, a_lo, st + kk * WS_LD + 16 * wq,
                              WS_LD, [](int j) { return 8 * j; }, gq, tq);
      }""", "dg", "2, 2")
_TAPS = ("""      const float* st = next_chunk();
#pragma unroll
      for (int kk = 0; kk < KCH; kk += 8) {
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          load_a_split(a_hi[i], a_lo[i],
                       row_s + (32 * wm + 16 * i) * ROW_LD + q * KCH + kk,
                       ROW_LD, gq, tq);
        mma_tiles<2, 4, true>(acc, a_hi, a_lo, st + kk * WB_LD + 32 * wq,
                              WB_LD, [](int j) { return 8 * j; }, gq, tq,
                              n_valid);
      }""", "acc", "2, 4")
_WEIGHT = ("""#pragma unroll
    for (int kk = 0; kk < KR; kk += 8) {
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        load_at_split(a_hi[i], a_lo[i], lhs + kk * LHS_LD + 32 * wm + 16 * i,
                      LHS_LD, gq, tq);
      mma_tiles<2, 4, true>(acc, a_hi, a_lo, rhs + kk * RHS_LD + 32 * wn,
                            RHS_LD, [](int j) { return 8 * j; }, gq, tq);
    }""", "acc", "2, 4")
_LOOPS = (_GATE, _DG, _TAPS, _WEIGHT)


def _in_place(loop: Tuple[str, str, str]) -> Tuple[str, str]:
    text, _, shape = loop
    return text, text.replace(f"mma_tiles<{shape}, true>(",
                              f"mma_tiles<{shape}>(")


def _chunk_partials(loop: Tuple[str, str, str]) -> Tuple[str, str]:
    """A zeroed partial before the loop over a chunk's k-steps, summed in
    place within it and added to the accumulator after it."""
    text, acc, shape = loop
    head, sep, tail = text.partition("#pragma unroll\n")
    indent = tail[:len(tail) - len(tail.lstrip())]
    new = (head + f"{indent}float part[{shape.replace(', ', '][')}][4] = {{}};\n"
           + sep + tail.replace(f"mma_tiles<{shape}, true>(\n            {acc},",
                                f"mma_tiles<{shape}>(\n            part,")
           .replace(f"mma_tiles<{shape}, true>({acc},",
                    f"mma_tiles<{shape}>(part,")
           + f"\n{indent}add_part<{shape}>({acc}, part);")
    return text, new


# variant -> [(text in csrc/wavenet_stack_bwd.cu, its replacement)]
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "base": [],
    "in_place": [_in_place(loop) for loop in _LOOPS] + [(
        """      float part = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < KR; ++kk) part += rhs[kk * RHS_LD + tid];
      colsum += part;""",
        """#pragma unroll 8
      for (int kk = 0; kk < KR; ++kk) colsum += rhs[kk * RHS_LD + tid];""")],
    "chunk_partials": [(
        '#include "wavenet_common.cuh"\n',
        '#include "wavenet_common.cuh"\n' + _ADD_PART)]
    + [_chunk_partials(loop) for loop in _LOOPS],
}

# (name, batch, samples, dilations, seed): the card tests' edge cases and
# the PWG v1 training shape on two seeds
CASES = [("one_cycle", 2, 4133, tuple(2 ** i for i in range(10)), 12),
         ("d_past_T", 1, 130, (512, 1), 12),
         ("train_shape", 6, 25600, tuple(2 ** i for i in range(10)), 12),
         ("train_shape_seed5", 6, 25600, tuple(2 ** i for i in range(10)), 5)]


def variant_source(name: str) -> str:
    """csrc/wavenet_stack_bwd.cu with variant ``name``'s edits."""
    text = (build.CSRC_DIR / SOURCE).read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: the source holds "
                               f"{text.count(old)} x {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants(names) -> Dict[str, str]:
    """Write and compile every variant in parallel; {name: library}."""
    out_dir = build.BUILD_DIR / "f32_sums"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = out_dir / f"wavenet_stack_bwd_{name}.cu"
        src.write_text(variant_source(name))
        lib = out_dir / f"libwavenet_stack_bwd_{name}.so"
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


def _inputs(rng, B, T, L, device):
    def t(*shape, scale=1.0):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32) * scale).to(device)

    w = {"w_tap": t(L, 3, 64, 128, scale=0.1),
         "b_tap": t(L, 128, scale=0.1), "w_aux": t(L, 80, 128, scale=0.1),
         "w_so": t(L, 64, 128, scale=0.1), "b_so": t(L, 128, scale=0.1)}
    return t(B, T, 64), t(B, T, 80), w, t(B, T, 64), t(B, T, 64)


def _grads(fn, x, c, w, dils, ux, us):
    x = x.detach().requires_grad_()
    c = c.detach().requires_grad_()
    w = {k: v.detach().requires_grad_() for k, v in w.items()}
    xo, sk = fn(x, c, w, dils)
    loss = (xo * ux).sum() + (sk * us).sum()
    names = list(w)
    grads = torch.autograd.grad(loss, [x, c] + [w[k] for k in names])
    return dict(zip(["dx", "dc"] + names, grads))


def _use(path: str) -> None:
    wst.load_library = lambda _name, p=path: ctypes.CDLL(p)
    wst._library.cache_clear()


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("backward_f32_sums needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    libs = build_variants(VARIANTS)
    kept = wst.load_library
    results = []

    def emit(row):
        results.append(dict(row, card=card))
        print(json.dumps(results[-1]))

    try:
        exact = {}
        for name, path in libs.items():
            _use(path)
            for case, B, T, dils, seed in CASES:
                x, c, w, ux, us = _inputs(np.random.default_rng(seed), B, T,
                                          len(dils), dev)
                got = _grads(wst.wavenet_stack_train, x, c, w, dils, ux, us)
                plain = _grads(wst.wavenet_stack_train_reference, x, c, w,
                               dils, ux, us)
                if case not in exact:
                    exact[case] = _grads(
                        wst.wavenet_stack_train_reference, x.double(),
                        c.double(), {k: v.double() for k, v in w.items()},
                        dils, ux.double(), us.double())
                ratios = {k: rel_err(got[k], exact[case][k])
                          / rel_err(plain[k], exact[case][k]) for k in got}
                emit({"variant": name, "case": case,
                      "worst_over_plain": max(ratios.values()),
                      "over_plain": ratios})
        del exact
        x, c, w, ux, us = _inputs(np.random.default_rng(1), 6, 25600, 10, dev)
        dils = tuple(2 ** i for i in range(10))
        xs = wavenet_stack(x, c, w, dils, save_inputs=True)[2]
        order = list(libs) + list(libs)[::-1]
        for name in order:
            _use(libs[name])

            def backward():
                for _ in range(3):
                    wst.wavenet_stack_backward(xs, c, w, dils, ux, us)

            backward()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                backward()
            end.record()
            torch.cuda.synchronize()
            emit({"variant": name, "backward_ms_30_layers":
                  start.elapsed_time(end) / args.reps,
                  "batch": 6, "samples": 25600})
    finally:
        wst.load_library = kept
        wst._library.cache_clear()
    return results


if __name__ == "__main__":
    main()
