#!/usr/bin/env python3
"""How often the first float32 CPU magnitude of a fresh process goes wrong
(ROADMAP.md C-7).

Each run is a fresh Python process at two threads that computes one STFT
magnitude of a fixed signal once (fft 128, hop 32, window 64, the case of
``tests/test_torch_losses.py::test_stft_magnitude_matches_jax``) and prints
its largest error against float64, of the largest magnitude. Modes:

- ``port``: the port's ``ops/spectral.stft_magnitude``, imported as it
  is: importing the port makes one serial sqrt (a workaround);
- ``parallel_first_sqrt``: the same with that sqrt made a no-op, so that
  the magnitude's sqrt is the process's first (the code before it);
- ``torch_only``: the same steps (reflect pad, frames, product, power,
  sqrt) in torch alone, nothing of the port imported; ``torch_only_no_pad``
  without the reflect pad (frames of a longer drawn signal);
  ``torch_only_pow`` with ``power ** 0.5`` for the sqrt;
  ``torch_only_exp_first`` with a one-element exp just before the sqrt;
- ``bare``: a product of the same shapes from ``torch.randn``, then its
  magnitude; ``bare_after_pad`` with a reflect pad of other data first,
  ``bare_after_add`` with a parallel add of 10^6 elements first,
  ``bare_after_add_tanh`` that with the magnitude's tanh (of the power
  over its largest) for its sqrt, ``port_import_after_add_tanh`` the same
  after importing the port.

``--jobs`` runs go at once (the fault shows under load). Prints one line a
mode: runs, runs off by more than 1e-6, their errors.

    python3 first_sqrt_probe.py [--runs 200] [--jobs 4]

Run from the root of a checkout, on a CPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

MODES = ("port", "parallel_first_sqrt", "torch_only", "torch_only_no_pad",
         "torch_only_pow", "torch_only_exp_first", "bare", "bare_after_pad",
         "bare_after_add", "bare_after_add_tanh",
         "port_import_after_add_tanh")


def _signal() -> np.ndarray:
    rng = np.random.default_rng(0)
    t = np.arange(700) / 8000.0
    y = np.stack([0.4 * np.sin(2 * np.pi * (200 + 150 * i) * t)
                  for i in range(3)]) + 0.05 * rng.standard_normal((3, 700))
    return (y + 0.1 * rng.standard_normal((3, 700))).astype(np.float32)


def _float64_magnitude(x: np.ndarray) -> np.ndarray:
    from parallelwavegan_torch.ops.spectral import get_window, pad_center

    xp = np.pad(x.astype(np.float64), ((0, 0), (64, 64)), mode="reflect")
    n = 1 + (xp.shape[1] - 128) // 32
    idx = np.arange(n)[:, None] * 32 + np.arange(128)[None]
    w = pad_center(get_window("hann", 64, np.float64), 128)
    return np.sqrt(np.maximum(
        np.abs(np.fft.rfft(xp[:, idx] * w, axis=-1)) ** 2, 1e-7))


def child(mode: str) -> float:
    """One run in this (fresh) process: the error of its first
    magnitude."""
    import torch
    import torch.nn.functional as F

    torch.set_num_threads(2)
    x = _signal()
    if mode in ("port", "parallel_first_sqrt"):
        sqrt = torch.sqrt
        if mode == "parallel_first_sqrt":
            torch.sqrt = lambda t: t
        from parallelwavegan_torch.ops import spectral

        torch.sqrt = sqrt
        got = spectral.stft_magnitude(torch.from_numpy(x), 128, 32, 64,
                                      method="matmul").numpy()
        want = _float64_magnitude(x)
        return float(np.abs(got - want).max() / want.max())
    if mode == "port_import_after_add_tanh":
        import parallelwavegan_torch  # noqa: F401
    g = torch.Generator().manual_seed(0)
    if mode == "bare_after_pad":
        F.pad(torch.randn((3, 1, 700), generator=g), (64, 64),
              mode="reflect")
    if "after_add" in mode:
        (torch.ones(1_000_000) + 1).sum()
    if "bare" in mode or "after_add" in mode:
        a = torch.randn((66, 128), generator=g) @ torch.randn(
            (128, 130), generator=g)
    else:
        if mode == "torch_only_no_pad":
            xp = 0.3 * torch.randn((3, 828), generator=g)
        else:
            xp = F.pad(torch.from_numpy(x)[:, None], (64, 64),
                       mode="reflect")[:, 0]
        basis = 0.1 * torch.randn((128, 130), generator=g)
        a = xp.unfold(-1, 128, 32).contiguous() @ basis
    power = torch.clamp(a[..., :65] ** 2 + a[..., 65:] ** 2, min=1e-7)
    if mode == "torch_only_exp_first":
        torch.exp(torch.ones(1))
    if mode.endswith("tanh"):
        power = power / power.max()
        got, want = torch.tanh(power), torch.tanh(power.double())
    else:
        got = power ** 0.5 if mode == "torch_only_pow" else torch.sqrt(power)
        want = torch.sqrt(power.double())
    return ((got.double() - want).abs().max() / want.max()).item()


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--runs", type=int, default=200)
    parser.add_argument("--jobs", type=int, default=4)
    parser.add_argument("--child", choices=MODES)
    args = parser.parse_args(argv)
    if args.child:
        print(f"{child(args.child):.3e}")
        return 0

    here = os.path.dirname(os.path.abspath(__file__))

    def run(mode: str) -> float:
        out = subprocess.run(
            [sys.executable, os.path.join(here, "first_sqrt_probe.py"),
             "--child", mode],
            capture_output=True, text=True, check=True, timeout=300,
            cwd=here)
        return float(out.stdout.split()[-1])

    jobs = [mode for _ in range(args.runs) for mode in MODES]
    with ThreadPoolExecutor(args.jobs) as pool:
        errors = list(pool.map(run, jobs))
    for mode in MODES:
        errs = [e for m, e in zip(jobs, errors) if m == mode]
        off = sorted({f"{e:.2e}" for e in errs if e > 1e-6})
        print(f"{mode}: {len(errs)} runs, {sum(e > 1e-6 for e in errs)} "
              f"off by more than 1e-6 of the largest magnitude"
              + (f" ({', '.join(off)})" if off else "")
              + "; the others within "
              f"{max([e for e in errs if e <= 1e-6], default=0.0):.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
