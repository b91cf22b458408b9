"""The yardstick: the card's peaks, and operations and bytes counted from
shapes.

The kernel counts are copied from ``chip_smoke.py`` (``stack_flops``,
``backward_flops``, the bytes of ``stack_bound_ms`` and
``backward_bound_ms``, the operations and bytes of ``mrf_bound_ms``), so
that a later change to the program cannot move them. The peak a share is
taken against is fixed by the cell's dtype and never by the body a kernel
chose: float32 at the dense TF32 rate, the fastest at which the card
multiplies float32 operands (a split-TF32 or any other float32-accurate
route stays below it), bfloat16 at the dense bf16 rate. The model counts
(a forward, a training step) are in ``portbench/counts/``, a module a
family, which each configuration names.
"""

from __future__ import annotations

from typing import Dict, Sequence

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA data sheet)
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
ITEM = {"float32": 4, "bfloat16": 2}


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """max(operations at the dtype's peak, bytes at the memory rate)."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


# -- kernel B1: the WaveNet stack forward (R 64, G 128, S 64, A 80) ------
def stack_flops(B: int, T: int, L: int, R=64, G=128, S=64, A=80) -> float:
    return 2.0 * (3 * R * G + A * G + R * (S + R)) * B * T * L


def stack_bytes(B: int, T: int, L: int, dtype: str, R=64, G=128, S=64,
                A=80) -> float:
    """x and c read and x written in ``dtype``, skip written in float32,
    the weights read once."""
    item = ITEM[dtype]
    weights = L * (3 * R * G + G + A * G + R * (S + R) + S + R) * item
    return B * T * ((2 * R + A) * item + S * 4) + weights


# -- kernel B2: the WaveNet stack backward ----------------------------------
def backward_flops(B: int, T: int, L: int, A=80, R=64, G=128, S=64) -> float:
    """3 (3R + A) G + 2 R (S + R) multiply-adds per row and layer."""
    return 2.0 * (3 * (3 * R + A) * G + 2 * R * (S + R)) * B * T * L


def backward_bytes(B: int, T: int, L: int, dtype: str, A=80, R=64, G=128,
                   S=64) -> float:
    """xs, c and the cotangents in, dx and dc out, the weights in and
    their gradients out, each once."""
    item = ITEM[dtype]
    weights = L * (3 * R * G + G + A * G + R * (S + R) + S + R) * item
    return (B * T * (L * R * item + A * item + S * 4 + 2 * R * item
                     + A * item) + 2 * weights)


# -- kernel B3: one HiFi-GAN MRF stage ---------------------------------------
def mrf_flops(rows: int, C: int, kernels: Sequence[int], n_layers: int
              ) -> float:
    return 2.0 * rows * 2 * n_layers * sum(kernels) * C * C


def mrf_bytes(rows: int, C: int, kernels: Sequence[int], n_layers: int,
              dtype: str) -> float:
    """x read once and the output written once in ``dtype``, the weights
    once, the biases and scales in float32."""
    item = ITEM[dtype]
    return 2.0 * rows * C * item + (
        2 * n_layers * sum(kernels) * C * C * item
        + len(kernels) * 2 * n_layers * 3 * C * 4)


def hifigan_mrf_stage_rows(gp: dict, batch: int, frames: int
                           ) -> Dict[int, tuple]:
    """{stage: (rows, channels)} of the MRF stages at (batch, frames)."""
    out, length = {}, frames
    for i, s in enumerate(gp["upsample_scales"]):
        length *= s
        out[i] = (batch * length, gp["channels"] // 2 ** (i + 1))
    return out
