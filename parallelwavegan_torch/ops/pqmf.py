"""PQMF (pseudo-QMF) analysis and synthesis filterbanks, channels-last.

Counterpart of ``parallelwavegan_tpu/ops/pqmf.py``: a Kaiser-windowed sinc
prototype modulated into ``subbands`` cosine filters with +-pi/4 phase and a
gain of 2. Both directions run as one (J, S, S) convolution at the subband
rate over the phase-split signal (the polyphase form of the full-rate
filter plus stride-S decimation or zero-stuffing), computed in the input's
dtype. The filters are built once with numpy and scipy and kept on each
device and dtype that asks for them.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
from scipy.signal.windows import kaiser

from parallelwavegan_torch.ops.conv import conv1d, pad1d


def design_prototype_filter(
    taps: int = 62, cutoff_ratio: float = 0.142, beta: float = 9.0
) -> np.ndarray:
    """Kaiser-window lowpass prototype h(n), length taps + 1."""
    if taps % 2 != 0:
        raise ValueError("The number of taps must be even.")
    if not 0.0 < cutoff_ratio < 1.0:
        raise ValueError("cutoff_ratio must lie in (0, 1)")
    omega_c = np.pi * cutoff_ratio
    n = np.arange(taps + 1) - 0.5 * taps
    with np.errstate(invalid="ignore"):
        h_i = np.sin(omega_c * n) / (np.pi * n)
    h_i[taps // 2] = cutoff_ratio  # the sinc's limit at n = 0
    return h_i * kaiser(taps + 1, beta)


@functools.lru_cache(maxsize=8)
def pqmf_filters(
    subbands: int = 4,
    taps: int = 62,
    cutoff_ratio: float = 0.142,
    beta: float = 9.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(analysis, synthesis) filter banks, each (subbands, taps + 1)."""
    h_proto = design_prototype_filter(taps, cutoff_ratio, beta)
    n = np.arange(taps + 1) - taps / 2.0
    k = np.arange(subbands)[:, None]
    phase = (2 * k + 1) * (np.pi / (2 * subbands)) * n[None, :]
    sign = (-1.0) ** np.arange(subbands)[:, None]
    h_analysis = 2.0 * h_proto[None, :] * np.cos(phase + sign * np.pi / 4)
    h_synthesis = 2.0 * h_proto[None, :] * np.cos(phase - sign * np.pi / 4)
    return h_analysis.astype(np.float32), h_synthesis.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _polyphase_analysis_kernel(subbands, taps, cutoff_ratio, beta):
    """(J, S, S) subband-rate kernel and its (lo, hi) pads for analysis:
    y[m, s] = sum_q sum_j xr[m + j, q] * h_ana[s, j S + q + taps // 2],
    with xr[n, q] = x[n S + q] (zero-padded cross-correlation with h_ana,
    then stride-S decimation)."""
    h_analysis, _ = pqmf_filters(subbands, taps, cutoff_ratio, beta)
    S, half = subbands, taps // 2
    j_min = -((S - 1 + half) // S)
    j_max = (taps - half) // S
    ker = np.zeros((j_max - j_min + 1, S, S), np.float32)  # (j, q, s)
    for jj in range(ker.shape[0]):
        for q in range(S):
            k = (jj + j_min) * S + q + half
            if 0 <= k <= taps:
                ker[jj, q, :] = h_analysis[:, k]
    return ker, (-j_min, j_max)


@functools.lru_cache(maxsize=8)
def _polyphase_synthesis_kernel(subbands, taps, cutoff_ratio, beta):
    """(J, S, S) subband-rate kernel and its (lo, hi) pads for synthesis:
    y[n S + p] = S * sum_s sum_j x[n + j, s] * h_syn[s, j S + taps // 2 - p]
    (zero-stuffing by S, then zero-padded cross-correlation with h_syn)."""
    _, h_synthesis = pqmf_filters(subbands, taps, cutoff_ratio, beta)
    S, half = subbands, taps // 2
    j_min = -(half // S) - (1 if half % S else 0)
    j_max = (taps - half + S - 1) // S
    ker = np.zeros((j_max - j_min + 1, S, S), np.float32)  # (j, s, p)
    for jj in range(ker.shape[0]):
        for p in range(S):
            k = (jj + j_min) * S + half - p
            if 0 <= k <= taps:
                ker[jj, :, p] = S * h_synthesis[:, k]
    return ker, (-j_min, j_max)


@functools.lru_cache(maxsize=16)
def _kernel_on(direction: str, subbands: int, taps: int, cutoff_ratio: float,
               beta: float, device: torch.device, dtype: torch.dtype
               ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """A polyphase kernel as a tensor on ``device`` in ``dtype``, made once."""
    make = (_polyphase_analysis_kernel if direction == "analysis"
            else _polyphase_synthesis_kernel)
    ker, pads = make(subbands, taps, cutoff_ratio, beta)
    return torch.from_numpy(ker).to(device=device, dtype=dtype), pads


def pqmf_analysis(
    x: torch.Tensor,
    subbands: int = 4,
    taps: int = 62,
    cutoff_ratio: float = 0.142,
    beta: float = 9.0,
) -> torch.Tensor:
    """(B, T, 1) full-band wave -> (B, ceil(T / subbands), subbands)."""
    B, T, _ = x.shape
    S = subbands
    ker, pads = _kernel_on("analysis", S, taps, cutoff_ratio, beta,
                           x.device, x.dtype)
    t_out = -(-T // S)
    if T % S:
        x = pad1d(x, (0, t_out * S - T))
    xr = x.reshape(B, t_out, S)  # xr[:, n, q] = x[:, n S + q, 0]
    return conv1d(xr, ker, padding=pads)


def pqmf_synthesis(
    x: torch.Tensor,
    subbands: int = 4,
    taps: int = 62,
    cutoff_ratio: float = 0.142,
    beta: float = 9.0,
) -> torch.Tensor:
    """(B, T / subbands, subbands) -> (B, T, 1) full-band wave."""
    B, Ts, S = x.shape
    if S != subbands:
        raise ValueError(f"expected {subbands} subbands, got {S}")
    ker, pads = _kernel_on("synthesis", S, taps, cutoff_ratio, beta,
                           x.device, x.dtype)
    y = conv1d(x, ker, padding=pads)  # (B, Ts, S output phases)
    return y.reshape(B, Ts * S, 1)
