"""Host-side audio utilities: the YIN f0 estimator that the evaluation
metrics use.

The port's own copy of ``yin_f0`` from ``parallelwavegan_tpu/ops/audio.py``
(numpy only). Silence trimming, resampling and the f0 feature extractors of
that file belong to preprocessing and are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def yin_f0(
    audio: np.ndarray,
    sampling_rate: int,
    hop_size: int = 256,
    pitch_min: float = 40.0,
    pitch_max: float = 500.0,
    frame_length: Optional[int] = None,
    threshold: float = 0.1,
    parabolic: bool = True,
) -> np.ndarray:
    """YIN pitch per frame (de Cheveigné & Kawahara 2002); 0 = unvoiced.

    Cumulative-mean-normalized difference
    function, absolute threshold, then descent to the local minimum.
    parabolic=True additionally refines the period estimate by parabolic
    interpolation (YIN step 5; sub-sample accuracy). parabolic=False keeps
    the torchyin-style integer period, whose quantization error is
    ~f0^2/sampling_rate (torchyin returns sr / integer_tau).
    """
    if frame_length is None:
        frame_length = int(2 * sampling_rate / pitch_min)
    tau_min = max(1, int(sampling_rate / pitch_max))
    tau_max = min(frame_length - 1, int(sampling_rate / pitch_min))

    n_frames = max(0, 1 + (len(audio) - frame_length) // hop_size)
    f0 = np.zeros(n_frames, dtype=np.float32)
    for i in range(n_frames):
        frame = audio[i * hop_size : i * hop_size + frame_length].astype(
            np.float64
        )
        # difference function via autocorrelation identity:
        # d(tau) = sum_{j<W-tau} x_j^2 + sum_{j>=tau} x_j^2 - 2*corr(tau)
        spec = np.fft.rfft(frame, 2 * frame_length)
        corr = np.fft.irfft(spec * np.conj(spec))[: tau_max + 1]
        cumsq = np.concatenate([[0.0], np.cumsum(frame**2)])
        taus = np.arange(tau_max + 1)
        head = cumsq[frame_length - taus]
        tail = cumsq[frame_length] - cumsq[taus]
        d = head + tail - 2 * corr
        # cumulative mean normalized difference
        cmndf = np.ones_like(d)
        running = np.cumsum(d[1:])
        cmndf[1:] = d[1:] * np.arange(1, tau_max + 1) / np.maximum(
            running, 1e-12
        )
        # first tau under threshold; no dip below threshold -> unvoiced
        # (torchyin semantics: f0 = 0)
        region = cmndf[tau_min : tau_max + 1]
        below = np.flatnonzero(region < threshold)
        if len(below) == 0:
            continue
        tau = tau_min + below[0]
        # walk down to the local minimum
        while tau + 1 <= tau_max and cmndf[tau + 1] < cmndf[tau]:
            tau += 1
        # parabolic interpolation around tau
        if not parabolic:
            f0[i] = sampling_rate / float(tau)
            continue
        if 1 <= tau < tau_max:
            a, b, c = cmndf[tau - 1], cmndf[tau], cmndf[tau + 1]
            denom = a - 2 * b + c
            shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
            tau_f = tau + np.clip(shift, -1, 1)
        else:
            tau_f = float(tau)
        f0[i] = sampling_rate / tau_f
    return f0
