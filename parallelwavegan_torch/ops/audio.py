"""Host-side audio utilities for preprocessing and evaluation: silence
trimming, resampling, YIN f0 and the f0 features of the dumps.

The port's own copy of ``parallelwavegan_tpu/ops/audio.py`` (numpy and
scipy): numpy versions of what the reference preprocessing takes from
librosa (``effects.trim``, ``feature.rms``) and torchyin.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _frame_rms(x: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Centered per-frame RMS (librosa.feature.rms semantics)."""
    pad = frame_length // 2
    xp = np.pad(x, (pad, pad))
    n_frames = 1 + (len(xp) - frame_length) // hop_length
    idx = (
        np.arange(n_frames)[:, None] * hop_length
        + np.arange(frame_length)[None, :]
    )
    frames = xp[idx]
    return np.sqrt(np.mean(frames**2, axis=1))


def trim_silence(
    audio: np.ndarray,
    top_db: float = 60.0,
    frame_length: int = 2048,
    hop_length: int = 512,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Trim leading/trailing silence (librosa.effects.trim semantics):
    frames quieter than max - top_db are silence."""
    rms = _frame_rms(audio, frame_length, hop_length)
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / max(rms.max(), 1e-10))
    non_silent = np.flatnonzero(db > -top_db)
    if len(non_silent) == 0:
        return audio[:0], (0, 0)
    start = int(non_silent[0] * hop_length)
    end = int(min(len(audio), (non_silent[-1] + 1) * hop_length))
    return audio[start:end], (start, end)


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy)."""
    if orig_sr == target_sr:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g).astype(
        audio.dtype
    )


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


def log_f0(
    audio: np.ndarray,
    sampling_rate: int,
    hop_size: int = 256,
    frame_length: Optional[int] = None,
    pitch_min: float = 40.0,
    pitch_max: float = 10000.0,
) -> np.ndarray:
    """Log-domain YIN f0 with the reference's torchyin dump contract:
    unvoiced frames are 0, voiced frames carry
    log(f0); when `frame_length` is given, pitch_min = sr/(frame_length/2)
    (the reference passes win_length); pitch_max defaults to 10000 Hz.
    Integer-period YIN (no parabolic refinement), matching torchyin's
    discretization."""
    if frame_length is not None:
        pitch_min = sampling_rate / (frame_length / 2)
    f0 = yin_f0(
        audio, sampling_rate, hop_size,
        pitch_min=pitch_min, pitch_max=pitch_max,
        frame_length=frame_length, parabolic=False,
    )
    out = f0.astype(np.float32)
    nz = out != 0
    out[nz] = np.log(out[nz])
    return out


def interpolate_continuous_f0(f0: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Continuous log-f0 + voiced/unvoiced flags (the reference's pyreaper
    continuous-f0 path)."""
    vuv = (f0 > 0).astype(np.float32)
    if vuv.sum() == 0:
        return np.zeros_like(f0), vuv
    voiced_idx = np.flatnonzero(f0 > 0)
    cont = np.interp(np.arange(len(f0)), voiced_idx, f0[voiced_idx])
    return np.log(np.maximum(cont, 1e-10)).astype(np.float32), vuv


def logf0_and_vuv(
    audio: np.ndarray,
    sampling_rate: int,
    hop_size: int = 256,
    pitch_min: float = 40.0,
    pitch_max: float = 500.0,
) -> Optional[np.ndarray]:
    """Continuous log-f0 + voiced/unvoiced local features (#frames, 2).

    Role parity with the reference's pyreaper path: f0 from YIN, unvoiced
    gaps linearly
    interpolated, start/end padded with the first/last voiced value,
    log-domain; column 1 is the binary V/UV flag. Returns None when every
    frame is unvoiced (the reference skips such utterances).
    """
    f0 = yin_f0(
        np.pad(audio, (0, hop_size * 2)), sampling_rate, hop_size,
        pitch_min=pitch_min, pitch_max=pitch_max,
    )
    vuv = (f0 > 0).astype(np.float32)
    if vuv.sum() == 0:
        return None
    voiced = np.flatnonzero(f0 > 0)
    f0 = f0.astype(np.float64)
    f0[: voiced[0]] = f0[voiced[0]]
    f0[voiced[-1]:] = f0[voiced[-1]]
    unvoiced = np.flatnonzero(f0 <= 0)
    if len(unvoiced) > 0:
        f0[unvoiced] = np.interp(unvoiced, voiced, f0[voiced])
    lf0 = np.log(f0).astype(np.float32)
    return np.stack([lf0, vuv], axis=-1)
