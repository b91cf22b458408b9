"""Mel filterbank matrix (numpy), numerically matching librosa.filters.mel
defaults (htk=False, norm="slaney").

The port's own copy of ``parallelwavegan_tpu/ops/mel.py``: the Slaney-style
filterbank from the published formulas. It feeds the mel-spectrogram loss
(``ops/spectral.log_mel_spectrogram``).
"""

from __future__ import annotations

import functools

import numpy as np

_F_SP = 200.0 / 3.0  # Hz per mel below the log-scale knee (Slaney)
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mel = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mel,
    )
    return mel


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    f = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(m, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        f,
    )
    return f


@functools.lru_cache(maxsize=32)
def mel_filter_bank(
    sampling_rate: int,
    fft_size: int,
    num_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (num_mels, bins)."""
    if fmax is None:
        fmax = sampling_rate / 2.0
    bins = fft_size // 2 + 1
    fftfreqs = np.linspace(0.0, sampling_rate / 2.0, bins)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney-style energy normalization
    enorm = 2.0 / (mel_f[2 : num_mels + 2] - mel_f[:num_mels])
    weights *= enorm[:, None]
    return np.ascontiguousarray(weights, dtype=dtype)
