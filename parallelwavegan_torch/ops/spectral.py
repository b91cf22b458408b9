"""STFT magnitude and log-mel spectrogram for the spectral losses.

Counterpart of ``stft_magnitude``, ``log_mel_spectrogram`` and their helpers in
``parallelwavegan_tpu/ops/spectral.py``: reflect centre padding, the window
centre-padded to ``fft_size``, power clamped before the square root
(torch.stft semantics of the reference's loss). Two methods give the same
numbers: "matmul" frames the signal and multiplies by a window-folded
real-DFT basis (one large product, the GPU default), "fft" uses
``torch.fft.rfft`` (the CPU default). The framed product is a plain matrix
product outside any kernel and stays ``torch.matmul``; it runs in full
float32 whatever the process set (TF32 on the card, bf16 or TF32 through
oneDNN on the CPU: ``_full_f32``), in the backward too, as the JAX package
asks for ``Precision.HIGHEST``; so does the mel product (TF32 there would
move a log-mel L1 that the HiFi-GAN recipe multiplies by 45).

``preprocess_log_mel`` is the preprocessing's log-mel (the JAX package's
``log_mel_spectrogram_numpy``) on a device the caller names: the windowed
float32 frames go through a float64 FFT, the mel product and the log in
float64, and are rounded to float32 once, as numpy computes it.
"""

from __future__ import annotations

import functools
import math
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from parallelwavegan_torch.ops.mel import mel_filter_bank


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (torch.hann_window / scipy fftbins=True)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def get_window(window: Optional[str], win_length: int,
               dtype=np.float32) -> np.ndarray:
    n = np.arange(win_length)
    if window in ("hann", "hann_window"):
        return hann_window(win_length, dtype)
    if window in ("hamming", "hamming_window"):
        return (0.54 - 0.46 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)
    if window in ("blackman", "blackman_window"):
        x = 2.0 * np.pi * n / win_length
        return (0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2 * x)).astype(dtype)
    if window in ("rect", "rectangular", "ones", None):
        return np.ones(win_length, dtype=dtype)
    raise ValueError(f"unsupported window: {window}")


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Centre-pad a window to ``size`` (librosa.util.pad_center)."""
    n = len(window)
    lpad = (size - n) // 2
    return np.pad(window, (lpad, size - n - lpad))


@functools.lru_cache(maxsize=64)
def _rdft_basis(fft_size: int, win_length: int, window: str) -> np.ndarray:
    """Window-folded real-DFT basis (fft_size, 2 * (fft_size // 2 + 1)):
    frames @ basis == [Re(STFT) | Im(STFT)]. Computed in float64."""
    w = pad_center(get_window(window, win_length, np.float64), fft_size)
    t = np.arange(fft_size)[:, None]
    k = np.arange(fft_size // 2 + 1)[None, :]
    ang = 2.0 * np.pi * t * k / fft_size
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1) * w[:, None]
    return basis.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _basis_on(fft_size: int, win_length: int, window: str,
              device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The basis as a tensor on the device, made once: at fft_size 2048 it
    is 16.8 MB, too much to copy from the host in every loss call."""
    basis = torch.from_numpy(_rdft_basis(fft_size, win_length, window))
    return basis.to(device, dtype)


def frame_signal(x: torch.Tensor, frame_length: int, hop_size: int
                 ) -> torch.Tensor:
    """(..., T) -> overlapping frames (..., n_frames, frame_length)."""
    return x.unfold(-1, frame_length, hop_size)


_FULL_F32_LOCK = threading.Lock()
_full_f32_state = {"depth": 0, "saved": None}
_MATMULS = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)


class _full_f32:
    """Full-float32 matrix products inside the block on every backend,
    whatever the process has set: cuBLAS without TF32 (what ``allow_tf32``,
    ``torch.backends.cuda.matmul.fp32_precision`` and
    ``torch.set_float32_matmul_precision`` lower) and oneDNN without bf16
    or TF32 (what ``torch.backends.mkldnn.matmul.fp32_precision`` and a
    "medium" or "high" float32 matmul precision lower on the CPU).

    PyTorch holds the setting twice, as the legacy float32 matmul precision
    and per backend (``fp32_precision``), and its cuBLAS TF32 check raises
    where the two disagree. So the block sets both, to "highest" and to
    "ieee" for cuBLAS and oneDNN, and puts both back on exit. The legacy
    value is read with both backends at "ieee", where its getter never
    raises, so that a process that mixed the two APIs gets its own back.
    The settings are process-wide and threads share them (the ranks of
    ``tools/dp_emulation.py``): the first block to enter sets them, the
    last to leave restores them."""

    def __enter__(self):
        with _FULL_F32_LOCK:
            state = _full_f32_state
            if state["depth"] == 0:
                backends = [m.fp32_precision for m in _MATMULS]
                for m in _MATMULS:
                    m.fp32_precision = "ieee"
                state["saved"] = (torch.get_float32_matmul_precision(),
                                  backends)
                torch.set_float32_matmul_precision("highest")
            state["depth"] += 1

    def __exit__(self, *exc):
        with _FULL_F32_LOCK:
            state = _full_f32_state
            state["depth"] -= 1
            if state["depth"] == 0:
                legacy, backends = state["saved"]
                torch.set_float32_matmul_precision(legacy)
                for m, saved in zip(_MATMULS, backends):
                    m.fp32_precision = saved


class _MatmulHighest(torch.autograd.Function):
    """a @ b with a constant b in full float32 (``_full_f32``), forward and
    backward: the JAX package's ``Precision.HIGHEST``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(b)
        with _full_f32():
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, grad):
        (b,) = ctx.saved_tensors
        with _full_f32():
            return torch.matmul(grad, b.t()), None


def stft_magnitude(
    x: torch.Tensor,
    fft_size: int,
    hop_size: int,
    win_length: Optional[int] = None,
    window: str = "hann",
    center: bool = True,
    pad_mode: str = "reflect",
    power_clamp_min: float = 1e-7,
    method: str = "auto",
) -> torch.Tensor:
    """Magnitude spectrogram of (..., T) -> (..., n_frames, fft_size//2+1).

    method: "matmul" (framed product, the default on CUDA), "fft"
    (``torch.fft.rfft``, the default on the CPU) or "auto".
    """
    if win_length is None:
        win_length = fft_size
    if center:
        p = fft_size // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (p, p), mode=pad_mode)
        x = x.reshape(*lead, x.shape[-1])
    frames = frame_signal(x, fft_size, hop_size)
    if method == "auto":
        method = "matmul" if x.is_cuda else "fft"
    if method == "matmul":
        basis = _basis_on(fft_size, win_length, window, x.device, x.dtype)
        bins = fft_size // 2 + 1
        proj = _MatmulHighest.apply(frames, basis)
        power = proj[..., :bins] ** 2 + proj[..., bins:] ** 2
    elif method == "fft":
        w = pad_center(get_window(window, win_length, np.float32), fft_size)
        spec = torch.fft.rfft(frames * torch.from_numpy(w).to(x.device,
                                                              x.dtype), dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
    else:
        raise ValueError(f"unknown STFT method: {method}")
    return torch.sqrt(torch.clamp(power, min=power_clamp_min))


@functools.lru_cache(maxsize=16)
def _mel_basis_on(sampling_rate: int, fft_size: int, num_mels: int,
                  fmin: float, fmax: float, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    """The transposed mel filterbank (bins, num_mels) on the device."""
    melmat = mel_filter_bank(sampling_rate, fft_size, num_mels, fmin, fmax).T
    return torch.from_numpy(np.ascontiguousarray(melmat)).to(device, dtype)


def log_mel_spectrogram(
    x: torch.Tensor,
    sampling_rate: int,
    fft_size: int = 1024,
    hop_size: int = 256,
    win_length: Optional[int] = None,
    window: str = "hann",
    num_mels: int = 80,
    fmin: Optional[float] = None,
    fmax: Optional[float] = None,
    eps: float = 1e-10,
    log_base: Optional[float] = 10.0,
    clamp_amplitude: bool = False,
    center: bool = True,
    pad_mode: str = "reflect",
    method: str = "auto",
) -> torch.Tensor:
    """Log-mel spectrogram of (..., T) -> (..., n_frames, num_mels).

    With ``clamp_amplitude=False`` the amplitude is unclamped and the mel
    clamped at ``eps`` (the preprocessing's log-mel); with True the power is
    clamped at ``eps`` before the square root (the mel-spectrogram loss).
    """
    fmin = 0.0 if fmin is None else fmin
    fmax = sampling_rate / 2.0 if fmax is None else fmax
    amp = stft_magnitude(
        x, fft_size, hop_size, win_length, window, center=center,
        pad_mode=pad_mode, power_clamp_min=eps if clamp_amplitude else 0.0,
        method=method,
    )
    melmat = _mel_basis_on(sampling_rate, fft_size, num_mels, float(fmin),
                           float(fmax), x.device, x.dtype)
    mel = torch.clamp(_MatmulHighest.apply(amp, melmat), min=eps)
    if log_base is None:
        return torch.log(mel)
    return torch.log(mel) / math.log(log_base)


def preprocess_log_mel(
    audio: np.ndarray,
    sampling_rate: int,
    fft_size: int = 1024,
    hop_size: int = 256,
    win_length: Optional[int] = None,
    window: str = "hann",
    num_mels: int = 80,
    fmin: Optional[float] = None,
    fmax: Optional[float] = None,
    eps: float = 1e-10,
    log_base: Optional[float] = 10.0,
    device: Any = "cuda",
) -> np.ndarray:
    """Log-mel (n_frames, num_mels) float32 of a 1-D wave, for the feature
    dumps: the amplitude unclamped, the mel clamped at ``eps``.

    The float32 frames times the float32 window are transformed in float64
    (an FFT in float32 moves the quiet bins, whose mel lies near the clamp,
    by decades of log10), the mel product and the log too. The reflect pad
    is numpy's, on the host (it reflects again past the wave's length, and
    an empty wave raises numpy's ``ValueError``), as in the JAX function.
    """
    if win_length is None:
        win_length = fft_size
    x = np.asarray(audio, dtype=np.float32)
    p = fft_size // 2
    x = torch.from_numpy(np.pad(x, (p, p), mode="reflect")).to(device)
    w = pad_center(get_window(window, win_length, np.float32), fft_size)
    frames = x.unfold(0, fft_size, hop_size) * torch.from_numpy(w).to(device)
    amp = torch.fft.rfft(frames.double(), dim=-1).abs()
    fmin = 0.0 if fmin is None else fmin
    fmax = sampling_rate / 2.0 if fmax is None else fmax
    melmat = _mel_basis_on(sampling_rate, fft_size, num_mels, float(fmin),
                           float(fmax), amp.device, torch.float64)
    mel = torch.clamp(amp @ melmat, min=eps).log()
    if log_base is not None:
        mel = mel / math.log(log_base)
    return mel.float().cpu().numpy()
