"""Mel-spectrogram L1 loss.

Counterpart of ``parallelwavegan_tpu/losses/mel_loss.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from parallelwavegan_torch.ops.spectral import log_mel_spectrogram


@dataclass(frozen=True)
class MelSpectrogramLoss:
    fs: int = 22050
    fft_size: int = 1024
    hop_size: int = 256
    win_length: Optional[int] = None
    window: str = "hann"
    num_mels: int = 80
    fmin: Optional[float] = 80.0
    fmax: Optional[float] = 7600.0
    center: bool = True
    normalized: bool = False
    onesided: bool = True
    eps: float = 1e-10
    log_base: Optional[float] = 10.0
    method: str = "auto"

    def __post_init__(self):
        if self.normalized or not self.onesided:
            raise ValueError("only the unnormalized one-sided STFT is "
                             "supported")

    def mel(self, x: torch.Tensor) -> torch.Tensor:
        """Log-mel of (B, T) or (B, C, T) flattened, -> (B, frames, mels)."""
        if x.dim() == 3:
            x = x.reshape(-1, x.shape[2])
        return log_mel_spectrogram(
            x, self.fs, self.fft_size, self.hop_size, self.win_length,
            self.window, self.num_mels, self.fmin, self.fmax, self.eps,
            self.log_base, clamp_amplitude=True, center=self.center,
            method=self.method,
        )

    def __call__(self, y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.mean(torch.abs(self.mel(y_hat) - self.mel(y)))
