"""Multi-resolution STFT losses.

Counterpart of ``parallelwavegan_tpu/losses/stft_loss.py``: pure functions
of (B, T) signals, or of (B, C, T) flattened to (B*C, T). The Frobenius
norms run over the whole batch, as torch's do in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from parallelwavegan_torch.ops.spectral import stft_magnitude


def spectral_convergence_loss(x_mag: torch.Tensor, y_mag: torch.Tensor
                              ) -> torch.Tensor:
    """||Y - X||_F / ||Y||_F over the whole batch."""
    return torch.linalg.vector_norm(y_mag - x_mag) / torch.linalg.vector_norm(
        y_mag)


def log_stft_magnitude_loss(x_mag: torch.Tensor, y_mag: torch.Tensor
                            ) -> torch.Tensor:
    return torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))


@dataclass(frozen=True)
class STFTLoss:
    """Single-resolution (spectral-convergence, log-magnitude) loss pair."""

    fft_size: int = 1024
    shift_size: int = 120
    win_length: int = 600
    window: str = "hann"
    method: str = "auto"

    def __call__(self, x: torch.Tensor, y: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        x_mag = stft_magnitude(x, self.fft_size, self.shift_size,
                               self.win_length, self.window,
                               method=self.method)
        y_mag = stft_magnitude(y, self.fft_size, self.shift_size,
                               self.win_length, self.window,
                               method=self.method)
        return (spectral_convergence_loss(x_mag, y_mag),
                log_stft_magnitude_loss(x_mag, y_mag))


@dataclass(frozen=True)
class MultiResolutionSTFTLoss:
    """Mean of STFTLoss over several resolutions."""

    fft_sizes: Sequence[int] = (1024, 2048, 512)
    hop_sizes: Sequence[int] = (120, 240, 50)
    win_lengths: Sequence[int] = (600, 1200, 240)
    window: str = "hann"
    method: str = "auto"

    def __post_init__(self):
        if not (len(self.fft_sizes) == len(self.hop_sizes)
                == len(self.win_lengths)):
            raise ValueError("fft_sizes, hop_sizes and win_lengths differ "
                             "in length")

    def __call__(self, x: torch.Tensor, y: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        if x.dim() == 3:
            x = x.reshape(-1, x.shape[2])
            y = y.reshape(-1, y.shape[2])
        sc_loss, mag_loss = 0.0, 0.0
        for fs, ss, wl in zip(self.fft_sizes, self.hop_sizes,
                              self.win_lengths):
            sc, mag = STFTLoss(fs, ss, wl, self.window, self.method)(x, y)
            sc_loss = sc_loss + sc
            mag_loss = mag_loss + mag
        n = len(self.fft_sizes)
        return sc_loss / n, mag_loss / n
