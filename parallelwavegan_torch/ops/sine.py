"""Harmonic sine excitation (NSF-style), the input UHiFiGAN is trained and
served on.

Counterpart of ``parallelwavegan_tpu/ops/sine.py`` (the reference
``SineGen``): f0 (B, T, 1) -> harmonic sines with a random initial phase
per overtone, voiced/unvoiced gating and amplitude-matched noise. The
random initial phases and the noise come from an explicit
``torch.Generator`` (the JAX function takes a key), drawn in the JAX
function's order: the phases (uniform, (B, harmonic_num + 1)), then the
noise (normal, (B, T, harmonic_num + 1)), on the generator's device and
moved to f0's.

The cumulative phase is written as the JAX function writes it: the
running sum of the per-sample phase increments mod 1, and 1 subtracted
wherever that sum wraps, so that the phase fed to sin stays near [0, 1)
over any T in float32 (integer phase shifts leave sin unchanged).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def sine_excitation(
    f0: torch.Tensor,
    sampling_rate: int,
    harmonic_num: int = 0,
    sine_amp: float = 0.1,
    noise_std: float = 0.003,
    voiced_threshold: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sine_waves, uv, noise) of f0 (B, T, 1), whose unvoiced steps are 0:
    the first and the last (B, T, harmonic_num + 1), uv (B, T, 1)."""
    if f0.dim() != 3 or f0.shape[-1] != 1:
        raise ValueError(f"f0 must be (B, T, 1), not {tuple(f0.shape)}")
    dim = harmonic_num + 1
    B, T, _ = f0.shape
    dtype, device = f0.dtype, f0.device
    draw_on = generator.device if generator is not None else device
    harmonics = torch.arange(1, dim + 1, dtype=dtype, device=device)
    rad = torch.remainder(f0 * harmonics / sampling_rate, 1.0)  # (B, T, dim)
    rand_ini = torch.rand((B, dim), generator=generator, dtype=dtype,
                          device=draw_on).to(device)
    rand_ini[:, 0] = 0.0  # the fundamental keeps a zero initial phase
    rad = torch.cat([rad[:, :1] + rand_ini[:, None], rad[:, 1:]], dim=1)

    tmp_over_one = torch.remainder(torch.cumsum(rad, dim=1), 1.0)
    wrap = (tmp_over_one[:, 1:] - tmp_over_one[:, :-1]) < 0
    shift = torch.cat([torch.zeros((B, 1, dim), dtype=dtype, device=device),
                       -wrap.to(dtype)], dim=1)
    sines = torch.sin(torch.cumsum(rad + shift, dim=1) * (2.0 * math.pi)
                      ) * sine_amp

    uv = (f0 > voiced_threshold).to(dtype)
    noise_amp = uv * noise_std + (1.0 - uv) * sine_amp / 3.0
    noise = noise_amp * torch.randn(sines.shape, generator=generator,
                                    dtype=dtype, device=draw_on).to(device)
    return sines * uv + noise, uv, noise
