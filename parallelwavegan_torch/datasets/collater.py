"""Batch collater: random fixed-window cropping into static-shape,
channels-last numpy batches.

Counterpart of the mel-to-waveform branch (``_mel2wav_batch``) of
``parallelwavegan_tpu/datasets/collater.py``; this package keeps its own
copy. Every batch has the same shapes: {"y": (B, T, 1), "c": (B, T' + 2 ctx,
C)} and, with ``use_noise_input``, {"z": (B, T, 1)}. The random source is an
explicit ``np.random.Generator``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Collater:
    def __init__(
        self,
        batch_max_steps: int = 20480,
        hop_size: int = 256,
        aux_context_window: int = 2,
        use_noise_input: bool = False,
        rng: Optional[np.random.Generator] = None,
    ):
        batch_max_steps -= batch_max_steps % hop_size
        self.hop_size = hop_size
        self.batch_max_steps = batch_max_steps
        self.batch_max_frames = batch_max_steps // hop_size
        self.aux_context_window = aux_context_window
        self.use_noise_input = use_noise_input
        self.rng = rng or np.random.default_rng()
        self.start_offset = aux_context_window
        self.end_offset = -(self.batch_max_frames + aux_context_window)
        self.mel_threshold = self.batch_max_frames + 2 * aux_context_window

    def __call__(self, batch: List) -> Dict[str, np.ndarray]:
        batch = [self._adjust_length(*b) for b in batch
                 if len(b[1]) > self.mel_threshold]
        if not batch:
            raise ValueError("all utterances shorter than the mel threshold")
        xs = [b[0] for b in batch]
        cs = [b[1] for b in batch]
        start_frames = np.array([
            self.rng.integers(self.start_offset, len(c) + self.end_offset)
            for c in cs
        ])
        x_starts = start_frames * self.hop_size
        x_ends = x_starts + self.batch_max_steps
        c_starts = start_frames - self.aux_context_window
        c_ends = start_frames + self.batch_max_frames + self.aux_context_window
        y = np.stack(
            [x[s:e] for x, s, e in zip(xs, x_starts, x_ends)]
        ).astype(np.float32)[..., None]
        c = np.stack(
            [c[s:e] for c, s, e in zip(cs, c_starts, c_ends)]
        ).astype(np.float32)
        out = {"y": y, "c": c}
        if self.use_noise_input:
            out["z"] = self.rng.standard_normal(y.shape).astype(np.float32)
        return out

    def _adjust_length(self, x, c):
        """Pad or cut the audio so that len(x) == len(c) * hop."""
        want = len(c) * self.hop_size
        if len(x) < want:
            x = np.pad(x, (0, want - len(x)), mode="edge")
        return x[:want], c
