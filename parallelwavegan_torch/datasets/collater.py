"""Batch collater: random fixed-window cropping into static-shape,
channels-last numpy batches.

Counterpart of the mel-to-waveform and the audio (wav2wav) branches of
``parallelwavegan_tpu/datasets/collater.py``; this package keeps its own
copy. Every batch has the same shapes: mel2wav {"y": (B, T, 1), "c":
(B, T' + 2 ctx, C)} and, with ``use_noise_input``, {"z": (B, T, 1)}; with
``use_f0`` (items (audio, mel, f0)) the f0 of the mel's frame window
{"f0": (B, T' + 2 ctx, 1)}; with ``use_f0_and_excitation`` (items (audio,
mel, f0, excitation)) also {"excitation": (B, (T' + 2 ctx) hop, 1)}, an
excitation dump of (frames, hop) cut on the frame window and flattened (a
1-D dump is first reshaped to (frames, hop)), as the reference cuts it;
wav2wav (a VQ-VAE: ``use_aux_input`` off, or a local or global condition)
{"y": (B, T, 1)} with {"l": (B, T' + 2 ctx, C)} and {"g": (B,)} as the
conditions ask; with ``use_duration`` (items (audio, token ids (T', 1|2)
or (T',))) the window's ids collapsed into runs of equal rows, {"c": (B, N,
1|2) int32 ids of the runs, zero-padded to the longest, "ds": (B, N)
int32 run lengths, zero-padded}. The random source is an explicit ``np.random.Generator``,
drawn in the JAX collater's order, so that one seed gives both packages
the same crops.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Collater:
    def __init__(
        self,
        batch_max_steps: int = 20480,
        hop_size: Optional[int] = 256,
        aux_context_window: int = 2,
        use_noise_input: bool = False,
        use_f0: bool = False,
        use_f0_and_excitation: bool = False,
        use_aux_input: bool = True,
        use_duration: bool = False,
        use_global_condition: bool = False,
        use_local_condition: bool = False,
        rng: Optional[np.random.Generator] = None,
    ):
        if hop_size is not None:
            batch_max_steps -= batch_max_steps % hop_size
            self.hop_size = hop_size
            self.batch_max_frames = batch_max_steps // hop_size
        self.batch_max_steps = batch_max_steps
        self.aux_context_window = aux_context_window
        self.use_noise_input = use_noise_input
        self.use_f0 = use_f0
        self.use_f0_and_excitation = use_f0_and_excitation
        self.use_aux_input = use_aux_input
        self.use_duration = use_duration
        self.use_global_condition = use_global_condition
        self.use_local_condition = use_local_condition
        self.rng = rng or np.random.default_rng()
        if use_aux_input or use_local_condition:
            self.start_offset = aux_context_window
            self.end_offset = -(self.batch_max_frames + aux_context_window)
            self.mel_threshold = self.batch_max_frames + 2 * aux_context_window
        else:
            self.start_offset = 0
            self.end_offset = -batch_max_steps
            self.audio_threshold = batch_max_steps

    def __call__(self, batch: List) -> Dict[str, np.ndarray]:
        if self.use_duration:
            return self._duration_batch(batch)
        if self.use_local_condition or self.use_global_condition \
                or not self.use_aux_input:
            return self._audio_batch(batch)
        return self._mel2wav_batch(batch)

    def _frame_windows(self, xs, cs, *frame_rate):
        """Random frame windows: (y (B, T, 1), the frames of each c with
        the context on both sides, then those frames of each list of
        frame-indexed arrays in ``frame_rate``)."""
        start_frames = np.array([
            self.rng.integers(self.start_offset, len(c) + self.end_offset)
            for c in cs
        ])
        x_starts = start_frames * self.hop_size
        c_starts = start_frames - self.aux_context_window
        c_ends = start_frames + self.batch_max_frames + self.aux_context_window
        y = np.stack([x[s: s + self.batch_max_steps]
                      for x, s in zip(xs, x_starts)]).astype(np.float32)
        cut = [np.stack([a[s:e] for a, s, e in zip(arrays, c_starts, c_ends)]
                        ).astype(np.float32) for arrays in (cs,) + frame_rate]
        return (y[..., None], *cut)

    def _mel2wav_batch(self, batch: List) -> Dict[str, np.ndarray]:
        batch = [self._adjust_length(*b) for b in batch
                 if len(b[1]) > self.mel_threshold]
        if not batch:
            raise ValueError("all utterances shorter than the mel threshold")
        frame_rate = []
        if self.use_f0 or self.use_f0_and_excitation:
            frame_rate.append([b[2] for b in batch])
        if self.use_f0_and_excitation:
            frame_rate.append([e.reshape(-1, self.hop_size) if e.ndim == 1
                               else e for e in (b[3] for b in batch)])
        y, c, *cut = self._frame_windows([b[0] for b in batch],
                                         [b[1] for b in batch], *frame_rate)
        out = {"y": y, "c": c}
        if self.use_noise_input:
            out["z"] = self.rng.standard_normal(y.shape).astype(np.float32)
        if frame_rate:
            out["f0"] = cut[0].reshape(cut[0].shape[0], -1, 1)
        if self.use_f0_and_excitation:
            out["excitation"] = cut[1].reshape(cut[1].shape[0], -1, 1)
        return out

    def _audio_batch(self, batch: List) -> Dict[str, np.ndarray]:
        """wav2wav: audio windows, with the local condition's frames
        (items (audio, local[, global id])) or a global id (items (audio,
        global id)) where the conditions are on."""
        if self.use_local_condition:
            items = [b for b in batch if len(b[1]) > self.mel_threshold]
            if not items:
                raise ValueError(
                    "all utterances shorter than the frame threshold")
            y, l = self._frame_windows(
                [self._adjust_length(b[0], b[1])[0] for b in items],
                [b[1] for b in items])
            out = {"y": y, "l": l}
            if self.use_global_condition:
                out["g"] = np.array([b[2] for b in items]).reshape(-1)
            return out
        gs = None
        if self.use_global_condition:
            gs = [b[1] for b in batch]
            batch = [b[0] for b in batch]
        xs = [x for x in batch if len(x) > self.audio_threshold]
        if not xs:
            raise ValueError("all utterances shorter than the audio threshold")
        starts = [self.rng.integers(0, len(x) - self.batch_max_steps)
                  for x in xs]
        y = np.stack([x[s: s + self.batch_max_steps]
                      for x, s in zip(xs, starts)]).astype(np.float32)
        out = {"y": y[..., None]}
        if gs is not None:
            out["g"] = np.array(gs).reshape(-1)
        return out

    def _duration_batch(self, batch: List) -> Dict[str, np.ndarray]:
        """Token windows as runs and their lengths (the JAX collater's
        draws: one start frame an utterance)."""
        batch = [self._adjust_length(*b) for b in batch
                 if len(b[1]) > self.mel_threshold]
        cs = [b[1] for b in batch]
        start_frames = np.array([
            self.rng.integers(self.start_offset, len(c) + self.end_offset)
            for c in cs
        ])
        y = np.stack([x[s * self.hop_size: s * self.hop_size
                        + self.batch_max_steps]
                      for x, s in zip((b[0] for b in batch), start_frames)]
                     ).astype(np.float32)[..., None]
        codes, durs = [], []
        for c, s in zip(cs, start_frames - self.aux_context_window):
            window = np.asarray(c[s: s + self.batch_max_frames
                                  + 2 * self.aux_context_window])
            if window.ndim == 1:
                window = window[:, None]
            # unique-consecutive over rows: the first row of each run
            change = np.any(window[1:] != window[:-1], axis=-1)
            starts = np.flatnonzero(np.concatenate([[True], change]))
            codes.append(window[starts])
            durs.append(np.diff(np.concatenate([starts, [len(window)]])))
        max_len = max(len(c) for c in codes)
        c_batch = np.zeros((len(codes), max_len, codes[0].shape[-1]),
                           dtype=np.int32)
        d_batch = np.zeros((len(codes), max_len), dtype=np.int32)
        for i, (code, d) in enumerate(zip(codes, durs)):
            c_batch[i, :len(code)] = code
            d_batch[i, :len(d)] = d
        return {"y": y, "c": c_batch, "ds": d_batch}

    def _adjust_length(self, x, c, *rest):
        """Pad or cut the audio so that len(x) == len(c) * hop."""
        want = len(c) * self.hop_size
        if len(x) < want:
            x = np.pad(x, (0, want - len(x)), mode="edge")
        return (x[:want], c) + rest
