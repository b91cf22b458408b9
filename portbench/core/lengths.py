"""Utterance lengths and mel contents, made from the seed.

Lengths: a fixed pool drawn once from the traffic file's distribution
with the file's own ``pool_seed`` and cut once into batches, so that every
run seed serves the same batches, in an order of its own. Mel contents:
crops of the repository's 24 asset mels (LJSpeech utterances,
normalized), joined end to end to each length; the audio beside each
asset mel is cropped alike where a corpus needs waveforms.
"""

from __future__ import annotations

import glob
import os
import wave
from typing import Iterator, List, Tuple

import numpy as np

ASSETS = os.path.join("assets", "quality")


def length_pool(spec: dict) -> np.ndarray:
    """``spec``: {"kind": "beta", "min", "max", "a", "b", "pool",
    "pool_seed"}: ``pool`` frame counts min + (max - min) Beta(a, b),
    rounded."""
    if spec["kind"] != "beta":
        raise ValueError(f"unknown length distribution {spec['kind']!r}")
    rng = np.random.default_rng(spec["pool_seed"])
    u = rng.beta(spec["a"], spec["b"], size=spec["pool"])
    lo, hi = spec["min"], spec["max"]
    return np.rint(lo + (hi - lo) * u).astype(np.int64)


def call_schedule(spec: dict, batch: int, rng: np.random.Generator
                  ) -> Iterator[np.ndarray]:
    """Pool indices, ``batch`` a call. The pool is cut into batches once,
    by the traffic's own ``pool_seed``, so that every run seed serves the
    same batches (the same padded shapes and the same audio); the seed
    orders the batches anew each cycle, and the utterances in each."""
    order = np.random.default_rng(spec["pool_seed"] + 1).permutation(
        spec["pool"])
    batches = [order[i:i + batch]
               for i in range(0, spec["pool"] - batch + 1, batch)]
    while True:
        for k in rng.permutation(len(batches)):
            yield rng.permutation(batches[k])


def read_wav(path: str) -> np.ndarray:
    with wave.open(path, "rb") as f:
        raw = f.readframes(f.getnframes())
        if f.getsampwidth() != 2 or f.getnchannels() != 1:
            raise ValueError(f"{path}: not 16-bit mono PCM")
    return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0


class Assets:
    """The asset mels (and, on request, their waveforms), in file order."""

    def __init__(self, root: str, with_audio: bool = False):
        files = sorted(glob.glob(os.path.join(root, ASSETS, "*-feats.npy")))
        if not files:
            raise FileNotFoundError(f"no asset mels under {root}/{ASSETS}")
        self.mels = [np.load(f).astype(np.float32) for f in files]
        self.audio = ([read_wav(f[:-len("-feats.npy")] + "-gt.wav")
                       for f in files] if with_audio else None)

    def utterance(self, frames: int, rng: np.random.Generator, hop: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """(mel (frames, 80), audio (frames * hop,) or None): seeded crops
        of random assets, each at least 16 frames, joined end to end."""
        mels: List[np.ndarray] = []
        audio: List[np.ndarray] = []
        left = frames
        while left > 0:
            k = int(rng.integers(len(self.mels)))
            mel = self.mels[k]
            n = min(left, int(rng.integers(16, len(mel) + 1)))
            s = int(rng.integers(0, len(mel) - n + 1))
            mels.append(mel[s:s + n])
            if self.audio is not None:
                audio.append(self.audio[k][s * hop:(s + n) * hop])
            left -= n
        return (np.concatenate(mels),
                np.concatenate(audio) if self.audio is not None else None)
