"""Datasets over a directory of dumped features.

Counterpart of ``AudioMelDataset``, ``AudioMelF0Dataset``,
``AudioMelF0ExcitationDataset``, ``MelDataset``, ``MelF0Dataset``,
``MelF0ExcitationDataset``, ``AudioDataset``, ``AudioGlobalDataset`` and
``AudioLocalDataset`` in ``parallelwavegan_tpu/datasets/audio_mel_dataset.py``:
``*-wave.npy`` / ``*-feats.npy`` files (or ``*.h5`` with "wave" / "feats"
datasets, read through ``utils/hdf5_lite.py``). The F0 datasets add the
per-frame f0 and the excitation (a (frames, hop) dump), the wav2wav
datasets a speaker id ("global") and a frame-rate condition ("local"),
each read by a load function of the audio file's path (of the mel file's
for the mel-only datasets), hdf5 by default, as in the JAX package. Plain
Python sequences, numpy in and out.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Optional

import numpy as np

from parallelwavegan_torch.utils.io import find_files, read_hdf5


def _utt_id(path: str) -> str:
    """Basename sans extension and the npy modality suffix
    (utt0-wave.npy / utt0-feats.npy -> utt0)."""
    base = os.path.splitext(os.path.basename(path))[0]
    for suf in ("-wave", "-feats"):
        if base.endswith(suf):
            return base[: -len(suf)]
    return base


def _item(parts: tuple, utt_id: str, return_utt_id: bool):
    """An item of one part is that part, as the load function returned it
    (a (wave, rate) pair of ``read_wav`` too); the utterance id goes
    first."""
    if return_utt_id:
        return (utt_id,) + parts
    return parts if len(parts) > 1 else parts[0]


class MelDataset:
    """Sequence of mels (or (utt_id, mel) pairs), sorted by file name."""

    def __init__(
        self,
        root_dir: str,
        mel_query: str = "*.h5",
        mel_load_fn: Callable = lambda f: read_hdf5(f, "feats"),
        return_utt_id: bool = False,
    ):
        mel_files = find_files(root_dir, mel_query)
        if not mel_files:
            raise ValueError(f"No mel files in {root_dir}.")
        self.mel_files = mel_files
        self.mel_load_fn = mel_load_fn
        self.return_utt_id = return_utt_id
        self.utt_ids = [_utt_id(f) for f in mel_files]

    def __len__(self) -> int:
        return len(self.mel_files)

    def _load(self, idx: int) -> tuple:
        """The item's parts: (mel,) here, more in the subclasses."""
        return (self.mel_load_fn(self.mel_files[idx]),)

    def __getitem__(self, idx):
        return _item(self._load(idx), self.utt_ids[idx], self.return_utt_id)


class MelF0Dataset(MelDataset):
    """(mel, f0) items; ``f0_load_fn`` of the mel file gives the f0."""

    def __init__(self, root_dir: str,
                 f0_load_fn: Callable = lambda f: read_hdf5(f, "f0"),
                 **kwargs):
        super().__init__(root_dir, **kwargs)
        self.f0_load_fn = f0_load_fn

    def _load(self, idx: int) -> tuple:
        f = self.mel_files[idx]
        return (self.mel_load_fn(f), self.f0_load_fn(f))


class MelF0ExcitationDataset(MelF0Dataset):
    """(mel, f0, excitation) items; the excitation from
    ``excitation_load_fn`` of the mel file."""

    def __init__(self, root_dir: str,
                 excitation_load_fn: Callable = lambda f: read_hdf5(
                     f, "excitation"),
                 **kwargs):
        super().__init__(root_dir, **kwargs)
        self.excitation_load_fn = excitation_load_fn

    def _load(self, idx: int):
        return super()._load(idx) + (
            self.excitation_load_fn(self.mel_files[idx]),)


class AudioMelDataset:
    """Paired (audio, mel) items, sorted by file name, with the short ones
    filtered out at construction (each file is loaded once for that)."""

    def __init__(
        self,
        root_dir: str,
        audio_query: str = "*.h5",
        mel_query: str = "*.h5",
        audio_load_fn: Callable = lambda f: read_hdf5(f, "wave"),
        mel_load_fn: Callable = lambda f: read_hdf5(f, "feats"),
        audio_length_threshold: Optional[int] = None,
        mel_length_threshold: Optional[int] = None,
        return_utt_id: bool = False,
        allow_cache: bool = False,
    ):
        audio_files = find_files(root_dir, audio_query)
        mel_files = find_files(root_dir, mel_query)
        for files, load_fn, threshold, what in (
            (audio_files, audio_load_fn, audio_length_threshold, "audio"),
            (mel_files, mel_load_fn, mel_length_threshold, "mel"),
        ):
            if threshold is None:
                continue
            keep = [i for i, f in enumerate(files)
                    if load_fn(f).shape[0] > threshold]
            if len(keep) != len(files):
                logging.warning(
                    f"Some files are filtered by {what} length threshold "
                    f"({len(files)} -> {len(keep)})."
                )
            audio_files = [audio_files[i] for i in keep]
            mel_files = [mel_files[i] for i in keep]
        if not audio_files:
            raise ValueError(f"No audio files in {root_dir}.")
        if len(audio_files) != len(mel_files):
            raise ValueError(
                f"#audio != #mel files ({len(audio_files)} vs "
                f"{len(mel_files)})."
            )
        self.audio_files, self.mel_files = audio_files, mel_files
        self.audio_load_fn, self.mel_load_fn = audio_load_fn, mel_load_fn
        self.return_utt_id = return_utt_id
        self.utt_ids = [_utt_id(f) for f in audio_files]
        # the loader prefetches with a thread, so a plain list is a safe cache
        self.caches = [None] * len(audio_files) if allow_cache else None

    def __len__(self) -> int:
        return len(self.audio_files)

    def _load(self, idx: int) -> tuple:
        return (self.audio_load_fn(self.audio_files[idx]),
                self.mel_load_fn(self.mel_files[idx]))

    def __getitem__(self, idx):
        if self.caches is not None and self.caches[idx] is not None:
            return self.caches[idx]
        item = self._load(idx)
        if self.return_utt_id:
            item = (self.utt_ids[idx],) + item
        if self.caches is not None:
            self.caches[idx] = item
        return item


class AudioMelF0Dataset(AudioMelDataset):
    """(audio, mel, f0) items; ``f0_load_fn`` of the audio file gives the
    per-frame f0."""

    def __init__(self, root_dir: str,
                 f0_load_fn: Callable = lambda f: read_hdf5(f, "f0"),
                 **kwargs):
        super().__init__(root_dir, **kwargs)
        self.f0_load_fn = f0_load_fn

    def _load(self, idx: int) -> tuple:
        return super()._load(idx) + (
            self.f0_load_fn(self.audio_files[idx]),)


class AudioMelF0ExcitationDataset(AudioMelF0Dataset):
    """(audio, mel, f0, excitation) items; the excitation (frames, hop)
    from ``excitation_load_fn`` of the audio file."""

    def __init__(self, root_dir: str,
                 excitation_load_fn: Callable = lambda f: read_hdf5(
                     f, "excitation"),
                 **kwargs):
        super().__init__(root_dir, **kwargs)
        self.excitation_load_fn = excitation_load_fn

    def _load(self, idx: int) -> tuple:
        return super()._load(idx) + (
            self.excitation_load_fn(self.audio_files[idx]),)


class AudioDataset:
    """Audio items (or (utt_id, audio) pairs), sorted by file name, those
    no longer than ``audio_length_threshold`` samples filtered out at
    construction; with ``allow_cache`` each item is read once."""

    def __init__(
        self,
        root_dir: str,
        audio_query: str = "*.h5",
        audio_load_fn: Callable = lambda f: read_hdf5(f, "wave"),
        audio_length_threshold: Optional[int] = None,
        return_utt_id: bool = False,
        allow_cache: bool = False,
    ):
        audio_files = find_files(root_dir, audio_query)
        if audio_length_threshold is not None:
            audio_files = [f for f in audio_files
                           if audio_load_fn(f).shape[0]
                           > audio_length_threshold]
        if not audio_files:
            raise ValueError(f"No audio files in {root_dir}.")
        self.audio_files = audio_files
        self.audio_load_fn = audio_load_fn
        self.return_utt_id = return_utt_id
        self.utt_ids = [_utt_id(f) for f in audio_files]
        self.caches = [None] * len(audio_files) if allow_cache else None

    def __len__(self) -> int:
        return len(self.audio_files)

    def _load(self, idx: int) -> tuple:
        """The item's parts: (audio,) here, more in the subclasses."""
        return (self.audio_load_fn(self.audio_files[idx]),)

    def __getitem__(self, idx):
        if self.caches is not None and self.caches[idx] is not None:
            return self.caches[idx]
        item = _item(self._load(idx), self.utt_ids[idx], self.return_utt_id)
        if self.caches is not None:
            self.caches[idx] = item
        return item


def _speaker_id(value) -> int:
    return int(np.asarray(value).reshape(-1)[0])


class AudioGlobalDataset(AudioDataset):
    """(audio, speaker id) items for a globally conditioned VQ-VAE; the id
    is read by ``global_load_fn`` of the audio file (hdf5 "global" by
    default)."""

    def __init__(self, root_dir: str,
                 global_load_fn: Callable = lambda f: read_hdf5(f, "global"),
                 **kwargs):
        super().__init__(root_dir, **kwargs)
        self.global_load_fn = global_load_fn

    def _load(self, idx: int):
        f = self.audio_files[idx]
        return (self.audio_load_fn(f), _speaker_id(self.global_load_fn(f)))


class AudioLocalDataset(AudioDataset):
    """(audio, local[, speaker id]) items for a locally conditioned VQ-VAE:
    ``local_load_fn`` of the audio file gives the frame-rate condition
    (hdf5 "local" by default, e.g. log-f0 and V/UV), ``global_load_fn``
    (none by default) the speaker id."""

    def __init__(self, root_dir: str,
                 local_load_fn: Callable = lambda f: read_hdf5(f, "local"),
                 global_load_fn: Optional[Callable] = None, **kwargs):
        super().__init__(root_dir, **kwargs)
        self.local_load_fn = local_load_fn
        self.global_load_fn = global_load_fn

    def _load(self, idx: int):
        f = self.audio_files[idx]
        out = (self.audio_load_fn(f), self.local_load_fn(f))
        if self.global_load_fn is not None:
            out += (_speaker_id(self.global_load_fn(f)),)
        return out
