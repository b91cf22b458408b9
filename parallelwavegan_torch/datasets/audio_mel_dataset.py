"""Mel-only dataset over a directory of dumped features.

Counterpart of ``MelDataset`` in
``parallelwavegan_tpu/datasets/audio_mel_dataset.py``: ``*-feats.npy`` files
(or ``*.h5`` with a "feats" dataset, read through a lazy ``h5py`` import).
"""

from __future__ import annotations

import os
from typing import Callable

from parallelwavegan_torch.utils.io import find_files, read_hdf5


def _utt_id(path: str) -> str:
    """Basename sans extension and the npy modality suffix
    (utt0-wave.npy / utt0-feats.npy -> utt0)."""
    base = os.path.splitext(os.path.basename(path))[0]
    for suf in ("-wave", "-feats"):
        if base.endswith(suf):
            return base[: -len(suf)]
    return base


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

    def __getitem__(self, idx):
        mel = self.mel_load_fn(self.mel_files[idx])
        return (self.utt_ids[idx], mel) if self.return_utt_id else mel
