"""Kaldi-style scp datasets.

Counterpart of ``_get_feats_scp_loader`` and ``MelSCPDataset`` in
``parallelwavegan_tpu/datasets/scp_dataset.py``. The kind of a feats.scp
is read from its first entry: "file.ark:offset" is a Kaldi binary ark,
"file.h5:path" or "file.h5" hdf5, "file.npy" npy. The paired
``AudioMelSCPDataset`` and ``AudioSCPDataset`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from parallelwavegan_torch.utils.kaldiio_lite import (
    ArkScpReader,
    HDF5ScpLoader,
    NpyScpLoader,
)


def _get_feats_scp_loader(feats_scp: str):
    with open(feats_scp) as f:
        key, value = f.readline().replace("\n", "").split()
    if ":" in value:
        value_1, _ = value.split(":")
        if value_1.endswith(".ark"):
            return ArkScpReader(feats_scp)
        if value_1.endswith(".h5"):
            return HDF5ScpLoader(feats_scp)
        raise ValueError("Not supported feats.scp type.")
    if value.endswith(".h5"):
        return HDF5ScpLoader(feats_scp)
    if value.endswith(".npy"):
        return NpyScpLoader(feats_scp)
    raise ValueError("Not supported feats.scp type.")


class MelSCPDataset:
    """Mels (or (utt_id, mel) pairs) from a feats.scp, in its order; with
    ``mel_length_threshold`` the mels of at most that many frames are
    left out."""

    def __init__(
        self,
        feats_scp: str,
        mel_length_threshold: Optional[int] = None,
        return_utt_id: bool = False,
        allow_cache: bool = False,
    ):
        self.mel_loader = _get_feats_scp_loader(feats_scp)
        self.utt_ids = self.mel_loader.keys()
        if mel_length_threshold is not None:
            lengths = [self.mel_loader[k].shape[0] for k in self.utt_ids]
            self.utt_ids = [k for k, n in zip(self.utt_ids, lengths)
                            if n > mel_length_threshold]
        self.return_utt_id = return_utt_id
        self.allow_cache = allow_cache
        if allow_cache:
            self.caches = [() for _ in range(len(self.utt_ids))]

    def __len__(self) -> int:
        return len(self.utt_ids)

    def __getitem__(self, idx):
        if self.allow_cache and len(self.caches[idx]) != 0:
            return self.caches[idx]
        utt_id = self.utt_ids[idx]
        mel = np.asarray(self.mel_loader[utt_id], dtype=np.float32)
        items = (utt_id, mel) if self.return_utt_id else mel
        if self.allow_cache:
            self.caches[idx] = items
        return items
