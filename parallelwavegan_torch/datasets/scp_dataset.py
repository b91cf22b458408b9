"""Kaldi-style scp datasets.

Counterpart of ``parallelwavegan_tpu/datasets/scp_dataset.py``: the paired
``AudioMelSCPDataset`` (wav.scp + feats.scp, optional segments), which
``bin/train`` reads, ``AudioSCPDataset`` and ``MelSCPDataset``. The kind of
a feats.scp is read from its first entry: "file.ark:offset" is a Kaldi
binary ark, "file.h5:path" or "file.h5" hdf5, "file.npy" npy. A wav.scp
entry is a wav path or a command pipe ("... |"); segments cut recordings
by time.
"""

from __future__ import annotations

from typing import Optional

import logging

import numpy as np

from parallelwavegan_torch.utils.kaldiio_lite import (
    ArkScpReader,
    HDF5ScpLoader,
    NpyScpLoader,
    WavScpReader,
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


def _keep_longer(keys: list, lengths: list, threshold: int, what: str
                 ) -> list:
    """The indices of ``keys`` whose length exceeds ``threshold``."""
    idxs = [i for i, n in enumerate(lengths) if n > threshold]
    if len(idxs) != len(keys):
        logging.warning(f"Some files are filtered by {what} length threshold "
                        f"({len(keys)} -> {len(idxs)}).")
    return idxs


class AudioMelSCPDataset:
    """Paired (audio, mel) items from a wav.scp and a feats.scp, in the
    wav.scp's order (or the segments'), the two files' entries paired by
    position. With the thresholds the items of at most that many samples
    or frames are left out. An item is (audio, mel), with
    ``return_sampling_rate`` ((audio, rate), mel), with ``return_utt_id``
    the utterance id first."""

    def __init__(
        self,
        wav_scp: str,
        feats_scp: str,
        segments: Optional[str] = None,
        audio_length_threshold: Optional[int] = None,
        mel_length_threshold: Optional[int] = None,
        return_utt_id: bool = False,
        return_sampling_rate: bool = False,
        allow_cache: bool = False,
    ):
        audio_loader = WavScpReader(wav_scp, segments)
        mel_loader = _get_feats_scp_loader(feats_scp)
        audio_keys, mel_keys = audio_loader.keys(), mel_loader.keys()
        if audio_length_threshold is not None:
            idxs = _keep_longer(
                audio_keys, [audio_loader[k][0].shape[0] for k in audio_keys],
                audio_length_threshold, "audio")
            audio_keys = [audio_keys[i] for i in idxs]
            mel_keys = [mel_keys[i] for i in idxs]
        if mel_length_threshold is not None:
            idxs = _keep_longer(
                mel_keys, [mel_loader[k].shape[0] for k in mel_keys],
                mel_length_threshold, "mel")
            audio_keys = [audio_keys[i] for i in idxs]
            mel_keys = [mel_keys[i] for i in idxs]
        if len(audio_keys) != len(mel_keys):
            raise ValueError(f"{wav_scp} and {feats_scp} differ in length")
        self.audio_loader = audio_loader
        self.mel_loader = mel_loader
        self.utt_ids = audio_keys
        self.return_utt_id = return_utt_id
        self.return_sampling_rate = return_sampling_rate
        self.allow_cache = allow_cache
        if allow_cache:
            self.caches = [() for _ in range(len(self.utt_ids))]

    def __len__(self) -> int:
        return len(self.utt_ids)

    def __getitem__(self, idx):
        if self.allow_cache and len(self.caches[idx]) != 0:
            return self.caches[idx]
        utt_id = self.utt_ids[idx]
        audio, sr = self.audio_loader[utt_id]
        mel = self.mel_loader[utt_id]
        audio = np.asarray(audio, dtype=np.float32)
        if self.return_sampling_rate:
            audio = (audio, sr)
        items = (utt_id, audio, mel) if self.return_utt_id else (audio, mel)
        if self.allow_cache:
            self.caches[idx] = items
        return items


class AudioSCPDataset:
    """Audio items from a wav.scp (with optional segments); with
    ``audio_length_threshold`` the items of at most that many samples are
    left out. An item is audio, (audio, rate) with
    ``return_sampling_rate``, the utterance id first with
    ``return_utt_id``."""

    def __init__(
        self,
        wav_scp: str,
        segments: Optional[str] = None,
        audio_length_threshold: Optional[int] = None,
        return_utt_id: bool = False,
        return_sampling_rate: bool = False,
        allow_cache: bool = False,
    ):
        self.audio_loader = WavScpReader(wav_scp, segments)
        self.utt_ids = self.audio_loader.keys()
        if audio_length_threshold is not None:
            lengths = [self.audio_loader[k][0].shape[0] for k in self.utt_ids]
            self.utt_ids = [k for k, n in zip(self.utt_ids, lengths)
                            if n > audio_length_threshold]
        self.return_utt_id = return_utt_id
        self.return_sampling_rate = return_sampling_rate
        self.allow_cache = allow_cache
        if allow_cache:
            self.caches = [() for _ in range(len(self.utt_ids))]

    def __len__(self) -> int:
        return len(self.utt_ids)

    def __getitem__(self, idx):
        if self.allow_cache and len(self.caches[idx]) != 0:
            return self.caches[idx]
        utt_id = self.utt_ids[idx]
        audio, sr = self.audio_loader[utt_id]
        audio = np.asarray(audio, dtype=np.float32)
        if self.return_sampling_rate:
            audio = (audio, sr)
        items = (utt_id, audio) if self.return_utt_id else audio
        if self.allow_cache:
            self.caches[idx] = items
        return items


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
