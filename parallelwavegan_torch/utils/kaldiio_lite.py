"""Minimal pure-numpy Kaldi ark/scp readers.

Counterpart of ``parallelwavegan_tpu/utils/kaldiio_lite.py``: what the scp
datasets need, binary float/double matrices and vectors addressed as
"path.ark:offset", wav rxfiles (a path or a command pipe "... |"), and the
hdf5/npy scp variants ("file.h5:path", "file.npy"), hdf5 through
``utils.io.read_hdf5``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np


def _read_token(f) -> str:
    tok = b""
    while True:
        c = f.read(1)
        if c == b" " or c == b"":
            break
        tok += c
    return tok.decode()


def _read_int32(f, rxfile: str) -> int:
    """One Kaldi binary int: a size byte of 4, then the little-endian int."""
    if f.read(1) != b"\x04":
        raise ValueError(f"malformed kaldi size field in {rxfile}")
    return struct.unpack("<i", f.read(4))[0]


def read_kaldi_array(rxfile: str) -> np.ndarray:
    """Read a Kaldi binary matrix/vector from "path" or "path:offset"."""
    if ":" in rxfile and rxfile.rsplit(":", 1)[1].isdigit():
        path, offset = rxfile.rsplit(":", 1)
        offset = int(offset)
    else:
        path, offset = rxfile, 0
    with open(path, "rb") as f:
        f.seek(offset)
        binmark = f.read(2)
        if binmark != b"\x00B":
            raise ValueError(f"only binary kaldi data is supported ({rxfile})")
        tok = _read_token(f)
        if tok in ("FM", "DM"):
            dtype = np.float32 if tok == "FM" else np.float64
            rows = _read_int32(f, rxfile)
            cols = _read_int32(f, rxfile)
            data = np.frombuffer(f.read(rows * cols * dtype().itemsize), dtype)
            return data.reshape(rows, cols)
        if tok in ("FV", "DV"):
            dtype = np.float32 if tok == "FV" else np.float64
            size = _read_int32(f, rxfile)
            return np.frombuffer(f.read(size * dtype().itemsize), dtype)
        raise ValueError(f"unsupported kaldi data type {tok} in {rxfile}")


def load_scp(path: str) -> Dict[str, str]:
    """Parse an scp file into an ordered {utt_id: rxfile} dict."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            utt, rx = line.split(None, 1)
            out[utt] = rx
    return out


class ArkScpReader:
    """feats.scp-style reader: utt -> numpy array from binary ark."""

    def __init__(self, scp_path: str):
        self.entries = load_scp(scp_path)

    def keys(self) -> List[str]:
        return list(self.entries.keys())

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, utt: str) -> np.ndarray:
        return read_kaldi_array(self.entries[utt])

    def __iter__(self):
        for utt in self.entries:
            yield utt, self[utt]


def _read_wav_rxfile(rx: str):
    """Read a wav.scp rxfile: a plain path, or a Kaldi command pipe
    ("cmd args |" — the command's stdout is a wav stream), as kaldiio does."""
    from parallelwavegan_torch.utils.io import read_wav

    rx = rx.strip()
    if rx.endswith("|"):
        import io
        import subprocess

        out = subprocess.run(
            rx[:-1], shell=True, check=True, stdout=subprocess.PIPE
        ).stdout
        return read_wav(io.BytesIO(out))
    return read_wav(rx)


class WavScpReader:
    """wav.scp reader: utt -> (wave float32, rate). Supports plain paths and
    Kaldi command pipes ("... |")."""

    def __init__(self, scp_path: str, segments: str | None = None):
        self.entries = load_scp(scp_path)
        self.segments: Dict[str, Tuple[str, float, float]] = {}
        if segments is not None:
            with open(segments) as f:
                for line in f:
                    seg, rec, start, end = line.split()
                    self.segments[seg] = (rec, float(start), float(end))

    def keys(self) -> List[str]:
        return list(self.segments.keys() or self.entries.keys())

    def __len__(self):
        return len(self.segments) or len(self.entries)

    def __getitem__(self, utt: str):
        if self.segments:
            rec, start, end = self.segments[utt]
            wave, sr = _read_wav_rxfile(self.entries[rec])
            return wave[int(start * sr) : int(end * sr)], sr
        return _read_wav_rxfile(self.entries[utt])

    def __iter__(self):
        for utt in self.keys():
            yield (utt, *self[utt])


class HDF5ScpLoader:
    """scp entries "file.h5:path" (default path "feats"); comma-joined
    multi-path entries are concatenated on the last axis."""

    def __init__(self, feats_scp: str, default_hdf5_path: str = "feats"):
        self.default_hdf5_path = default_hdf5_path
        self.data = load_scp(feats_scp)

    def keys(self):
        return list(self.data.keys())

    def __len__(self):
        return len(self.data)

    def get_path(self, key):
        return self.data[key]

    def __getitem__(self, key):
        from parallelwavegan_torch.utils.io import read_hdf5

        p = self.data[key]
        if ":" in p:
            if "," in p:
                arrays = []
                for p_ in p.split(","):
                    f, h = p_.split(":")
                    arrays.append(read_hdf5(f, h))
                return np.concatenate(
                    [a if a.ndim != 1 else a.reshape(-1, 1) for a in arrays],
                    axis=-1,
                )
            f, h = p.split(":")
            return read_hdf5(f, h)
        return read_hdf5(p, self.default_hdf5_path)

    def values(self):
        for key in self.data:
            yield self[key]


class NpyScpLoader:
    """scp entries "file.npy"."""

    def __init__(self, feats_scp: str):
        self.data = load_scp(feats_scp)

    def keys(self):
        return list(self.data.keys())

    def __len__(self):
        return len(self.data)

    def get_path(self, key):
        return self.data[key]

    def __getitem__(self, key):
        return np.load(self.data[key])

    def values(self):
        for key in self.data:
            yield self[key]
