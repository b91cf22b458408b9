"""ctypes bindings for the native C++ data loader (``native/data_loader.cc``).

Counterpart of ``parallelwavegan_tpu/datasets/native_loader.py``: a
pthread pool that ``pread()``s only each crop's bytes from ``.npy`` dumps
and assembles fixed-shape mel2wav batches, overlapping host I/O with the
device's steps. The C++ source is the port's own copy of the JAX
package's, so the two loaders give bit-equal ``y``, ``c`` and ``z`` on the
same dumps and seed, at any thread count.

The shared library is built with ``g++`` at first use into
``parallelwavegan_torch/_build/`` (beside the CUDA libraries of
``ops/cuda/build.py``; the file name carries a hash of the source and the
flags). ``is_available()`` says whether it builds and loads; ``bin/train``
falls back to the PyTorch loader where it does not, or where the batches
are not mel2wav ones (hdf5 dumps, f0, the other families). The wait for
each batch is a ``data.wait`` span (``utils/tracing.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from parallelwavegan_torch.utils import tracing

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "native" / "data_loader.cc"
BUILD_DIR = PACKAGE_DIR / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LIB = None
_LIB_ERR: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpwg_data-{digest.hexdigest()[:12]}.so"


def build_library() -> str:
    """The loader's shared library, compiled now unless it is built."""
    out = library_path()
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, out)
    return str(out)


def _load_library():
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    try:
        lib = ctypes.CDLL(build_library())
    except (OSError, subprocess.CalledProcessError) as e:
        _LIB_ERR = str(e)
        logging.info(f"native data loader unavailable: {_LIB_ERR}")
        return None
    lib.pwg_loader_create.restype = ctypes.c_void_p
    lib.pwg_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
    ]
    for name in ("pwg_loader_mel_dim", "pwg_loader_num_utts",
                 "pwg_loader_num_batches"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.pwg_loader_start_epoch.restype = ctypes.c_int
    lib.pwg_loader_start_epoch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.pwg_loader_next.restype = ctypes.c_int
    lib.pwg_loader_next.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_float)] * 3
    lib.pwg_loader_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def is_available() -> bool:
    return _load_library() is not None


class NativeMelWavLoader:
    """Iterator of {"y", "c"[, "z"]} batches (float32 numpy) from ``.npy``
    wave/feats pairs: the ``datasets.loader.DataLoader`` surface
    (``set_epoch``, ``len``, ``iter``) and its shard and shuffle semantics
    (each shard a strided part of one permutation, padded by wrapping),
    with the C++ loader's own crop and noise streams."""

    def __init__(
        self,
        pairs: List[Tuple[str, str]],  # (wave_path, feats_path)
        batch_size: int,
        batch_max_steps: int,
        hop_size: int,
        aux_context_window: int = 2,
        use_noise_input: bool = False,
        shuffle: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        num_threads: int = 4,
        prefetch: int = 4,
    ):
        lib = _load_library()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_LIB_ERR}")
        self._lib = lib
        waves = (ctypes.c_char_p * len(pairs))(
            *[p[0].encode() for p in pairs])
        feats = (ctypes.c_char_p * len(pairs))(
            *[p[1].encode() for p in pairs])
        self._h = lib.pwg_loader_create(
            waves, feats, len(pairs), batch_size, batch_max_steps, hop_size,
            aux_context_window, int(use_noise_input), num_threads, prefetch,
            seed,
        )
        if not self._h:
            raise RuntimeError(
                "pwg_loader_create failed (unreadable npy dumps, mixed mel "
                "dims, or every utterance shorter than the crop window)")
        self.batch_size = batch_size
        self.batch_max_steps = batch_max_steps - (batch_max_steps % hop_size)
        self.hop_size = hop_size
        self.ctx = aux_context_window
        self.use_noise_input = use_noise_input
        self.shuffle = shuffle
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.mel_dim = lib.pwg_loader_mel_dim(self._h)
        self.num_utts = lib.pwg_loader_num_utts(self._h)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        per_shard = max(-(-self.num_utts // self.num_shards), self.batch_size)
        return per_shard // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        nb = self._lib.pwg_loader_start_epoch(
            self._h, self.epoch, self.shard_index, self.num_shards,
            int(self.shuffle))
        frames = self.batch_max_steps // self.hop_size
        fp = ctypes.POINTER(ctypes.c_float)
        for _ in range(nb):
            y = np.empty((self.batch_size, self.batch_max_steps, 1),
                         np.float32)
            c = np.empty((self.batch_size, frames + 2 * self.ctx,
                          self.mel_dim), np.float32)
            z = np.empty_like(y) if self.use_noise_input else None
            with tracing.span("data.wait"):
                rc = self._lib.pwg_loader_next(
                    self._h, y.ctypes.data_as(fp), c.ctypes.data_as(fp),
                    z.ctypes.data_as(fp) if z is not None else fp())
            if rc < 0:
                raise RuntimeError("native loader read error")
            if rc == 0:
                return
            out = {"y": y, "c": c}
            if z is not None:
                out["z"] = z
            yield out

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pwg_loader_destroy(h)
            self._h = None
