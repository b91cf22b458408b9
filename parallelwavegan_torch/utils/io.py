"""File IO: feature files, WAV input and 16-bit PCM output, YAML (or JSON)
configs.

Counterpart of the serving and training part of
``parallelwavegan_tpu/utils/io.py``. ``yaml`` and ``h5py`` are imported
inside the functions that need them, so the port runs where neither is
installed.
"""

from __future__ import annotations

import fnmatch
import json
import os
from typing import Any, Dict, List

import numpy as np


def find_files(root_dir: str, query: str = "*.wav") -> List[str]:
    """Recursively collect files matching `query` (sorted)."""
    files = []
    for root, _, filenames in os.walk(root_dir, followlinks=True):
        for filename in fnmatch.filter(filenames, query):
            files.append(os.path.join(root, filename))
    return sorted(files)


def read_hdf5(hdf5_name: str, hdf5_path: str) -> np.ndarray:
    """Read a dataset from an hdf5 file."""
    import h5py

    if not os.path.exists(hdf5_name):
        raise FileNotFoundError(f"There is no such a hdf5 file ({hdf5_name}).")
    with h5py.File(hdf5_name, "r") as f:
        if hdf5_path not in f:
            raise KeyError(
                f"There is no such a data in hdf5 file ({hdf5_path} in "
                f"{hdf5_name})."
            )
        return f[hdf5_path][()]


def read_wav(path):
    """Read a WAV file (path or file-like) -> (wave float32 in [-1, 1),
    sampling_rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 2**15
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2**31
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, sr


def write_wav(path: str, wave: np.ndarray, sampling_rate: int) -> None:
    """Write a float wave in [-1, 1] (or int16 PCM) as a 16-bit PCM WAV:
    clip to [-1, 1], scale by 32767, truncate toward zero."""
    from scipy.io import wavfile

    folder = os.path.dirname(path)
    if folder:
        os.makedirs(folder, exist_ok=True)
    wave = np.asarray(wave)
    if wave.dtype == np.int16:
        wavfile.write(path, sampling_rate, wave)
        return
    data = np.clip(wave.astype(np.float64), -1.0, 1.0)
    wavfile.write(path, sampling_rate, (data * 32767.0).astype(np.int16))


def load_config(path: str) -> Dict[str, Any]:
    """Load a (reference-compatible) YAML experiment config; a ``.json``
    file (JSON is a subset of YAML) is read without ``yaml``."""
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f)
        import yaml

        return yaml.load(f, Loader=yaml.SafeLoader)


def save_config(path: str, config: Dict[str, Any]) -> None:
    """Dump an experiment config as YAML (config.yml beside checkpoints)."""
    import yaml

    folder = os.path.dirname(path)
    if folder:
        os.makedirs(folder, exist_ok=True)
    with open(path, "w") as f:
        yaml.dump(config, f, Dumper=yaml.SafeDumper)
