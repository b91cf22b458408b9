"""File IO: hdf5 and npy feature files, WAV input and 16-bit PCM output,
YAML (or JSON) configs.

Counterpart of ``parallelwavegan_tpu/utils/io.py``. Configs go through
``utils/yaml_lite.py`` and hdf5 files through ``utils/hdf5_lite.py`` on
every machine, so the port needs neither PyYAML nor h5py (the tests hold
both modules to those libraries).
"""

from __future__ import annotations

import fnmatch
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from parallelwavegan_torch.utils import hdf5_lite, yaml_lite


def find_files(root_dir: str, query: str = "*.wav",
               include_root_dir: bool = True) -> List[str]:
    """Recursively collect files matching `query` (sorted); without
    ``include_root_dir`` the paths are relative to ``root_dir``."""
    files = []
    for root, _, filenames in os.walk(root_dir, followlinks=True):
        for filename in fnmatch.filter(filenames, query):
            files.append(os.path.join(root, filename))
    files = sorted(files)
    if not include_root_dir:
        files = [f.replace(root_dir + "/", "") for f in files]
    return files


def read_hdf5(hdf5_name: str, hdf5_path: str) -> np.ndarray:
    """Read a dataset from an hdf5 file."""
    if not os.path.exists(hdf5_name):
        raise FileNotFoundError(f"There is no such a hdf5 file ({hdf5_name}).")
    try:
        return hdf5_lite.read(hdf5_name, hdf5_path)
    except KeyError:
        raise KeyError(
            f"There is no such a data in hdf5 file ({hdf5_path} in "
            f"{hdf5_name})."
        ) from None


def hdf5_keys(hdf5_name: str) -> List[str]:
    """The names in an hdf5 file's root group."""
    return hdf5_lite.keys(hdf5_name)


def write_hdf5(hdf5_name: str, hdf5_path: str, write_data,
               is_overwrite: bool = True) -> None:
    """Write a dataset into an hdf5 file, creating parents as needed; the
    file's other datasets stay (it is read and written anew)."""
    write_data = np.asarray(write_data)
    folder = os.path.dirname(hdf5_name)
    if folder and not os.path.exists(folder):
        os.makedirs(folder, exist_ok=True)
    datasets = (hdf5_lite.read_all(hdf5_name) if os.path.exists(hdf5_name)
                else {})
    if hdf5_path in datasets and not is_overwrite:
        raise RuntimeError(
            f"Dataset {hdf5_path} already exists in {hdf5_name}."
        )
    datasets[hdf5_path] = write_data
    hdf5_lite.write(hdf5_name, datasets)


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


def load_config(path: str, overrides: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
    """Load a (reference-compatible) YAML experiment config, or a ``.json``
    one; ``overrides`` replace its top-level keys."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    config = json.loads(text) if path.endswith(".json") else \
        yaml_lite.load(text)
    if overrides:
        config.update(overrides)
    return config


def save_config(path: str, config: Dict[str, Any]) -> None:
    """Dump an experiment config as YAML (config.yml beside checkpoints)."""
    folder = os.path.dirname(path)
    if folder:
        os.makedirs(folder, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(yaml_lite.dump(config))
