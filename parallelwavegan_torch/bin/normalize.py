#!/usr/bin/env python3
"""Normalize dumped features with precomputed statistics (host only).

Counterpart of ``parallelwavegan_tpu/bin/normalize.py``: (x - mean) /
scale of the "feats" or the "local" key (``--target-feats``; the binary
columns of "local", such as V/UV, are kept as they are), the waves copied
through (unless ``--skip-wav-copy``), and "f0", "excitation" and "global"
copied through where the source dump has them:

    python -m parallelwavegan_torch.bin.normalize --rootdir dump/train/raw \
        --dumpdir dump/train/norm --stats dump/train/stats.h5 \
        --config conf/parallel_wavegan.v1.yaml
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional

import numpy as np

from parallelwavegan_torch.datasets.audio_mel_dataset import AudioMelDataset
from parallelwavegan_torch.utils.io import (
    hdf5_keys,
    load_config,
    read_hdf5,
    write_hdf5,
)


def read_stats(path: str) -> tuple:
    """(mean, scale) of a stats.h5 or a stats.npy."""
    if path.endswith(".h5"):
        return (read_hdf5(path, "mean").reshape(-1),
                read_hdf5(path, "scale").reshape(-1))
    arr = np.load(path)
    return arr[0].reshape(-1), arr[1].reshape(-1)


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(
        description="Normalize dumped features with mean/scale statistics.")
    parser.add_argument("--rootdir", type=str, required=True)
    parser.add_argument("--dumpdir", type=str, required=True)
    parser.add_argument("--stats", type=str, required=True)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--skip-wav-copy", action="store_true")
    parser.add_argument(
        "--target-feats", type=str, default="feats",
        choices=["feats", "local"],
        help="which dumped feature key to normalize; binary columns of "
        "'local' features are kept un-normalized")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARN,
        stream=sys.stdout,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    config = load_config(args.config)
    mean, scale = read_stats(args.stats)
    tf = args.target_feats
    hdf5 = config["format"] == "hdf5"
    if hdf5:
        dataset = AudioMelDataset(
            args.rootdir, "*.h5", "*.h5", lambda f: read_hdf5(f, "wave"),
            lambda f: read_hdf5(f, tf), return_utt_id=True)
    elif config["format"] == "npy":
        dataset = AudioMelDataset(
            args.rootdir, "*-wave.npy", f"*-{tf}.npy", np.load, np.load,
            return_utt_id=True)
    else:
        raise ValueError("support only hdf5 or npy format.")

    os.makedirs(args.dumpdir, exist_ok=True)
    # the other keys copied through as they are
    extra_keys = tuple(k for k in ("f0", "excitation", "global") if k != tf)
    src_by_utt = dict(zip(dataset.utt_ids, dataset.mel_files))
    for utt_id, audio, mel in dataset:
        mel_norm = (mel - mean) / scale
        if tf == "local":
            is_binary = (np.logical_or(mel == 1, mel == 0).sum(axis=0)
                         == len(mel))
            mel_norm[:, is_binary] = mel[:, is_binary]
        src = src_by_utt[utt_id]
        if hdf5:
            path = os.path.join(args.dumpdir, f"{utt_id}.h5")
            write_hdf5(path, tf, mel_norm.astype(np.float32))
            if not args.skip_wav_copy:
                write_hdf5(path, "wave", audio.astype(np.float32))
            present = set(hdf5_keys(src))
            for k in extra_keys:
                if k in present:
                    write_hdf5(path, k, read_hdf5(src, k))
            continue
        np.save(os.path.join(args.dumpdir, f"{utt_id}-{tf}.npy"),
                mel_norm.astype(np.float32), allow_pickle=False)
        if not args.skip_wav_copy:
            np.save(os.path.join(args.dumpdir, f"{utt_id}-wave.npy"),
                    audio.astype(np.float32), allow_pickle=False)
        for k in extra_keys:
            # beside "<utt>-<tf>.npy" (the JAX CLI looks beside
            # "-feats.npy" only: for "local" it copies the local file)
            side = src[: -len(f"-{tf}.npy")] + f"-{k}.npy"
            if os.path.exists(side):
                np.save(os.path.join(args.dumpdir, f"{utt_id}-{k}.npy"),
                        np.load(side), allow_pickle=False)


if __name__ == "__main__":
    main()
