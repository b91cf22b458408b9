#!/usr/bin/env python3
"""Mean and scale of dumped features (host only).

Counterpart of ``parallelwavegan_tpu/bin/compute_statistics.py``: an exact
running mean and variance over frames in float64 (``RunningStats``), over
the "feats" or the "local" key (``--target-feats``) of a dump directory or
a feats.scp, written as ``stats.h5`` ("mean", "scale") or ``stats.npy``
(the two rows stacked); with ``--utt2spk`` also one file per speaker,
``stats-<spk>``:

    python -m parallelwavegan_torch.bin.compute_statistics \
        --rootdir dump/train/raw --dumpdir dump/train \
        --config conf/parallel_wavegan.v1.yaml
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional

import numpy as np

from parallelwavegan_torch.datasets.audio_mel_dataset import MelDataset
from parallelwavegan_torch.datasets.scp_dataset import MelSCPDataset
from parallelwavegan_torch.utils.io import load_config, read_hdf5, write_hdf5


class RunningStats:
    """Exact streaming mean and variance over frames (Chan's batched
    update), in float64."""

    def __init__(self):
        self.n = 0
        self.mean = None
        self.m2 = None

    def update(self, x: np.ndarray) -> None:
        x = np.asarray(x, dtype=np.float64)
        n_b = x.shape[0]
        mean_b = x.mean(axis=0)
        m2_b = ((x - mean_b) ** 2).sum(axis=0)
        if self.mean is None:
            self.n, self.mean, self.m2 = n_b, mean_b, m2_b
            return
        delta = mean_b - self.mean
        tot = self.n + n_b
        self.mean = self.mean + delta * n_b / tot
        self.m2 = self.m2 + m2_b + delta**2 * self.n * n_b / tot
        self.n = tot

    @property
    def scale(self) -> np.ndarray:
        return np.sqrt(self.m2 / self.n)


def save_stats(stats: RunningStats, dumpdir: str, name: str, fmt: str
               ) -> None:
    if fmt == "hdf5":
        path = os.path.join(dumpdir, f"{name}.h5")
        write_hdf5(path, "mean", stats.mean.astype(np.float32))
        write_hdf5(path, "scale", stats.scale.astype(np.float32))
    else:
        np.save(os.path.join(dumpdir, f"{name}.npy"),
                np.stack([stats.mean, stats.scale]).astype(np.float32),
                allow_pickle=False)


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(
        description="Compute mean/scale of dumped features.")
    parser.add_argument("--feats-scp", "--scp", default=None, type=str)
    parser.add_argument("--rootdir", type=str, default=None)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--dumpdir", type=str, required=True)
    parser.add_argument(
        "--target-feats", type=str, default="feats",
        choices=["feats", "local"],
        help="which dumped feature key to accumulate statistics over")
    parser.add_argument(
        "--utt2spk", default=None, type=str,
        help="kaldi-style utt2spk; if given, also write per-speaker "
        "statistics as stats-<spk>")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARN,
        stream=sys.stdout,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    config = load_config(args.config)
    tf = args.target_feats
    with_utt = args.utt2spk is not None
    if (args.feats_scp is None) == (args.rootdir is None):
        raise ValueError("Please specify either --rootdir or --feats-scp.")
    if args.feats_scp is not None:
        dataset = MelSCPDataset(args.feats_scp, return_utt_id=with_utt)
    elif config["format"] == "hdf5":
        dataset = MelDataset(args.rootdir, "*.h5",
                             lambda f: read_hdf5(f, tf),
                             return_utt_id=with_utt)
    elif config["format"] == "npy":
        dataset = MelDataset(args.rootdir, f"*-{tf}.npy", np.load,
                             return_utt_id=with_utt)
    else:
        raise ValueError("support only hdf5 or npy format.")
    logging.info(f"The number of files = {len(dataset)}.")

    utt2spk = None
    if with_utt:
        with open(args.utt2spk) as f:
            utt2spk = dict(line.split()[:2] for line in f if line.strip())

    os.makedirs(args.dumpdir, exist_ok=True)
    stats = RunningStats()
    per_spk = {}
    for item in dataset:
        if utt2spk is not None:
            utt_id, mel = item
            spk = utt2spk.get(utt_id)
            if spk is not None:
                per_spk.setdefault(spk, RunningStats()).update(mel)
        else:
            mel = item
        stats.update(mel)

    base = "stats" if tf == "feats" else f"stats-{tf}"
    save_stats(stats, args.dumpdir, base, config["format"])
    for spk, s in per_spk.items():
        save_stats(s, args.dumpdir, f"{base}-{spk}", config["format"])


if __name__ == "__main__":
    main()
