#!/usr/bin/env python3
"""Training CLI: config -> datasets -> collater -> loader -> Trainer.

Counterpart of ``parallelwavegan_tpu/bin/train.py`` for Parallel WaveGAN and
HiFi-GAN on one device, with ``--resume`` / ``--pretrain`` and the ``config.yml`` dump.
Runs on CUDA by default (``--device cpu`` for the host):

    python -m parallelwavegan_torch.bin.train --train-dumpdir dump/train \
        --dev-dumpdir dump/dev --outdir exp --config conf.yaml

``run`` is the same entry with the config as a dict.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Any, Dict, Optional

import numpy as np

from parallelwavegan_torch.datasets.audio_mel_dataset import AudioMelDataset
from parallelwavegan_torch.datasets.collater import Collater
from parallelwavegan_torch.datasets.loader import DataLoader
from parallelwavegan_torch.utils.io import load_config, read_hdf5, save_config

VERSION = "parallelwavegan_torch-0.1.0"


def build_dataset(config: Dict[str, Any], rootdir: str) -> AudioMelDataset:
    fmt = config.get("format", "hdf5")
    if fmt == "hdf5":
        audio_query, mel_query = "*.h5", "*.h5"
        audio_load_fn = lambda f: read_hdf5(f, "wave")  # noqa: E731
        mel_load_fn = lambda f: read_hdf5(f, "feats")  # noqa: E731
    elif fmt == "npy":
        audio_query, mel_query = "*-wave.npy", "*-feats.npy"
        audio_load_fn = mel_load_fn = np.load
    else:
        raise ValueError("support only hdf5 or npy format.")
    mel_length_threshold = None
    if config.get("remove_short_samples", False):
        mel_length_threshold = (
            config["batch_max_steps"] // config["hop_size"]
            + 2 * config.get("generator_params", {}).get(
                "aux_context_window", 0)
        )
    return AudioMelDataset(
        root_dir=rootdir, audio_query=audio_query, mel_query=mel_query,
        audio_load_fn=audio_load_fn, mel_load_fn=mel_load_fn,
        mel_length_threshold=mel_length_threshold,
        allow_cache=config.get("allow_cache", False),
    )


def build_loader(config: Dict[str, Any], dataset, seed: int) -> DataLoader:
    gen_type = config.get("generator_type", "ParallelWaveGANGenerator")
    collater = Collater(
        batch_max_steps=config["batch_max_steps"],
        hop_size=config["hop_size"],
        aux_context_window=config.get("generator_params", {}).get(
            "aux_context_window", 0),
        use_noise_input=gen_type == "ParallelWaveGANGenerator",
        rng=np.random.default_rng(seed),
    )
    return DataLoader(
        dataset, collater, batch_size=config["batch_size"], seed=seed,
        # the reference's num_workers maps onto the prefetch-queue depth
        prefetch=max(2, min(int(config.get("num_workers", 2) or 0), 8)),
    )


def run(config: Dict[str, Any], train_dumpdir: str, dev_dumpdir: str,
        outdir: str, resume: str = "", pretrain: str = "", seed: int = 0,
        device: Any = "cuda", dump_config: bool = True):
    """Train from a config dict; returns the Trainer when training ends.
    ``dump_config`` writes ``outdir/config.yml`` (needs ``yaml``)."""
    from parallelwavegan_torch.engine.trainer import Trainer

    config = dict(config, train_dumpdir=train_dumpdir,
                  dev_dumpdir=dev_dumpdir, outdir=outdir, resume=resume,
                  pretrain=pretrain, seed=seed, version=VERSION)
    os.makedirs(outdir, exist_ok=True)
    if dump_config:
        save_config(os.path.join(outdir, "config.yml"), config)
    for key, value in config.items():
        logging.info(f"{key} = {value}")
    train_dataset = build_dataset(config, train_dumpdir)
    dev_dataset = build_dataset(config, dev_dumpdir)
    logging.info(f"The number of training files = {len(train_dataset)}.")
    logging.info(f"The number of development files = {len(dev_dataset)}.")
    trainer = Trainer(
        config, build_loader(config, train_dataset, seed),
        build_loader(config, dev_dataset, seed + 1), seed=seed,
        outdir=outdir, device=device,
    )
    if pretrain:
        trainer.load_checkpoint(pretrain, load_only_params=True)
        logging.info(f"Successfully loaded parameters from {pretrain}.")
    if resume:
        trainer.load_checkpoint(resume)
        logging.info(f"Successfully resumed from {resume}.")
    trainer.run()
    return trainer


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(
        description="Train a Parallel WaveGAN or HiFi-GAN vocoder."
    )
    parser.add_argument("--train-dumpdir", type=str, required=True)
    parser.add_argument("--dev-dumpdir", type=str, required=True)
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--resume", default="", type=str, nargs="?")
    parser.add_argument("--pretrain", default="", type=str, nargs="?")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="run on the GPU (default; fails without one) or the CPU",
    )
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARN,
        stream=sys.stdout,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    return run(load_config(args.config), args.train_dumpdir,
               args.dev_dumpdir, args.outdir, args.resume or "",
               args.pretrain or "", args.seed, args.device)


if __name__ == "__main__":
    main()
