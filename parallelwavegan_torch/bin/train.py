#!/usr/bin/env python3
"""Training CLI: config -> datasets -> collater -> loader -> Trainer.

Counterpart of ``parallelwavegan_tpu/bin/train.py`` for Parallel WaveGAN,
HiFi-GAN, the MelGAN family (MelGAN, multi-band MelGAN through PQMF, with
any of their discriminators), StyleMelGAN, the VQ-VAE (wav2wav: audio
dumps, with ``-global.npy`` speaker ids and ``-local.npy`` frame
conditions beside the ``-wave.npy`` files of an npy dump) and UHiFiGAN
(``-f0.npy`` and ``-excitation.npy`` beside them; ``--use-f0`` gives the
other families the f0 too, which their generators do not read) and the
discrete-symbol generators (token ids as ``-feats.npy``, one or two
columns; a duration generator's batches are the window's runs and their
lengths; the F0 generator reads ``-f0.npy``) on one device,
with ``--resume`` / ``--pretrain`` (a ``.ckpt``, a generator ``.gckpt`` or
a reference ``.pkl``) and the ``config.yml`` dump. Each split reads a dump directory
or Kaldi-style lists (a wav.scp and a feats.scp, optionally segments).
Runs on CUDA by default (``--device cpu`` for the host). Under
``distributed/launch.py`` it trains data-parallel: each rank loads its
shard of every batch (``batch_size`` / world, the collater's rng at seed +
1000 x rank) and the whole dev set, and rank 0 alone writes ``config.yml``,
the logs and the checkpoints (as the JAX CLI under several processes):

    python -m parallelwavegan_torch.bin.train --train-dumpdir dump/train \
        --dev-dumpdir dump/dev --outdir exp --config conf.yaml
    python -m parallelwavegan_torch.bin.train \
        --train-wav-scp train/wav.scp --train-feats-scp train/feats.scp \
        --dev-wav-scp dev/wav.scp --dev-feats-scp dev/feats.scp \
        --outdir exp --config conf/multi_band_melgan.v2.yaml
    python -m parallelwavegan_torch.distributed.launch --nproc_per_node 2 \
        -c python -m parallelwavegan_torch.bin.train ... --device cpu

``run`` is the same entry with the config as a dict; a split given as a
dict ``{"wav_scp": ..., "feats_scp": ..., "segments": ...}`` instead of a
directory reads the lists.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Any, Dict, Optional, Union

import numpy as np

from parallelwavegan_torch.datasets.audio_mel_dataset import (
    AudioDataset,
    AudioGlobalDataset,
    AudioLocalDataset,
    AudioMelDataset,
    AudioMelF0Dataset,
    AudioMelF0ExcitationDataset,
)
from parallelwavegan_torch.datasets.collater import Collater
from parallelwavegan_torch.datasets.loader import DataLoader
from parallelwavegan_torch.datasets.scp_dataset import AudioMelSCPDataset
from parallelwavegan_torch.engine.step import (
    is_duration,
    is_uhifigan,
    is_vqvae,
    uses_f0,
    uses_noise,
)
from parallelwavegan_torch.parallel import dist
from parallelwavegan_torch.utils.io import load_config, read_hdf5, save_config

VERSION = "parallelwavegan_torch-0.1.0"

# a split's data: a dump directory, or {"wav_scp", "feats_scp"[, "segments"]}
Split = Union[str, Dict[str, Optional[str]]]


def _mel_length_threshold(config: Dict[str, Any]) -> Optional[int]:
    if not config.get("remove_short_samples", False):
        return None
    return (config["batch_max_steps"] // config["hop_size"]
            + 2 * config.get("generator_params", {}).get(
                "aux_context_window", 0))


def build_scp_dataset(config: Dict[str, Any], wav_scp: str, feats_scp: str,
                      segments: Optional[str] = None) -> AudioMelSCPDataset:
    """Kaldi-style lists; as in the JAX package only the audio + mel path
    reads them (f0, VQVAE and UHiFiGAN inputs raise)."""
    gen_type = config.get("generator_type", "ParallelWaveGANGenerator")
    if gen_type == "UHiFiGANGenerator":
        raise NotImplementedError(
            "SCP format is not supported for f0 and excitation.")
    if uses_f0(config):
        raise NotImplementedError("SCP format is not supported for f0.")
    if gen_type == "VQVAE":
        raise NotImplementedError("SCP format is not supported for VQVAE.")
    return AudioMelSCPDataset(
        wav_scp=wav_scp, feats_scp=feats_scp, segments=segments,
        mel_length_threshold=_mel_length_threshold(config),
        allow_cache=config.get("allow_cache", False),
    )


def _side_load_fn(config: Dict[str, Any], name: str):
    """A load function of the audio file's path for the input ``name``
    beside the audio: the hdf5 dataset ``name``, or the npy file
    ``<utt>-<name>.npy`` beside ``<utt>-wave.npy``."""
    if config.get("format", "hdf5") == "hdf5":
        return lambda f: read_hdf5(f, name)
    return lambda f: np.load(f.replace("-wave.npy", f"-{name}.npy"))


def build_audio_dataset(config: Dict[str, Any], rootdir: str,
                        audio_query: str, audio_load_fn) -> AudioDataset:
    """A VQ-VAE's wav2wav dataset: audio longer than ``batch_max_steps``,
    with the local condition and (or) the speaker id the config asks for,
    from hdf5 ("local", "global") or from the npy files beside the
    ``-wave.npy`` ones (``-local.npy``, ``-global.npy``)."""
    kw = dict(audio_query=audio_query, audio_load_fn=audio_load_fn,
              audio_length_threshold=config["batch_max_steps"],
              allow_cache=config.get("allow_cache", False))
    use_global = config.get("use_global_condition", False)
    if config.get("use_local_condition", False):
        return AudioLocalDataset(
            rootdir, local_load_fn=_side_load_fn(config, "local"),
            global_load_fn=(_side_load_fn(config, "global") if use_global
                            else None), **kw)
    if use_global:
        return AudioGlobalDataset(
            rootdir, global_load_fn=_side_load_fn(config, "global"), **kw)
    return AudioDataset(rootdir, **kw)


def build_dataset(config: Dict[str, Any], rootdir: str):
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
    if is_vqvae(config):
        return build_audio_dataset(config, rootdir, audio_query,
                                   audio_load_fn)
    common = dict(
        root_dir=rootdir, audio_query=audio_query, mel_query=mel_query,
        audio_load_fn=audio_load_fn, mel_load_fn=mel_load_fn,
        mel_length_threshold=_mel_length_threshold(config),
        allow_cache=config.get("allow_cache", False),
    )
    # UHiFiGAN reads f0 and excitation (hdf5 "f0" / "excitation", or
    # -f0.npy / -excitation.npy), use_f0 the f0 alone
    if is_uhifigan(config):
        return AudioMelF0ExcitationDataset(
            f0_load_fn=_side_load_fn(config, "f0"),
            excitation_load_fn=_side_load_fn(config, "excitation"), **common)
    if uses_f0(config):
        return AudioMelF0Dataset(f0_load_fn=_side_load_fn(config, "f0"),
                                 **common)
    return AudioMelDataset(**common)


def _split_dataset(config: Dict[str, Any], split: Split):
    if isinstance(split, dict):
        return build_scp_dataset(config, split["wav_scp"], split["feats_scp"],
                                 split.get("segments"))
    return build_dataset(config, split)


# the generator families whose batches the native loader assembles (JAX
# bin/train.py:171-176)
NATIVE_LOADER_FAMILIES = ("ParallelWaveGANGenerator", "MelGANGenerator",
                          "HiFiGANGenerator", "StyleMelGANGenerator")


def native_loader_for(config: Dict[str, Any], dataset, seed: int,
                      num_shards: int = 1, shard_index: int = 0):
    """The C++ loader (``datasets/native_loader.py``) where the config's
    ``use_native_loader`` (``auto``, the default, ``true`` or ``false``)
    asks for it, as the JAX CLI decides: ``auto`` takes it for npy dumps of
    the four mel2wav families without f0 when the library builds, ``true``
    takes it whatever (and raises where it cannot build or read the
    dumps), ``false`` never. Returns None for the PyTorch loader."""
    from parallelwavegan_torch.datasets import native_loader

    setting = config.get("use_native_loader", "auto")
    if not setting:
        return None
    if setting == "auto" and not (
            config.get("format", "hdf5") == "npy"
            and config.get("generator_type", "ParallelWaveGANGenerator")
            in NATIVE_LOADER_FAMILIES
            and not uses_f0(config)
            and hasattr(dataset, "audio_files")
            and native_loader.is_available()):
        return None
    return native_loader.NativeMelWavLoader(
        list(zip(dataset.audio_files, dataset.mel_files)),
        batch_size=dist.per_rank_batch(config["batch_size"], num_shards),
        batch_max_steps=config["batch_max_steps"],
        hop_size=config["hop_size"],
        aux_context_window=config.get("generator_params", {}).get(
            "aux_context_window", 0),
        use_noise_input=uses_noise(config),
        seed=seed, num_shards=num_shards, shard_index=shard_index,
    )


def build_loader(config: Dict[str, Any], dataset, seed: int,
                 num_shards: int = 1, shard_index: int = 0):
    """Shard ``shard_index`` of ``num_shards``: batches of ``batch_size`` /
    ``num_shards`` from its part of each epoch's permutation. The native
    loader where ``native_loader_for`` takes it, else the PyTorch
    ``DataLoader``, its windows cropped by the collater's rng seeded at
    seed + 1000 x ``shard_index``; the choice is logged."""
    native = native_loader_for(config, dataset, seed, num_shards,
                               shard_index)
    if native is not None:
        logging.info("Using the native (C++) data loader.")
        return native
    logging.info("Using the PyTorch data loader.")
    # z for the generators the step feeds it to (the JAX CLI gives it to
    # Parallel WaveGAN alone, so a use_noise_input run there lacks it); a
    # VQ-VAE takes audio windows and its conditions
    vq = is_vqvae(config)
    collater = Collater(
        batch_max_steps=config["batch_max_steps"],
        hop_size=config["hop_size"],
        aux_context_window=config.get("generator_params", {}).get(
            "aux_context_window", 0),
        use_noise_input=uses_noise(config),
        use_f0=uses_f0(config),
        use_f0_and_excitation=is_uhifigan(config),
        use_aux_input=not vq,
        use_duration=is_duration(config),
        use_global_condition=vq and config.get("use_global_condition",
                                               False),
        use_local_condition=vq and config.get("use_local_condition", False),
        rng=np.random.default_rng(seed + 1000 * shard_index),
    )
    return DataLoader(
        dataset, collater,
        batch_size=dist.per_rank_batch(config["batch_size"], num_shards),
        seed=seed, num_shards=num_shards, shard_index=shard_index,
        # the reference's num_workers maps onto the prefetch-queue depth
        prefetch=max(2, min(int(config.get("num_workers", 2) or 0), 8)),
    )


def run(config: Dict[str, Any], train: Split, dev: Split,
        outdir: str, resume: str = "", pretrain: str = "", seed: int = 0,
        device: Any = "cuda", dump_config: bool = True):
    """Train from a config dict; returns the Trainer when training ends.
    ``train`` and ``dev`` are dump directories or scp lists (``Split``).
    ``dump_config`` writes ``outdir/config.yml``. Under
    the launcher the process joins its group first and trains on its
    rank's device and shard."""
    from parallelwavegan_torch.engine.trainer import Trainer

    rank_device = dist.init_distributed(device)
    rank, world = dist.rank(), dist.world_size()

    config = dict(config, outdir=outdir, resume=resume, pretrain=pretrain,
                  seed=seed, version=VERSION)
    for name, split in (("train", train), ("dev", dev)):
        if isinstance(split, dict):
            config.update({f"{name}_{k}": v for k, v in split.items()})
        else:
            config[f"{name}_dumpdir"] = split
    os.makedirs(outdir, exist_ok=True)
    if dump_config and rank == 0:
        save_config(os.path.join(outdir, "config.yml"), config)
    for key, value in config.items():
        logging.info(f"{key} = {value}")
    train_dataset = _split_dataset(config, train)
    dev_dataset = _split_dataset(config, dev)
    logging.info(f"The number of training files = {len(train_dataset)}.")
    logging.info(f"The number of development files = {len(dev_dataset)}.")
    trainer = Trainer(
        config, build_loader(config, train_dataset, seed, world, rank),
        build_loader(config, dev_dataset, seed + 1), seed=seed,
        outdir=outdir, device=rank_device,
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
        description="Train a Parallel WaveGAN, HiFi-GAN, MelGAN, "
        "multi-band MelGAN, StyleMelGAN, VQ-VAE, UHiFiGAN or "
        "discrete-symbol model."
    )
    for split in ("train", "dev"):
        parser.add_argument(f"--{split}-dumpdir", default=None, type=str,
                            help=f"{split} dump directory")
        parser.add_argument(f"--{split}-wav-scp", default=None, type=str,
                            help=f"{split} wav.scp (with --{split}-feats-scp)")
        parser.add_argument(f"--{split}-feats-scp", default=None, type=str,
                            help=f"{split} feats.scp (with --{split}-wav-scp)")
        parser.add_argument(f"--{split}-segments", default=None, type=str,
                            help=f"{split} segments of the wav.scp")
    parser.add_argument("--use-f0", action="store_true",
                        help="train with the per-frame f0 as an extra input")
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
    splits = {}
    for split in ("train", "dev"):
        dumpdir = getattr(args, f"{split}_dumpdir")
        wav_scp = getattr(args, f"{split}_wav_scp")
        feats_scp = getattr(args, f"{split}_feats_scp")
        if dumpdir is None and (wav_scp is None or feats_scp is None):
            raise ValueError(f"--{split}-dumpdir or (--{split}-wav-scp and "
                             f"--{split}-feats-scp) is required.")
        if dumpdir is not None and wav_scp is not None:
            raise ValueError(f"give --{split}-dumpdir OR --{split}-wav-scp, "
                             "not both.")
        splits[split] = dumpdir if dumpdir is not None else {
            "wav_scp": wav_scp, "feats_scp": feats_scp,
            "segments": getattr(args, f"{split}_segments")}
    # join the launcher's group first: ranks other than 0 log errors only
    dist.init_distributed(args.device)
    logging.basicConfig(
        level=(logging.ERROR if dist.rank() != 0 else
               logging.INFO if args.verbose else logging.WARN),
        stream=sys.stdout,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    # the flag sets use_f0, as the JAX CLI's config takes its arguments
    config = dict(load_config(args.config), use_f0=args.use_f0)
    try:
        return run(config, splits["train"], splits["dev"],
                   args.outdir, args.resume or "",
                   args.pretrain or "", args.seed, args.device)
    finally:
        dist.shutdown_distributed()


if __name__ == "__main__":
    main()
