#!/usr/bin/env python3
"""Discrete-token preprocessing CLI (host only): audio + token text ->
dumps for the discrete-symbol recipes.

Counterpart of ``parallelwavegan_tpu/bin/preprocess_tokens.py``: pairs
the audio of a wav.scp or a directory of wavs with the token sequences of
a Kaldi-style ``text`` file (e.g. HuBERT k-means indices) and writes
``feats`` = token ids (T', 1), or (T', 2) with a speaker index column
(``--utt2spk`` + ``--spk2idx``), audio cropped to len(feats) * hop_size;
``--use-f0`` (or ``use_f0``) adds the YIN f0 at the token rate:

    python -m parallelwavegan_torch.bin.preprocess_tokens \
        --wav-scp data/wav.scp --text data/text --dumpdir dump/raw \
        --config conf/hifigan_hubert.v1.yaml
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional

import numpy as np

from parallelwavegan_torch.datasets.audio_mel_dataset import AudioDataset
from parallelwavegan_torch.datasets.scp_dataset import AudioSCPDataset
from parallelwavegan_torch.ops.audio import resample, trim_silence, yin_f0
from parallelwavegan_torch.utils.io import load_config, read_wav, write_hdf5


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(
        description="Pair audio with discrete token features.")
    parser.add_argument("--wav-scp", "--scp", default=None, type=str)
    parser.add_argument("--segments", default=None, type=str)
    parser.add_argument("--rootdir", default=None, type=str)
    parser.add_argument(
        "--text", required=True, type=str,
        help="kaldi-style text file: <utt_id> <tok> <tok> ...")
    parser.add_argument("--utt2spk", default=None, type=str)
    parser.add_argument("--spk2idx", default=None, type=str)
    parser.add_argument(
        "--use-f0", action="store_true",
        help="also extract f0 at the token frame rate and dump it as the "
        "'f0' key (DiscreteSymbolF0Generator recipes)")
    parser.add_argument("--dumpdir", type=str, required=True)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARN,
        stream=sys.stdout,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    config = load_config(args.config)
    if (args.wav_scp is None) == (args.rootdir is None):
        raise ValueError("Please specify either --rootdir or --wav-scp.")
    if args.wav_scp is not None:
        dataset = AudioSCPDataset(args.wav_scp, segments=args.segments,
                                  return_utt_id=True,
                                  return_sampling_rate=True)
    else:
        dataset = AudioDataset(args.rootdir, "*.wav", audio_load_fn=read_wav,
                               return_utt_id=True)
    with open(args.text) as f:
        lines = [line.strip() for line in f if line.strip()]
    text = {line.split(maxsplit=1)[0]: line.split(maxsplit=1)[1].split()
            for line in lines}

    utt2spk = spk2idx = None
    if args.utt2spk is not None:
        if args.spk2idx is None:
            raise ValueError("--utt2spk requires --spk2idx")
        with open(args.utt2spk) as f:
            utt2spk = dict(line.split()[:2] for line in f if line.strip())
        with open(args.spk2idx) as f:
            spk2idx = {k: int(v) for k, v in (line.split()[:2] for line in f
                                              if line.strip())}
    if config["format"] not in ("hdf5", "npy"):
        raise ValueError("support only hdf5 or npy format.")

    os.makedirs(args.dumpdir, exist_ok=True)
    fs = config["sampling_rate"]
    hop_size = config["hop_size"]
    for utt_id, (audio, sr) in dataset:
        if audio.ndim != 1:
            raise ValueError(f"{utt_id} seems to be multi-channel.")
        if np.abs(audio).max() > 1.0:
            raise ValueError(f"{utt_id} seems to be different from 16 bit "
                             "PCM.")
        if utt_id not in text:
            logging.warning(f"{utt_id} has no token sequence; skipped.")
            continue
        if sr != fs:
            audio = resample(audio, sr, fs)
        if config.get("trim_silence", False):
            audio, _ = trim_silence(
                audio,
                top_db=config.get("trim_threshold_in_db", 60),
                frame_length=config.get("trim_frame_size", 2048),
                hop_length=config.get("trim_hop_size", 512),
            )

        feats = np.asarray(text[utt_id], dtype=np.int64).reshape(-1, 1)
        if spk2idx is not None:
            spk = utt2spk.get(utt_id)
            if spk in spk2idx:
                idx = spk2idx[spk]
            else:
                logging.warning(f"{spk} is unknown speaker.")
                idx = max(spk2idx.values()) + 1
            feats = np.concatenate(
                [feats, np.full((len(feats), 1), idx, dtype=np.int64)],
                axis=1)

        # crop both to the invariant len(audio) == len(feats) * hop
        feats = feats[: len(audio) // hop_size]
        audio = audio[: len(feats) * hop_size]
        if len(feats) == 0:
            logging.warning(f"{utt_id} is too short; skipped.")
            continue

        f0 = None
        if args.use_f0 or config.get("use_f0", False):
            f0 = yin_f0(np.pad(audio, (0, hop_size * 2)), fs, hop_size,
                        pitch_min=config.get("pitch_min", 40),
                        pitch_max=config.get("pitch_max", 500))[: len(feats)]
            f0 = np.pad(f0, (0, len(feats) - len(f0)))

        gain = config.get("global_gain_scale", 1.0)
        if gain > 0.0:
            audio = audio * gain
        if np.abs(audio).max() >= 1.0:
            logging.warning(f"{utt_id} causes clipping; skipped.")
            continue

        arrays = {"wave": audio.astype(np.float32),
                  "feats": feats.astype(np.float32)}
        if f0 is not None:
            arrays["f0"] = f0.astype(np.float32)
        for key, value in arrays.items():
            if config["format"] == "hdf5":
                write_hdf5(os.path.join(args.dumpdir, f"{utt_id}.h5"), key,
                           value)
            else:
                np.save(os.path.join(args.dumpdir, f"{utt_id}-{key}.npy"),
                        value, allow_pickle=False)


if __name__ == "__main__":
    main()
