#!/usr/bin/env python3
"""Feature extraction CLI: wavs -> feature dumps.

Counterpart of ``parallelwavegan_tpu/bin/preprocess.py``. Per utterance:
[trim silence] -> [resample for the features at
``sampling_rate_for_feats``] -> log-mel on ``--device`` (float64 FFT, mel
product and log, rounded to float32 once: ``ops/spectral.
preprocess_log_mel``) -> edge-pad the audio and crop it so that
len(audio) == len(mel) * hop -> [log-f0 (``--use-f0`` / ``use_f0``),
continuous log-f0 and V/UV as "local" (``--extract-f0``), the speaker
index as "global" (``--utt2spk`` + ``--spk2idx``), the sine excitation
(``use_excitation``)] -> ``global_gain_scale`` (an utterance that clips is
skipped) -> hdf5 (keys wave/feats/f0/excitation/local/global) or npy
files. Runs on CUDA by default (``--device cpu`` for the host):

    python -m parallelwavegan_torch.bin.preprocess --wav-scp data/wav.scp \
        --dumpdir dump/raw --config conf/parallel_wavegan.v1.yaml
    python -m parallelwavegan_torch.bin.preprocess --rootdir wavs \
        --dumpdir dump/raw --config conf.yaml --device cpu

The excitation's random phase and noise come from a CPU ``torch.
Generator`` seeded by the utterance id's CRC-32, the same on every run and
every device; the JAX CLI seeds from Python's ``hash``, which differs from
process to process.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import zlib
from typing import Optional

import numpy as np
import torch

from parallelwavegan_torch.datasets.audio_mel_dataset import AudioDataset
from parallelwavegan_torch.datasets.scp_dataset import AudioSCPDataset
from parallelwavegan_torch.ops.audio import (
    log_f0,
    logf0_and_vuv,
    resample,
    trim_silence,
)
from parallelwavegan_torch.ops.sine import sine_excitation
from parallelwavegan_torch.ops.spectral import preprocess_log_mel
from parallelwavegan_torch.utils.io import load_config, read_wav, write_hdf5


def read_speaker_index(utt2spk: str, spk2idx: str) -> dict:
    """utt -> speaker index from Kaldi-style utt2spk and spk2idx files; a
    speaker missing from spk2idx takes the largest index + 1."""
    with open(utt2spk) as f:
        spk_of = dict(line.split()[:2] for line in f if line.strip())
    with open(spk2idx) as f:
        index = {k: int(v) for k, v in (line.split()[:2] for line in f
                                        if line.strip())}
    return {u: index.get(s, max(index.values()) + 1)
            for u, s in spk_of.items()}


def excitation_seed(utt_id: str) -> int:
    """The excitation's seed: the CRC-32 of the utterance id."""
    return zlib.crc32(utt_id.encode("utf-8"))


def make_excitation(f0: np.ndarray, sampling_rate: int, hop_size: int,
                    n_frames: int, utt_id: str, device) -> np.ndarray:
    """The (n_frames, hop_size) sine excitation of a log-f0 contour.

    As the JAX CLI (the reference's singing-voice fork): the contour is
    tiled hop_size times, not repeated per frame, and given to the sine
    source as it is."""
    extended = np.tile(f0[None, :], (hop_size, 1)).reshape(1, -1, 1)
    generator = torch.Generator().manual_seed(excitation_seed(utt_id))
    sines, _, _ = sine_excitation(
        torch.from_numpy(extended.astype(np.float32)).to(device),
        sampling_rate, generator=generator)
    excitation = sines[0, :, 0].cpu().numpy()
    return excitation[: n_frames * hop_size].reshape(-1, hop_size)


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(
        description="Preprocess audio and extract features.")
    parser.add_argument("--wav-scp", "--scp", default=None, type=str)
    parser.add_argument("--segments", default=None, type=str)
    parser.add_argument("--rootdir", default=None, type=str)
    parser.add_argument("--dumpdir", type=str, required=True)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--use-f0", action="store_true")
    parser.add_argument(
        "--extract-f0", action="store_true",
        help="dump continuous log-f0 + V/UV as the 'local' feature key "
        "(locally conditioned VQ-VAE recipes)")
    parser.add_argument(
        "--utt2spk", default=None, type=str,
        help="kaldi-style utt2spk; with --spk2idx writes a 'global' "
        "speaker-index key (globally conditioned VQ-VAE recipes)")
    parser.add_argument("--spk2idx", default=None, type=str)
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="compute the log-mel and the excitation on the GPU (default; "
        "fails without one) or the CPU")
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
    utt2idx = None
    if args.utt2spk is not None:
        if args.spk2idx is None:
            raise ValueError("--utt2spk requires --spk2idx")
        utt2idx = read_speaker_index(args.utt2spk, args.spk2idx)
    if config["format"] not in ("hdf5", "npy"):
        raise ValueError("support only hdf5 or npy format.")

    os.makedirs(args.dumpdir, exist_ok=True)
    fs = config["sampling_rate"]
    hop_size = config["hop_size"]
    for utt_id, (audio, sr) in dataset:
        if np.abs(audio).max() > 1.0:
            raise ValueError(f"{utt_id} seems to be different from 16 bit "
                             "PCM.")
        if sr != fs:
            raise ValueError(f"{utt_id} sampling rate {sr} != config {fs}.")
        if config.get("trim_silence", False):
            audio, _ = trim_silence(
                audio,
                top_db=config.get("trim_threshold_in_db", 60),
                frame_length=config.get("trim_frame_size", 2048),
                hop_length=config.get("trim_hop_size", 512),
            )

        # the features at another rate than the audio
        fs_feats = config.get("sampling_rate_for_feats")
        if fs_feats is None:
            x, fs_feats, hop = audio, fs, hop_size
        else:
            if hop_size * fs_feats % fs != 0:
                raise ValueError("hop_size must be int after rescaling for "
                                 "dual sampling rate.")
            x = resample(audio, fs, fs_feats)
            hop = hop_size * fs_feats // fs
        mel = preprocess_log_mel(
            x, fs_feats, fft_size=config["fft_size"], hop_size=hop,
            win_length=config["win_length"], window=config["window"],
            num_mels=config["num_mels"], fmin=config["fmin"],
            fmax=config["fmax"], log_base=config.get("log_base", 10.0),
            device=args.device,
        )

        # the alignment invariant len(audio) == len(mel) * hop_size
        audio = np.pad(audio, (0, config["fft_size"]), mode="edge")
        audio = audio[: len(mel) * hop_size]
        assert len(mel) * hop_size == len(audio)

        f0 = None
        if args.use_f0 or config.get("use_f0", False):
            # the reference's contract: log-domain f0 (0 = unvoiced),
            # pitch_min from win_length, edge-padded to the mel's length
            f0 = log_f0(np.pad(audio, (0, hop_size * 2)), fs, hop_size,
                        frame_length=config.get("win_length") or None,
                        )[: len(mel)]
            f0 = np.pad(f0, (0, len(mel) - len(f0)), mode="edge")

        local = None
        if args.extract_f0:
            local = logf0_and_vuv(audio, fs, hop_size,
                                  pitch_min=config.get("pitch_min", 40),
                                  pitch_max=config.get("pitch_max", 500))
            if local is None:
                logging.warning(f"{utt_id} is all-unvoiced; skipped.")
                continue
            local = local[: len(mel)]
            local = np.pad(local, ((0, len(mel) - len(local)), (0, 0)),
                           mode="edge")

        excitation = None
        if config.get("use_excitation", False):
            if f0 is None:
                raise ValueError("use_excitation requires f0 (use_f0 or "
                                 "--use-f0)")
            excitation = make_excitation(f0, fs, hop_size, len(mel), utt_id,
                                         args.device)

        audio = audio * config.get("global_gain_scale", 1.0)
        if np.abs(audio).max() >= 1.0:
            logging.warning(f"{utt_id} causes clipping. It is better to "
                            "re-consider global gain scale.")
            continue

        arrays = {"wave": audio.astype(np.float32),
                  "feats": mel.astype(np.float32)}
        if config["format"] == "hdf5":
            if f0 is not None:
                arrays["f0"] = f0.astype(np.float32)
            if excitation is not None:
                arrays["excitation"] = excitation.astype(np.float32)
        if local is not None:
            arrays["local"] = local.astype(np.float32)
        if utt2idx is not None:
            arrays["global"] = np.array([utt2idx[utt_id]], dtype=np.int64)
        if config["format"] == "hdf5":
            path = os.path.join(args.dumpdir, f"{utt_id}.h5")
            for key, value in arrays.items():
                write_hdf5(path, key, value)
        else:
            for key, value in arrays.items():
                np.save(os.path.join(args.dumpdir, f"{utt_id}-{key}.npy"),
                        value, allow_pickle=False)


if __name__ == "__main__":
    main()
