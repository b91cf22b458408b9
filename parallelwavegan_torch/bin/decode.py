#!/usr/bin/env python3
"""Decode CLI: mel features -> waveforms with a trained generator of a
ported family (Parallel WaveGAN, HiFi-GAN, MelGAN, multi-band MelGAN,
StyleMelGAN and UHiFiGAN), token ids -> waveforms with a discrete-symbol
generator, or audio -> codes -> audio with a VQ-VAE.

Counterpart of the mel branches, the F0 and excitation branch and the
VQ-VAE branch of ``parallelwavegan_tpu/bin/decode.py``: bucketed batches,
or each utterance in overlapping windows (``--chunk-frames``), with the
int8 serving mode for HiFi-GAN. UHiFiGAN (and any family with ``--use-f0``)
decodes one utterance a call at its exact shape, its f0 and excitation read
beside each mel (hdf5 "f0" / "excitation", or ``-f0.npy`` /
``-excitation.npy`` beside ``-feats.npy``; a feats.scp carries neither and
is refused), through ``InferenceModel.inference``, which for UHiFiGAN
applies neither ``--normalize-before`` nor ``--pcm16``, as in the JAX
package. A discrete-symbol generator decodes one utterance a call too, the
``-feats.npy`` (or hdf5 "feats") holding its token ids; the F0 generator
reads the f0 beside them where its ``use_f0`` (default true) asks. A
VQ-VAE reads the audio dumps of ``--dumpdir``, encodes and decodes each
utterance and writes its codes to ``<outdir>/text`` (one line "utt code
code ..." each); a conditioned one reads its conditions from hdf5 dumps
("local", "global"), and over npy dumps it raises, where the JAX CLI
passes no condition and fails in the decoder. Runs on CUDA by default
(``--device cpu`` for the host):

    python -m parallelwavegan_torch.bin.decode \
        (--dumpdir dump | --feats-scp feats.scp) \
        --checkpoint exp/checkpoint-400000steps.pkl --config conf.yml \
        --outdir wav [--dtype bfloat16] [--chunk-frames 256] [--use-ema] \
        [--int8 [--int8-calib-utts 8] [--int8-schedule auto|all]]

``--checkpoint`` is a generator-only ``.gckpt``, a train-state ``.ckpt``
(``--use-ema`` then serves its EMA weights) or a reference PyTorch
``.pkl``. ``--feats-scp`` reads a Kaldi ark, hdf5 or npy feats.scp. The
config is YAML (``config.yml`` beside the checkpoint by default) or JSON.
The noise of Parallel WaveGAN and StyleMelGAN comes from a
``torch.Generator`` seeded 0 for each batch or utterance, as the JAX CLI
draws from ``jax.random.key(0)``.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from parallelwavegan_torch.datasets.audio_mel_dataset import (
    AudioDataset,
    MelDataset,
    MelF0Dataset,
    MelF0ExcitationDataset,
)
from parallelwavegan_torch.datasets.scp_dataset import MelSCPDataset
from parallelwavegan_torch.engine.step import uses_f0
from parallelwavegan_torch.models import DISCRETE_GENERATORS
from parallelwavegan_torch.utils.io import load_config, read_hdf5, write_wav
from parallelwavegan_torch.utils.model_loader import load_model

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Decode dumped features with a trained vocoder."
    )
    parser.add_argument("--feats-scp", "--scp", default=None, type=str)
    parser.add_argument("--dumpdir", default=None, type=str)
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--config", default=None, type=str)
    parser.add_argument("--stats", default=None, type=str)
    parser.add_argument("--normalize-before", action="store_true")
    parser.add_argument("--batch-size", default=8, type=int)
    parser.add_argument(
        "--chunk-frames", default=0, type=int,
        help="if > 0, synthesize each utterance in overlapping windows of "
        "this many mel frames and 64 frames of context on each side "
        "(bounded memory for long utterances; equal to the whole forward "
        "where the context covers the receptive field, see "
        "InferenceModel.inference_chunked)",
    )
    parser.add_argument("--use-f0", action="store_true",
                        help="read the per-frame f0 beside each mel")
    parser.add_argument(
        "--int8", action="store_true",
        help="int8-activation HiFi-GAN serving mode: calibrates "
        "per-channel activation scales on the first --int8-calib-utts "
        "mels, then runs the quantised convs with int8 activations and "
        "weights",
    )
    parser.add_argument(
        "--int8-calib-utts", default=8, type=int,
        help="number of utterances used for int8 calibration",
    )
    parser.add_argument(
        "--int8-schedule", default="auto", choices=["auto", "all"],
        help="'auto' (default): int8 on the wide (C >= 128) MRF stages and "
        "every upsampling conv, the compute dtype on the narrow stages; "
        "'all': quantise every calibrated conv",
    )
    parser.add_argument(
        "--dtype", default="float32", choices=sorted(_DTYPES),
        help="compute dtype for synthesis",
    )
    parser.add_argument(
        "--pcm16", action="store_true",
        help="convert the waveform to 16-bit PCM on the device",
    )
    parser.add_argument(
        "--use-ema", action="store_true",
        help="serve the EMA generator weights from a .ckpt trained with "
        "generator_ema_decay",
    )
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="run on the GPU (default; fails without one) or the CPU",
    )
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    if (args.feats_scp is None) == (args.dumpdir is None):
        raise ValueError("Please specify either --dumpdir or --feats-scp.")
    if args.normalize_before and args.stats is None:
        raise ValueError("--normalize-before requires --stats.")

    config = load_config(
        args.config
        or os.path.join(os.path.dirname(args.checkpoint), "config.yml")
    )
    gen_type = config.get("generator_type", "ParallelWaveGANGenerator")
    # fail fast, before the dataset is read and the model is built
    if args.int8:
        if gen_type != "HiFiGANGenerator":
            parser.error(
                f"--int8 supports HiFiGANGenerator checkpoints only "
                f"(got {gen_type})"
            )
        if config.get("generator_params", {}).get("out_channels", 1) != 1:
            parser.error(
                "--int8 does not support multi-band (PQMF) generators"
            )
        if args.int8_calib_utts < 1:
            parser.error("--int8-calib-utts must be >= 1")
    if gen_type == "VQVAE":
        return _decode_vq(args, config)
    use_excitation = gen_type == "UHiFiGANGenerator"
    # the flag sets use_f0, as in bin/train (the JAX CLI reads no use_f0
    # key from the config here)
    use_f0 = uses_f0(dict(config, use_f0=args.use_f0))
    single = use_f0 or use_excitation or gen_type in DISCRETE_GENERATORS
    hdf5 = config.get("format", "hdf5") == "hdf5"

    def side(name: str):
        if hdf5:
            return lambda f: read_hdf5(f, name)
        return lambda f: np.load(f.replace("-feats.npy", f"-{name}.npy"))

    mel_kw = (dict(mel_query="*.h5", mel_load_fn=side("feats")) if hdf5
              else dict(mel_query="*-feats.npy", mel_load_fn=np.load))
    if args.feats_scp is not None:
        if use_f0 or use_excitation:
            raise ValueError(
                "SCP format is not supported for f0 and excitation.")
        dataset = MelSCPDataset(args.feats_scp, return_utt_id=True)
    elif use_excitation:
        dataset = MelF0ExcitationDataset(
            args.dumpdir, f0_load_fn=side("f0"),
            excitation_load_fn=side("excitation"), return_utt_id=True,
            **mel_kw)
    elif use_f0:
        dataset = MelF0Dataset(args.dumpdir, f0_load_fn=side("f0"),
                               return_utt_id=True, **mel_kw)
    else:
        dataset = MelDataset(args.dumpdir, return_utt_id=True, **mel_kw)
    logging.info(f"The number of features to be decoded = {len(dataset)}.")

    model = load_model(args.checkpoint, config, stats=args.stats,
                       dtype=_DTYPES[args.dtype], pcm16=args.pcm16,
                       device=args.device, use_ema=args.use_ema)
    sr = config.get("sampling_rate", 22050)
    os.makedirs(args.outdir, exist_ok=True)
    items = [dataset[i] for i in range(len(dataset))]
    if args.int8:
        if not items:
            raise ValueError(
                "--int8 calibration needs at least one utterance, but the "
                "dataset is empty"
            )
        calib = []
        for item in items[: args.int8_calib_utts]:
            c = item[1]
            if args.normalize_before:
                c = (c - model.mean) / model.scale
            calib.append(np.asarray(c, np.float32))
        logging.info(
            f"Calibrating int8 activation scales on {len(calib)} utterances "
            f"(schedule={args.int8_schedule})."
        )
        model.quantize_int8(calib, schedule=args.int8_schedule)
    total_t = total_audio = 0.0
    if single:
        # one utterance a call at its exact shape: (utt, mel[, f0[,
        # excitation]]) items
        for utt_id, c, *rest in items:
            start = time.perf_counter()
            w = model.inference(c, normalize_before=args.normalize_before,
                                f0=rest[0] if rest else None,
                                excitation=rest[1] if len(rest) > 1
                                else None)
            total_t += time.perf_counter() - start
            total_audio += len(w) / sr
            write_wav(os.path.join(args.outdir, f"{utt_id}_gen.wav"),
                      w[:, 0], sr)
    batched = [] if single else items
    step = 1 if args.chunk_frames > 0 else args.batch_size
    for i in range(0, len(batched), step):
        chunk = batched[i : i + step]
        start = time.perf_counter()
        if args.chunk_frames > 0:
            waves = [model.inference_chunked(
                chunk[0][1], chunk_frames=args.chunk_frames,
                normalize_before=args.normalize_before)]
        else:
            waves = model.synthesize_batch(
                [m for _, m in chunk], normalize_before=args.normalize_before
            )
        total_t += time.perf_counter() - start
        total_audio += sum(len(w) for w in waves) / sr
        for (utt_id, _), w in zip(chunk, waves):
            write_wav(os.path.join(args.outdir, f"{utt_id}_gen.wav"),
                      w[:, 0], sr)
    logging.info(
        f"Finished generation of {len(items)} utterances "
        f"(RTF = {total_t / max(total_audio, 1e-9):.06f}, first call "
        f"included)."
    )


def _decode_vq(args, config) -> None:
    """The VQ-VAE branch: each utterance's audio through ``vq_encode`` and
    ``vq_decode``, ``<utt>_gen.wav`` and a line of ``text`` each."""
    hdf5 = config.get("format", "hdf5") == "hdf5"
    conditioned = [k for k in ("use_local_condition", "use_global_condition")
                   if config.get(k, False)]
    if args.feats_scp is not None:
        raise ValueError("a VQVAE decodes audio dumps (--dumpdir), not "
                         "--feats-scp")
    if conditioned and not hdf5:
        raise ValueError(
            f"a VQVAE with {' and '.join(conditioned)} reads its conditions "
            "from hdf5 dumps; npy dumps give it none")
    if hdf5:
        dataset = AudioDataset(args.dumpdir, "*.h5",
                               lambda f: read_hdf5(f, "wave"),
                               return_utt_id=True)
    else:
        dataset = AudioDataset(args.dumpdir, "*-wave.npy", np.load,
                               return_utt_id=True)
    logging.info(f"The number of utterances to be decoded = {len(dataset)}.")
    model = load_model(args.checkpoint, config, dtype=_DTYPES[args.dtype],
                       device=args.device, use_ema=args.use_ema)
    sr = config.get("sampling_rate", 22050)
    os.makedirs(args.outdir, exist_ok=True)
    lines = []
    total_t = total_audio = 0.0
    for i in range(len(dataset)):
        utt_id, audio = dataset[i]
        path = dataset.audio_files[i]
        l = g = None
        if config.get("use_local_condition", False):
            l = read_hdf5(path, "local")
        if config.get("use_global_condition", False):
            g = read_hdf5(path, "global").reshape(-1)[0]
        start = time.perf_counter()
        indices = model.vq_encode(audio)
        y = model.vq_decode(indices, l=l, g=g)
        total_t += time.perf_counter() - start
        total_audio += len(y) / sr
        write_wav(os.path.join(args.outdir, f"{utt_id}_gen.wav"), y[:, 0], sr)
        lines.append(utt_id + " " + " ".join(map(str, indices.tolist())))
    with open(os.path.join(args.outdir, "text"), "w") as f:
        f.write("\n".join(lines) + "\n")
    logging.info(
        f"Finished generation of {len(lines)} utterances "
        f"(RTF = {total_t / max(total_audio, 1e-9):.06f}, first call "
        f"included).")


if __name__ == "__main__":
    main()
