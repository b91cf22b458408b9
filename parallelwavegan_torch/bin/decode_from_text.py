#!/usr/bin/env python3
"""Decode CLI for token text: each line ``<utt_id> <tok> <tok> ...`` of a
Kaldi-style text file goes through a discrete-symbol generator
(``DiscreteSymbol*``) and is written as ``<outdir>/<utt_id>_gen.wav``.

Counterpart of ``parallelwavegan_tpu/bin/decode_from_text.py``:
``--unique`` collapses runs of a repeated token (a duration generator
predicts the expansion back), ``--spk-idx`` appends the speaker id as the
second column (generators with ``num_spk_embs`` > 0). The ids reach the
generator as int64 (the JAX CLI passes them as float32, which its bf16
serving rounds above 256). Runs on CUDA by default (``--device cpu`` for
the host); the config is YAML (``config.yml`` beside the checkpoint by
default) or JSON:

    python -m parallelwavegan_torch.bin.decode_from_text --text text \
        --checkpoint exp/checkpoint-250000steps.pkl --config conf.json \
        --outdir wav [--unique] [--spk-idx 3] [--dtype bfloat16]
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from parallelwavegan_torch.utils.io import load_config, write_wav
from parallelwavegan_torch.utils.model_loader import load_model

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def token_lines(path: str, unique: bool = False,
                spk_idx: int = None) -> list:
    """[(utt_id, ids (T, 1|2) int64)] of a text file, as the CLI feeds
    them to the generator."""
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            utt_id, toks = line.strip().split(maxsplit=1)
            c = np.asarray(toks.split(), dtype=np.int64)
            if unique:
                c = c[np.concatenate([[True], c[1:] != c[:-1]])]
            c = c[:, None]
            if spk_idx is not None:
                c = np.concatenate([c, np.full_like(c, spk_idx)], axis=1)
            out.append((utt_id, c))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Decode discrete token sequences into waveforms.")
    parser.add_argument("--text", type=str, required=True)
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--config", default=None, type=str)
    parser.add_argument(
        "--spk-idx", default=None, type=int,
        help="speaker index appended as the second token column "
        "(models with num_spk_embs > 0)")
    parser.add_argument(
        "--unique", action="store_true",
        help="collapse consecutive repeated tokens before synthesis "
        "(duration models predict the expansion back)")
    parser.add_argument("--dtype", default="float32", choices=sorted(_DTYPES),
                        help="compute dtype for synthesis")
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="run on the GPU (default; fails without one) or the CPU")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    config = load_config(
        args.config
        or os.path.join(os.path.dirname(args.checkpoint), "config.yml"))
    gen_type = config.get("generator_type", "")
    if "DiscreteSymbol" not in gen_type:
        raise ValueError(f"decode_from_text requires a DiscreteSymbol* "
                         f"generator, got {gen_type}")
    model = load_model(args.checkpoint, config, dtype=_DTYPES[args.dtype],
                       device=args.device)
    sr = config.get("sampling_rate", 16000)
    os.makedirs(args.outdir, exist_ok=True)
    total_t = total_audio = 0.0
    lines = token_lines(args.text, args.unique, args.spk_idx)
    for utt_id, c in lines:
        start = time.perf_counter()
        y = model.inference(c)
        total_t += time.perf_counter() - start
        total_audio += len(y) / sr
        write_wav(os.path.join(args.outdir, f"{utt_id}_gen.wav"), y[:, 0], sr)
    logging.info(
        f"Finished generation of {len(lines)} utterances "
        f"(RTF = {total_t / max(total_audio, 1e-9):.06f}, first call "
        f"included).")


if __name__ == "__main__":
    main()
