#!/usr/bin/env python3
"""Evaluate the mel-cepstral distortion between generated and ground-truth
wavs (host only).

Counterpart of ``parallelwavegan_tpu/bin/evaluate_mcd.py``: each
``<utt>_gen.wav`` of ``--outdir`` is paired with ``<utt>.wav`` under
``--gt-wavdir``, scored by ``ops/eval_metrics.mel_cepstral_distortion`` in
``--n-jobs`` processes, and written to ``<outdir>/utt2mcd`` with the mean
printed:

    python -m parallelwavegan_torch.bin.evaluate_mcd --outdir wav \
        --gt-wavdir data/wavs --n-jobs 8
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing
import os
import sys
from typing import Callable, List, Optional, Tuple

import numpy as np

from parallelwavegan_torch.ops.eval_metrics import mel_cepstral_distortion
from parallelwavegan_torch.utils.io import find_files, read_wav


def pair_wavs(gen_wavdir: str, gt_wavdir: str) -> List[Tuple[str, str]]:
    """(generated, ground truth) paths by utterance id; a generated wav
    without its ground truth is skipped with a warning."""
    gt_index = {os.path.splitext(os.path.basename(f))[0]: f
                for f in find_files(gt_wavdir, "*.wav")}
    pairs = []
    for g in find_files(gen_wavdir, "*_gen.wav"):
        utt = os.path.basename(g).replace("_gen.wav", "")
        if utt in gt_index:
            pairs.append((g, gt_index[utt]))
        else:
            logging.warning(f"no ground truth for {utt}; skipped.")
    if not pairs:
        raise ValueError("no (generated, ground-truth) pairs found")
    return pairs


def score_pairs(score: Callable, pairs: list, n_jobs: int) -> list:
    """``score`` of each pair, in ``n_jobs`` spawned processes when more
    than one, sorted by the result's first field (the utterance id)."""
    if n_jobs > 1:
        context = multiprocessing.get_context("spawn")
        with context.Pool(min(n_jobs, len(pairs))) as pool:
            results = pool.map(score, pairs)
    else:
        results = [score(p) for p in pairs]
    return sorted(results, key=lambda r: r[0])


def _one(pair):
    gen_path, gt_path = pair
    gen, fs_g = read_wav(gen_path)
    gt, fs_r = read_wav(gt_path)
    if fs_g != fs_r:
        raise ValueError(f"fs mismatch: {gen_path} vs {gt_path}")
    utt_id = os.path.basename(gen_path).replace("_gen.wav", "")
    return utt_id, mel_cepstral_distortion(gen, gt, fs_g)


def main(argv: Optional[list] = None) -> float:
    parser = argparse.ArgumentParser(description="Evaluate MCD.")
    parser.add_argument("--outdir", "--wavdir", dest="gen_wavdir", type=str,
                        required=True, help="dir with *_gen.wav")
    parser.add_argument("--gt-wavdir", type=str, required=True)
    parser.add_argument("--n-jobs", type=int, default=8)
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARN,
        stream=sys.stdout,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    results = score_pairs(_one, pair_wavs(args.gen_wavdir, args.gt_wavdir),
                          args.n_jobs)
    mcds = np.array([m for _, m in results])
    with open(os.path.join(args.gen_wavdir, "utt2mcd"), "w") as f:
        for utt, m in results:
            f.write(f"{utt} {m:.4f}\n")
    logging.info(f"Mean MCD: {mcds.mean():.4f} +- {mcds.std():.4f}")
    print(f"Mean MCD: {mcds.mean():.4f}")
    return float(mcds.mean())


if __name__ == "__main__":
    main()
