#!/usr/bin/env python3
"""Evaluate log-F0 RMSE, V/UV error and semitone accuracy between
generated and ground-truth wavs (host only).

Counterpart of ``parallelwavegan_tpu/bin/evaluate_f0.py``: the pairs of
``bin/evaluate_mcd`` scored by ``ops/eval_metrics.log_f0_rmse`` and
``semitone_accuracy`` in ``--n-jobs`` processes, written to
``<outdir>/utt2logf0rmse`` ("utt rmse vuv semitone"); the mean RMSE over
the utterances that have co-voiced frames is printed:

    python -m parallelwavegan_torch.bin.evaluate_f0 --outdir wav \
        --gt-wavdir data/wavs --n-jobs 8
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional

import numpy as np

from parallelwavegan_torch.bin.evaluate_mcd import pair_wavs, score_pairs
from parallelwavegan_torch.ops.eval_metrics import (
    log_f0_rmse,
    semitone_accuracy,
)
from parallelwavegan_torch.utils.io import read_wav


def _one(pair):
    gen_path, gt_path = pair
    gen, fs = read_wav(gen_path)
    gt, _ = read_wav(gt_path)
    utt_id = os.path.basename(gen_path).replace("_gen.wav", "")
    rmse, vuv = log_f0_rmse(gen, gt, fs)
    return utt_id, rmse, vuv, semitone_accuracy(gen, gt, fs)


def main(argv: Optional[list] = None) -> tuple:
    parser = argparse.ArgumentParser(description="Evaluate log-F0 RMSE.")
    parser.add_argument("--outdir", "--wavdir", dest="gen_wavdir", type=str,
                        required=True)
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
    with open(os.path.join(args.gen_wavdir, "utt2logf0rmse"), "w") as f:
        for utt, rmse, vuv, semi in results:
            f.write(f"{utt} {rmse:.4f} {vuv:.4f} {semi:.4f}\n")
    rmses = np.array([r for _, r, _, _ in results])
    vuvs = np.array([v for _, _, v, _ in results])
    # a pair with no co-voiced frames has no RMSE (nan): report n/a when
    # none has one
    valid = rmses[~np.isnan(rmses)]
    mean_rmse = (f"{valid.mean():.4f}" if valid.size
                 else "n/a (no voiced overlap)")
    logging.info(f"Mean log-F0 RMSE: {mean_rmse}; V/UV error: "
                 f"{vuvs.mean():.4f}")
    print(f"Mean log-F0 RMSE: {mean_rmse}")
    return (float(valid.mean()) if valid.size else float("nan"),
            float(vuvs.mean()))


if __name__ == "__main__":
    main()
