#!/usr/bin/env python3
"""Write the per-utterance copy-synthesis reference that the port's GPU
smoke test reads: tests/data/torch_hifigan_quality_reference.json.

Decodes the evaluation mels of assets/quality/ with the JAX package's
``InferenceModel`` in float32 on the CPU, exactly as ``bench.py``'s quality
mode does (one bucketed ``synthesize_batch`` call), and scores every
utterance against its ground-truth waveform with the JAX package's
``ops/eval_metrics.py``: MCD (dB), log-F0 RMSE and V/UV error. No
accelerator is involved, so the file is a device-independent yardstick.

    python tests/make_torch_hifigan_quality_reference.py [--utts N]
"""

import argparse
import glob
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from parallelwavegan_tpu.engine.checkpoint import (  # noqa: E402
    load_generator_checkpoint,
)
from parallelwavegan_tpu.ops.eval_metrics import (  # noqa: E402
    log_f0_rmse,
    mel_cepstral_distortion,
)
from parallelwavegan_tpu.utils.io import load_config, read_wav  # noqa: E402
from parallelwavegan_tpu.utils.model_loader import (  # noqa: E402
    InferenceModel,
)


def utt_index(path: str) -> int:
    return int(os.path.basename(path)[len("eval_utt"):-len("-feats.npy")])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--utts", type=int, default=0,
                    help="score only the first N utterances (0 = all)")
    ap.add_argument("--out", default=os.path.join(
        REPO, "tests", "data", "torch_hifigan_quality_reference.json"))
    args = ap.parse_args()
    assets = os.path.join(REPO, "assets", "quality")
    cfg = load_config(os.path.join(assets, "config.yml"))
    model = InferenceModel(
        cfg, load_generator_checkpoint(os.path.join(assets,
                                                    "generator.gckpt")))
    # the order bench.py decodes in: sorted by file name
    files = sorted(glob.glob(os.path.join(assets, "*-feats.npy")))
    mels = [np.load(f) for f in files]
    waves = model.synthesize_batch(mels)
    sr = cfg["sampling_rate"]
    order = sorted(range(len(files)), key=lambda i: utt_index(files[i]))
    if args.utts:
        order = order[: args.utts]
    utts = {}
    for i in order:
        gt = read_wav(files[i].replace("-feats.npy", "-gt.wav"))[0]
        y = waves[i][:, 0]
        rmse, vuv = log_f0_rmse(y, gt, sr)
        name = os.path.basename(files[i])[: -len("-feats.npy")]
        utts[name] = {
            "frames": int(len(mels[i])),
            "mcd": float(mel_cepstral_distortion(y, gt, sr)),
            "log_f0_rmse": float(rmse),
            "vuv_error": float(vuv),
        }
        print(name, utts[name], flush=True)
    mean = {k: float(np.nanmean([u[k] for u in utts.values()]))
            for k in ("mcd", "log_f0_rmse", "vuv_error")}
    with open(args.out, "w") as f:
        json.dump({
            "what": "copy synthesis of assets/quality by the JAX package, "
                    "float32, CPU, one bucketed synthesize_batch call "
                    "(bucket 64) over all utterances",
            "sampling_rate": sr,
            "batch_files": [os.path.basename(f) for f in files],
            "utterances": utts,
            "mean": mean,
        }, f, indent=1)
        f.write("\n")
    print("mean", mean)


if __name__ == "__main__":
    main()
