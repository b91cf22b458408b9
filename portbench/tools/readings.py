"""The readings that a cell's correctness limits are set from, in one
process: for each seed a run of the cell as ``run.py`` makes it
(``run_cell``: set-up, the window, the check; the program's reading), and
for the control seeds, on what that run's check kept, the control's
reading, the reference's stand-in at the precision below the
configuration's, judged the same way:

- float32 serving: the reference with TF32 on in cuBLAS and cuDNN;
- bfloat16 serving with the MRF kernel: the program with its int8 packs
  (``use_mrf_kernel(quant=True)``) over the same calls;
- float32 training: the reference's steps with TF32 on, and the fault
  "half of the batch left out, the mean over the rest" planted in the
  reference put in the program's place.

    python3 portbench/tools/readings.py --workload <cell> \
        --seeds 1,2,3 --control-seeds 1,2,3 --seconds 10 --out <file.json>
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def serving_controls(job, kept) -> dict:
    from portbench.core.lengths import Assets
    from portbench.core.serve import build_model, compare_waves, \
        reference_waves

    items = kept.items()
    want = reference_waves(job, items)
    serving = job.traffic["serving"]
    if serving["dtype"] == "float32":
        return {"control": compare_waves(
                    reference_waves(job, items, tf32=True), want),
                "control_is": "the reference with TF32 on"}
    calib = Assets(ROOT).mels[:8]
    job.model = build_model(ROOT, job.config, dict(
        serving, mrf_kernel="int8", calib_mels=calib), job.tree, job.device)
    waves = {}
    for call in sorted({it["call"] for it in items}):
        for j, w in enumerate(job.call(call)):
            waves[(call, j)] = w
    job.free_program()
    return {"control": compare_waves(
                [waves[(it["call"], it["index"])] for it in items], want),
            "control_is": "the program with its int8 MRF packs"}


def training_controls(job, kept) -> dict:
    from portbench.core.train import compare_training, reference_follow

    batches = kept["batches"]
    want = reference_follow(job, batches)
    half = len(batches[0]["y"]) // 2
    return {"control": compare_training(
                reference_follow(job, batches, tf32=True), want),
            "control_is": "the reference's steps with TF32 on",
            "fault_half_batch": compare_training(
                reference_follow(job, batches, rows=slice(0, half)), want)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from portbench.core import env

    env.pin_caches(ROOT)
    import torch

    from portbench.core import manifest as mf
    from portbench.core.cell import run_cell

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    manifest = mf.Manifest(ROOT)
    cell = manifest.cell(args.workload)
    metrics = manifest.metrics(cell["name"], False)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        outcome = run_cell(ROOT, cell, metrics, seed, args.seconds, False,
                           "cuda", t, {}, keep=True)
        job, kept = outcome.job, outcome.kept
        try:
            row = {"seed": seed, "correct": outcome.result["correct"],
                   "program": {k: v for k, (v, _) in
                               outcome.checks.items()},
                   "metrics": {k: m["value"] for k, m in
                               outcome.result["metrics"].items()}}
            if seed in controls:
                row.update(training_controls(job, kept)
                           if job.traffic["kind"] == "train"
                           else serving_controls(job, kept))
        finally:
            job.close()
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
        del job, kept, outcome
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"workload": args.workload, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
