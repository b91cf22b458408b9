"""Where a cell's traced stretch goes, by the program's own spans: for each
span name, its count, its time, its self time (less its children's) and
the card's idle time under it, per traced step or call. One JSON line a
seed.

    python3 portbench/tools/phases.py --workload <cell> --seeds 1,2 \
        --seconds 10 [--out <file.jsonl>]

It runs the cell as ``run.py --trace 1`` does (set-up, warm-up, the window
with its last 30 % profiled) without the check. A program without spans
gives the stretch and its rate alone.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def breakdown(run: dict, top: str) -> dict:
    from portbench.core import program
    from portbench.core.trace import clip, covered, union

    tr = run["trace"]
    tops = [(s, e) for name, s, e in tr.spans if name == top]
    out = {"stretch_s": tr.window_s, "busy_s": tr.busy_s, "tops": len(tops),
           "tops_per_s": len(tops) / tr.window_s if tr.window_s else None}
    p = program.align(run, top)
    if p is None:
        return out
    n = len(p.tops)
    children = defaultdict(list)
    for s in p.spans:
        children[s.parent].append(s)
    rows: dict = defaultdict(lambda: defaultdict(float))
    for s in p.spans:
        (lo, hi), = clip([(s.start, s.end)], tr.start, tr.end)
        kids = union(clip([(c.start, c.end) for c in children[s.index]],
                          lo, hi))
        row = rows[s.name]
        row["count"] += 1 / n
        row["ms"] += 1e3 * (hi - lo) / n
        row["self_ms"] += 1e3 * (hi - lo - covered(kids)) / n
        row["idle_ms"] += 1e3 * (hi - lo - covered(clip(tr.busy, lo, hi))) / n
    out.update(offset_s=p.offset, idle_s=tr.window_s - tr.busy_s,
               per=top, spans={k: dict(v) for k, v in sorted(rows.items())})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from portbench.core import env

    env.pin_caches(ROOT)
    import torch

    from portbench.core import manifest as mf
    from portbench.core.cell import _drive

    if not torch.cuda.is_available():
        print("phases: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = mf.Manifest(ROOT).cell(args.workload)
    config, traffic = mf.config(cell["config"]), mf.traffic(cell["traffic"])
    top = "step" if traffic["kind"] == "train" else "call"
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        job, window, _ = _drive(ROOT, config, traffic, seed, args.seconds,
                                True, "cuda", {})
        try:
            row = {"workload": cell["name"], "seed": seed,
                   "card": env.power_limit(),
                   **breakdown({"trace": window["trace"]}, top)}
            try:
                from parallelwavegan_torch.utils import tracing
            except ImportError:
                pass
            else:
                row["counters"] = tracing.counters()
                tracing.clear()
        finally:
            job.close()
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
        del job, window
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
