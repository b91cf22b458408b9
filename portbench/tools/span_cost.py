"""What one of the program's spans costs the host, in ns: with tracing off
(no profiler), and on (under ``torch.profiler`` with the CPU and, on a
card, the CUDA activities), each less an empty loop's turn; and one
transfer count. One JSON line.

    python3 portbench/tools/span_cost.py [--off 1000000] [--on 20000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def per_turn_ns(body, n: int) -> float:
    """ns a turn of ``body(n)``, the best of three."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter_ns()
        body(n)
        best = min(best, (time.perf_counter_ns() - t) / n)
    return best


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--off", type=int, default=1_000_000)
    parser.add_argument("--on", type=int, default=20_000)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.core import env
    from parallelwavegan_torch.utils import tracing

    def empty(n):
        for _ in range(n):
            pass

    def spans(n):
        for _ in range(n):
            with tracing.span("x"):
                pass

    host = torch.ones(1024)
    device = "cuda" if torch.cuda.is_available() else "meta"

    def counts(n):
        for _ in range(n):
            tracing.count_transfer(host, device)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    loop_off = per_turn_ns(empty, args.off)
    off = per_turn_ns(spans, args.off) - loop_off
    count = per_turn_ns(counts, args.off // 10) - loop_off
    with profile(activities=activities):
        loop_on = per_turn_ns(empty, args.on)
        on = per_turn_ns(spans, args.on) - loop_on
    tracing.clear()
    print(json.dumps({
        "span_off_ns": off, "span_on_ns": on, "count_transfer_ns": count,
        "loop_ns": loop_off, "activities": [a.name for a in activities],
        "card": env.power_limit() if torch.cuda.is_available() else None,
        "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
