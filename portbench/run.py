"""Run one cell of ``BENCHMARK.json`` once on the port and print one
result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds the port
(``parallelwavegan_torch``). With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profiled stretch inside the window. The set-up's split goes to
standard error; then each number the check compared, beside its limit, as
the last lines there; then the result as the last line of standard output.
Exits non-zero with no result when the card is missing, or when the JAX
package or JAX was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, ROOT)
    from portbench.core import env

    env.pin_caches(ROOT)
    clock = {}
    t = time.perf_counter()
    import torch

    from portbench.core.cell import run_cell
    from portbench.core.manifest import Manifest

    clock["import"] = time.perf_counter() - t
    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA device(s) needed, {found} "
              "found", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    outcome = run_cell(ROOT, cell, manifest.metrics(
        cell["name"], bool(args.trace)), args.seed, args.seconds,
        bool(args.trace), "cuda", T_START, clock)
    result, checks = outcome.result, outcome.checks
    banned = env.banned_modules()
    if banned:
        print(f"portbench: loaded {', '.join(banned)}", file=sys.stderr)
        return 3
    result["device"] = {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cell["chips"], **result["device"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    print("portbench: card " + env.power_limit(), file=sys.stderr)
    print("portbench: set-up " + ", ".join(
        f"{k} {v:.3f} s" for k, v in clock.items()), file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
