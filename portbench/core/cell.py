"""One run of one cell: set-up, the measured window, the check, the
metrics."""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from portbench.core import manifest as mf
from portbench.core.serve import Serving
from portbench.core.trace import Profiler
from portbench.core.train import WARM_STEPS, Training


@dataclass
class Outcome:
    """A run's result line (``result``), each number compared beside its
    limit (``checks``), and, where the caller keeps them, the job with
    what its check kept (readings compare a control and faults on them)."""

    result: Dict[str, Any]
    checks: Dict[str, Tuple[float, float]]
    job: Optional[Any] = None
    kept: Optional[Any] = None


def _warm_profiler(work) -> None:
    """One profiled unit of work in set-up: the profiler's first start in
    a process (CUPTI's) is slow, and would otherwise fall in the window."""
    prof = Profiler()
    prof.start()
    work()
    prof.stop()


def _drive(root: str, config: dict, traffic: dict, seed: int,
           seconds: float, trace: bool, device: str,
           clock: Dict[str, float]):
    """Set-up, warm-up and the window; the program freed. Returns (job,
    window, what the check kept)."""
    if device == "cuda":
        from parallelwavegan_torch.ops.cuda.build import build_libraries

        t = time.perf_counter()
        build_libraries(config["portbench"]["libraries"][traffic["kind"]])
        clock["compile"] = time.perf_counter() - t

    if traffic["kind"] == "train":
        job = Training(root, config, traffic, seed, device, clock)
        try:
            t = time.perf_counter()
            kept = job.check_steps()
            if trace:
                _warm_profiler(lambda: job.warm_up(1))
            job.warm_up(WARM_STEPS)  # also times a step
            clock["warmup"] = time.perf_counter() - t
            gc.collect()
            window = job.window(seconds, trace)
            job.free_program()
        except BaseException:
            job.close()
            raise
        window.update(batch=config["batch_size"],
                      samples=config["batch_max_steps"])
        return job, window, kept
    job = Serving(root, config, traffic, seed, device, clock)
    t = time.perf_counter()
    call_seconds = job.warm_up()
    if trace:
        _warm_profiler(lambda: job.call(0))
    clock["warmup"] = time.perf_counter() - t
    gc.collect()
    window = job.window(seconds, trace, call_seconds)
    job.free_program()
    return job, window, window["kept"]


def run_cell(root: str, cell: dict, metrics: list, seed: int,
             seconds: float, trace: bool, device: str, t_start: float,
             clock: Dict[str, float], keep: bool = False) -> Outcome:
    """The run's outcome; with ``keep``, the job is left open in it (the
    caller closes it)."""
    config = mf.config(cell["config"])
    traffic = mf.traffic(cell["traffic"])
    # float32 means float32: no TF32 in cuBLAS or cuDNN, which PyTorch
    # would otherwise allow in cuDNN's convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    job, window, kept = _drive(root, config, traffic, seed, seconds, trace,
                               device, clock)
    try:
        numbers = job.check(kept)
    finally:
        if not keep:
            job.close()

    run = dict(window, config=config, traffic=traffic, cell=cell,
               setup_s=window["t0"] - t_start,
               seconds=window["t1"] - window["t0"],
               trace=window.get("trace"))
    values = {}
    for m in metrics:
        value = mf.read_metric(m["name"], run)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = mf.limits(cell["name"])
    checks = {k: (float(numbers[k]), float(limits[k])) for k in limits}
    correct = window["failed"] == 0 and all(v <= lim for v, lim in
                                            checks.values())
    result: Dict[str, Any] = {
        "correct": bool(correct),
        "attempted": int(window["attempted"]),
        "failed": int(window["failed"]),
        "metrics": values,
        "device": {"memory_peak_bytes": int(window["memory_peak"])},
    }
    tr = run["trace"]
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    if keep:
        return Outcome(result, checks, job, kept)
    return Outcome(result, checks)
