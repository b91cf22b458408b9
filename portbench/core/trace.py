"""The traced stretch: ``torch.profiler`` over a few calls or steps inside
the window, reduced to intervals on one clock.

The harness opens its own spans (``torch.profiler.record_function``
ranges named ``portbench.<label>``) around the calls into each layer; they
land in the trace beside the device's kernels, copies and memsets. What
the per-layer metrics read from here: the union of the device intervals
(busy time, idle share), device time by kernel name, each span's time with
no device work under it, and the idle gaps labelled by the innermost span
open at the time.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "portbench."

Interval = Tuple[float, float]


def span(label: str):
    """A harness span: a profiler range when a trace is open, else
    nothing."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(SPAN + label)
    return contextlib.nullcontext()


def union(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def clip(intervals: Sequence[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def covered(intervals: Sequence[Interval]) -> float:
    return sum(e - s for s, e in intervals)


class Trace:
    """One profiled stretch, times in seconds on the profiler's clock."""

    def __init__(self, events: List[dict]):
        self.device: List[Tuple[str, float, float]] = []
        self.spans: List[Tuple[str, float, float]] = []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            s = float(ev["ts"]) * 1e-6
            e = s + float(ev["dur"]) * 1e-6
            if ev.get("cat") in DEVICE_CATS:
                self.device.append((ev["name"], s, e))
            elif ev.get("cat") == "user_annotation" \
                    and ev["name"].startswith(SPAN):
                self.spans.append((ev["name"][len(SPAN):], s, e))
        self.busy = union([(s, e) for _, s, e in self.device])
        tops = [(s, e) for name, s, e in self.spans if name in TOP_SPANS]
        if tops:
            self.start = min(s for s, _ in tops)
            self.end = max(e for _, e in tops)
        elif self.busy:
            self.start, self.end = self.busy[0][0], self.busy[-1][1]
        else:
            self.start = self.end = 0.0

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return covered(clip(self.busy, self.start, self.end))

    def kernel_seconds(self, pattern: str) -> float:
        """Device time of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for name, s, e in self.device
                   if rx.search(name) and e > self.start and s < self.end)

    def exposed(self, label: str) -> List[float]:
        """Per span ``label``: its seconds with no device work under it."""
        return [(e - s) - covered(clip(self.busy, s, e))
                for name, s, e in self.spans if name == label]

    def top_ops(self, n: int = 10) -> List[list]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            lo, hi = max(s, self.start), min(e, self.end)
            if hi > lo:
                by_name[name] += hi - lo
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], sec] for name, sec in ranked]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest stretches with no device work, each named by the
        innermost harness span open at its middle."""
        gaps, t = [], self.start
        for s, e in clip(self.busy, self.start, self.end):
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = 0.5 * (s + e)
            open_spans = [(ss, name) for name, ss, ee in self.spans
                          if ss <= mid <= ee]
            label = max(open_spans)[1] if open_spans else "between"
            out.append([label, e - s])
        return out


# spans that bound the stretch: one call or one step of the driver
TOP_SPANS = ("call", "loader_next", "step", "sync")


class Profiler:
    """``torch.profiler`` on the CPU and the card, started inside the
    window and stopped (and its trace reduced) after the window has
    closed, so that neither the stop nor the reduction is timed."""

    def __init__(self):
        self.prof = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()

    def stop(self) -> Trace:
        prof, self.prof = self.prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        return Trace(events)
