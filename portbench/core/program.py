"""The program's own spans, on the traced stretch's clock.

The port records spans in memory while a profiler records
(``parallelwavegan_torch/utils/tracing.py``: name, start and end on
``time.perf_counter_ns()``, parent, request, thread). After the window, in
the same process, ``align`` takes those records, matches the harness's
traced top spans (``step`` or ``call``) in order with the program's last
``train.step`` or ``serve.call`` records of the same count, and puts every
record on the Trace's clock with the median offset between the starts of
the pairs. The harness's span wraps the program's call directly, so the
error is a few microseconds against gaps of milliseconds. It returns None
where there is no trace, where the program records no spans (a program
without them), or where the pairs do not match.

The readers below are the per-layer metrics that read the program's
spans; each returns None where ``align`` does.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional

from portbench.core.trace import Trace, clip, covered, union

# the harness's top span -> the program's span directly inside it
TOPS = {"step": "train.step", "call": "serve.call"}
# how far an aligned program top may reach past its harness span
SLACK_S = 1e-3


@dataclass(frozen=True)
class Span:
    """One program record on the Trace's clock, in seconds."""

    name: str
    start: float
    end: float
    index: int
    parent: Optional[int]
    request: Optional[int]
    thread: int


@dataclass
class Program:
    """The records that overlap the traced stretch, the program's tops
    matched to the harness's, the offset (Trace's clock minus
    ``perf_counter``, s) and the Trace."""

    spans: List[Span]
    tops: List[Span]
    offset: float
    trace: Trace

    def named(self, name: str, thread: Optional[int] = None) -> List[Span]:
        return [s for s in self.spans if s.name == name
                and (thread is None or s.thread == thread)]

    def clipped(self, spans: List[Span]) -> List[tuple]:
        return clip([(s.start, s.end) for s in spans], self.trace.start,
                    self.trace.end)


def program_records():
    """The program's records, or None where the program has no tracing
    module."""
    try:
        from parallelwavegan_torch.utils import tracing
    except ImportError:
        return None
    return tracing.records()


def align(run: dict, top: str) -> Optional[Program]:
    tr = run.get("trace")
    if tr is None:
        return None
    records = program_records()
    if not records:
        return None
    harness = sorted((s, e) for name, s, e in tr.spans if name == top)
    mine = [r for r in records if r.name == TOPS[top]]
    n = len(harness)
    if n == 0 or len(mine) < n:
        return None
    mine = mine[-n:]
    offset = statistics.median(h[0] - r.start_ns * 1e-9
                               for h, r in zip(harness, mine))

    def on_trace(r) -> Span:
        return Span(r.name, r.start_ns * 1e-9 + offset,
                    r.end_ns * 1e-9 + offset, r.index, r.parent, r.request,
                    r.thread)

    tops = [on_trace(r) for r in mine]
    for (hs, he), t in zip(harness, tops):
        if t.start < hs - SLACK_S or t.end > he + SLACK_S:
            return None
    spans = [s for s in map(on_trace, records)
             if s.end > tr.start and s.start < tr.end]
    return Program(spans, tops, offset, tr)


def _dispatch(p: Program) -> List[tuple]:
    """The union of the step's phases on the step's thread, clipped."""
    thread = p.tops[0].thread
    return union(p.clipped([s for s in p.spans if s.thread == thread
                            and s.name.startswith("step.")]))


def dispatch_ms(run: dict) -> Optional[float]:
    p = align(run, "step")
    if p is None:
        return None
    return 1e3 * covered(_dispatch(p)) / len(p.tops)


def idle_in_dispatch_pct(run: dict) -> Optional[float]:
    p = align(run, "step")
    if p is None:
        return None
    tr = p.trace
    idle = tr.window_s - tr.busy_s
    if idle <= 0:
        return None
    under = sum((e - s) - covered(clip(tr.busy, s, e))
                for s, e in _dispatch(p))
    return 100.0 * under / idle


def per_step_ms(run: dict, name: str, main_thread: bool) -> Optional[float]:
    """The clipped time of the spans ``name`` (on the step's thread only,
    or on any) per traced step, in ms."""
    p = align(run, "step")
    if p is None:
        return None
    thread = p.tops[0].thread if main_thread else None
    return 1e3 * covered(p.clipped(p.named(name, thread))) / len(p.tops)


def collate_ms(run: dict) -> Optional[float]:
    """Mean ms of the ``data.collate`` spans that closed in the stretch."""
    p = align(run, "step")
    if p is None:
        return None
    tr = p.trace
    done = [s.end - s.start for s in p.named("data.collate")
            if tr.start <= s.end <= tr.end]
    return 1e3 * sum(done) / len(done) if done else None


def prepare_ms(run: dict) -> Optional[float]:
    """Mean over the traced calls of the ``serve.prepare`` time inside
    each, in ms."""
    p = align(run, "call")
    if p is None:
        return None
    per_call: Dict[int, float] = {t.index: 0.0 for t in p.tops}
    for s in p.named("serve.prepare"):
        if s.parent in per_call:
            per_call[s.parent] += s.end - s.start
    return 1e3 * sum(per_call.values()) / len(per_call)
