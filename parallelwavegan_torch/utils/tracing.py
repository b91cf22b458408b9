"""Spans and counters at the port's layer boundaries.

Tracing is on exactly while a ``torch.profiler`` records in this process:
the trainer's ``profile_dir`` window, or any profiler a caller opens. There
is no setting of its own.

``span(name, request=None)`` is a context manager. While tracing is off it
is one shared null context: no allocation, no clock read, no record. While
it is on, it opens a ``torch.profiler.record_function`` range (so the span
lands in the Chrome trace on the profiler's clock, beside the kernels) and
appends a ``Record`` to a bounded in-memory ring (``RING`` entries) when it
closes: its name, its start and end on ``time.perf_counter_ns()``, the
index of its parent (the innermost span open on the same thread), its
request id (the step, the serving call or the batch number; the parent's
where none is given) and its thread. ``records()`` returns the ring,
``clear()`` empties it and zeroes the counters.

The counters (``counters()`` returns a copy): ``h2d_bytes``,
``h2d_copies``, ``d2h_bytes`` and ``d2h_copies`` count the program's own
transfers between the host and a device (the trainer's batch, the serving
API's mels and noise, its readback) and are always on; ``gc_collections``
and ``gc_ms`` count Python's garbage collections while tracing is on, each
also a ``host.gc`` span (its profiler range names the generation).

Span names by layer: the trainer's ``train.step`` (its profiler range is
``train_step <n>``), ``train.rng``, ``train.h2d``, ``train.accumulate``,
``train.log``, ``train.eval`` and ``train.save``; the train step's phases
``step.g_forward``, ``step.g_loss``, ``step.g_backward``, ``step.g_update``,
``step.d_recompute``, ``step.d_loss``, ``step.d_backward``,
``step.d_update`` and ``step.all_reduce``; the loader's ``data.collate``
(its worker thread) and ``data.wait`` (the consumer); the serving API's
``serve.call``, ``serve.prepare`` (``serve.pad``, ``serve.h2d``,
``serve.noise``), ``serve.forward`` and ``serve.readback``.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

RING = 65536


class Record(NamedTuple):
    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    request: Optional[int]
    thread: int


_NULL = contextlib.nullcontext()
_ring: "collections.deque[Record]" = collections.deque(maxlen=RING)
_index = itertools.count()
_local = threading.local()
# reentrant: a collection may start inside a counter's update
_lock = threading.RLock()
_COUNTERS = ("h2d_bytes", "h2d_copies", "d2h_bytes", "d2h_copies",
             "gc_collections", "gc_ms")
_counts: Dict[str, float] = dict.fromkeys(_COUNTERS, 0)


def _open_spans() -> List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "label", "request", "index", "parent", "start",
                 "range")

    def __init__(self, name: str, request: Optional[int], label: str):
        self.name, self.request, self.label = name, request, label

    def __enter__(self) -> "_Span":
        stack = _open_spans()
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.index
        if self.request is None and top is not None:
            self.request = top.request
        self.index = next(_index)
        self.range = torch.profiler.record_function(self.label)
        self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.close(*exc)
        return False

    def close(self, *exc) -> Record:
        end = time.perf_counter_ns()
        stack = _open_spans()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # closed out of order: drop it where it is
            stack.remove(self)
        self.range.__exit__(*(exc or (None, None, None)))
        record = Record(self.index, self.name, self.start, end, self.parent,
                        self.request, threading.get_ident())
        _ring.append(record)
        return record


def span(name: str, request: Optional[int] = None,
         label: Optional[str] = None):
    """A span of the layer ``name``; ``label`` names its profiler range
    where that differs from ``name``."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, request, label or name)


def records() -> List[Record]:
    """The ring's records, in the order their spans opened."""
    return sorted(list(_ring))


def clear() -> None:
    _ring.clear()
    with _lock:
        _counts.update(dict.fromkeys(_COUNTERS, 0))


def counters() -> Dict[str, float]:
    with _lock:
        return dict(_counts)


def count_transfer(tensor: torch.Tensor, device: Any) -> None:
    """Count ``tensor``'s bytes as one copy where moving it to ``device``
    crosses between the host and a device."""
    src = tensor.is_cpu
    if src == ((device if isinstance(device, str)
                else device.type).startswith("cpu")):
        return
    kind = "h2d" if src else "d2h"
    with _lock:
        _counts[kind + "_bytes"] += tensor.nbytes
        _counts[kind + "_copies"] += 1


def _on_gc(phase: str, info: Dict[str, int]) -> None:
    if phase == "start":
        if _profiler._is_profiler_enabled:
            s = _Span("host.gc", None, f"host.gc gen{info['generation']}")
            s.__enter__()
            _local.gc = s
        return
    s = getattr(_local, "gc", None)
    if s is None:
        return
    _local.gc = None
    record = s.close()
    with _lock:
        _counts["gc_collections"] += 1
        _counts["gc_ms"] += (record.end_ns - record.start_ns) * 1e-6


gc.callbacks.append(_on_gc)
