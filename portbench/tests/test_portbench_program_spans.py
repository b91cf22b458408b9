"""``core/program.py`` and the seven readers of the program's spans, on
synthetic traces: a Trace built from profiler events, and program records
on a clock that lies a known offset from it (each program top starting 9
to 11 us after its harness span)."""

import pytest

from parallelwavegan_torch.utils.tracing import Record
from portbench.core import manifest as mf
from portbench.core import program
from portbench.core.trace import Trace
from portbench.tests.support import ROOT  # noqa: F401  (puts ROOT on the path)

# the Trace's clock is the program's plus OFFSET seconds; the median of
# the program tops' lags behind the harness's spans
OFFSET, LAG = 1000.0, 10e-6
MAIN, WORKER = 11, 22

TRAIN = ["dispatch_ms.train", "idle_in_dispatch_pct.train", "h2d_ms.train",
         "collate_ms.train", "gc_ms.train"]
SERVE = ["prepare_ms.decode", "prepare_ms.tts"]


def _events(spans, kernels):
    """Profiler events: harness spans and kernels, (name, start ms, end
    ms) on the Trace's clock (1000 s + ms)."""
    out = []
    for cat, name, s, e in ([("user_annotation", "portbench." + n, s, e)
                             for n, s, e in spans]
                            + [("kernel", "k", s, e) for s, e in kernels]):
        out.append({"ph": "X", "cat": cat, "name": name,
                    "ts": (1000.0 + s * 1e-3) * 1e6, "dur": (e - s) * 1e3})
    return out


class Records:
    """Program records given in ms on the Trace's clock, stored on the
    program's (``perf_counter_ns``)."""

    def __init__(self):
        self.out = []

    def add(self, name, s, e, parent=None, request=None, thread=MAIN):
        index = len(self.out)
        self.out.append(Record(
            index, name, round(((1000.0 + s * 1e-3) - OFFSET) * 1e9),
            round(((1000.0 + e * 1e-3) - OFFSET) * 1e9),
            parent, request, thread))
        return index


def _train_run():
    spans = [("loader_next", 0, 1), ("step", 1, 101),
             ("loader_next", 101, 102), ("step", 102, 202),
             ("loader_next", 202, 203), ("step", 203, 303),
             ("sync", 303, 310), ("log", 250, 251)]
    kernels = [(20, 30), (80, 100), (130, 140), (250, 300), (303, 310)]
    r = Records()
    # a step profiled in set-up, before the stretch
    early = r.add("train.step", -100, -50, request=99)
    r.add("step.g_forward", -90, -60, early, 99)
    r.add("data.collate", -20, -15, request=0, thread=WORKER)
    r.add("host.gc", -5, -4)
    # the three traced steps; each top starts 9, 10, 11 us in
    a = r.add("train.step", 1.009, 100.99, request=100)
    r.add("train.h2d", 1.5, 2.5, a, 100)
    r.add("step.g_forward", 3, 40, a, 100)
    loss = r.add("step.g_loss", 40, 60, a, 100)
    r.add("host.gc", 45, 47, loss, 100)
    r.add("step.d_update", 60, 70, a, 100)
    r.add("data.collate", 50, 53, request=1, thread=WORKER)
    b = r.add("train.step", 102.010, 201.99, request=101)
    r.add("train.h2d", 102.5, 104.5, b, 101)
    fwd = r.add("step.g_forward", 105, 150, b, 101)
    r.add("step.all_reduce", 110, 115, fwd, 101)
    r.add("step.d_loss", 150, 170, b, 101)
    r.add("data.collate", 150, 154, request=2, thread=WORKER)
    r.add("host.gc", 180, 181, thread=WORKER)
    c = r.add("train.step", 203.011, 302.99, request=102)
    r.add("train.h2d", 203.5, 206.5, c, 102)
    r.add("step.g_forward", 210, 240, c, 102)
    r.add("data.collate", 290, 295, request=3, thread=WORKER)
    # closes after the stretch: not counted
    r.add("data.collate", 305, 320, request=4, thread=WORKER)
    return {"trace": Trace(_events(spans, kernels))}, r.out


def _serve_run():
    spans = [("call", 0, 50), ("prepare", 0.2, 7), ("call", 60, 110),
             ("prepare", 60.2, 71)]
    kernels = [(10, 45), (75, 105)]
    r = Records()
    warm = r.add("serve.call", -80, -30, request=7)
    r.add("serve.prepare", -79, -70, warm, 7)
    x = r.add("serve.call", 0.009, 49.99, request=8)
    p = r.add("serve.prepare", 0.5, 6.5, x, 8)
    r.add("serve.pad", 0.6, 4, p, 8)
    r.add("serve.forward", 7, 45, x, 8)
    y = r.add("serve.call", 60.011, 109.99, request=9)
    r.add("serve.prepare", 60.5, 70.5, y, 9)
    return {"trace": Trace(_events(spans, kernels))}, r.out


@pytest.fixture
def records(monkeypatch):
    """Hands the readers a list of records in place of the program's."""
    box = {"records": []}
    monkeypatch.setattr(program, "program_records", lambda: box["records"])
    return box


def test_the_offset_is_recovered(records):
    run, records["records"] = _train_run()
    p = program.align(run, "step")
    # the offset to the program's clock, less the median lag
    assert p.offset == pytest.approx(OFFSET - LAG, abs=1e-9)
    assert [t.request for t in p.tops] == [100, 101, 102]
    assert p.tops[0].start == pytest.approx(1000.0 + 1.009e-3 - LAG,
                                            abs=1e-9)
    run, records["records"] = _serve_run()
    assert program.align(run, "call").offset == pytest.approx(
        OFFSET - LAG, abs=1e-9)


@pytest.mark.parametrize("name,want", [
    # (67 + 65 + 30) / 3 steps: the union of the step.* spans, the nested
    # all-reduce counted once
    ("dispatch_ms.train", 54.0),
    # idle 310 - 97 = 213 ms; under the phases 57 + 55 + 30 = 142
    ("idle_in_dispatch_pct.train", 100.0 * 142 / 213),
    ("h2d_ms.train", (1 + 2 + 3) / 3),
    # the three spans that closed in the stretch
    ("collate_ms.train", (3 + 4 + 5) / 3),
    # one on the step's thread, one on the worker's
    ("gc_ms.train", (2 + 1) / 3),
])
def test_training_readers(records, name, want):
    run, records["records"] = _train_run()
    assert mf.read_metric(name, run) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", SERVE)
def test_serving_readers(records, name):
    run, records["records"] = _serve_run()
    # the warm-up call's preparation is not the traced calls'
    assert mf.read_metric(name, run) == pytest.approx((6 + 10) / 2,
                                                      rel=1e-6)


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_nothing_to_read_gives_none(records, name):
    make = _train_run if name in TRAIN else _serve_run
    run, recs = make()
    records["records"] = recs
    assert mf.read_metric(name, {"trace": None}) is None
    # a program without spans
    records["records"] = None
    assert mf.read_metric(name, run) is None
    records["records"] = []
    assert mf.read_metric(name, run) is None
    # one traced top more than the program recorded
    top = "train.step" if name in TRAIN else "serve.call"
    tops = [r for r in recs if r.name == top]
    records["records"] = [r for r in recs if r is not tops[0]
                          and r is not tops[1]]
    assert mf.read_metric(name, run) is None
    # tops that do not lie in the harness's spans: the match is off
    records["records"] = [r._replace(end_ns=r.end_ns + 10 ** 7)
                          if r.name == top else r for r in recs]
    assert mf.read_metric(name, run) is None
