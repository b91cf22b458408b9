"""The port's spans and counters (``utils/tracing.py``) on the CPU: off
without a profiler; names, parents, request ids and threads under one; the
bounded ring; the gc hook; the transfer counters; and the spans the
trainer, the train step, the loader and the serving API open, with their
numbers unchanged by the profiler."""

import collections
import gc
import json
import os
import re
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from parallelwavegan_torch.bin import train as train_cli
from parallelwavegan_torch.datasets.loader import DataLoader
from parallelwavegan_torch.models import get_model_class
from parallelwavegan_torch.utils import tracing
from parallelwavegan_torch.utils.io import load_config
from parallelwavegan_torch.utils.model_loader import InferenceModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEBUG_YAML = os.path.join(REPO, "egs", "yesno", "voc1", "conf",
                          "parallel_wavegan.v1.debug.yaml")
HOP, MELS = 64, 40
# the phases of a full (G, adv, D) step, in the order they run
PHASES = ["step.g_forward", "step.g_loss", "step.g_backward",
          "step.g_update", "step.d_recompute", "step.d_loss",
          "step.d_backward", "step.d_update"]

torch.set_num_threads(2)


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(records):
    out = collections.defaultdict(list)
    for r in records:
        out[r.name].append(r)
    return out


def test_off_is_one_shared_null_context():
    tracing.clear()
    first = tracing.span("a", 3)
    assert first is tracing.span("b")
    with first, tracing.span("c"):
        pass
    gc.collect()
    assert tracing.records() == []
    assert tracing.counters()["gc_collections"] == 0


def test_nested_spans_and_a_second_thread():
    tracing.clear()
    seen = {}

    def worker():
        seen["thread"] = threading.get_ident()
        with tracing.span("w.outer", 9):
            with tracing.span("w.inner"):
                pass

    with _profiler():
        assert tracing.span("a") is not tracing.span("a")
        with tracing.span("outer", 5):
            with tracing.span("middle"):
                with tracing.span("inner", 7):
                    pass
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with tracing.span("sibling"):
                pass
    assert tracing.span("a") is tracing.span("b")
    recs = _by_name(tracing.records())
    main = threading.get_ident()
    outer, middle = recs["outer"][0], recs["middle"][0]
    inner, sibling = recs["inner"][0], recs["sibling"][0]
    w_outer, w_inner = recs["w.outer"][0], recs["w.inner"][0]
    assert outer.parent is None and outer.request == 5
    assert middle.parent == outer.index and middle.request == 5
    assert inner.parent == middle.index and inner.request == 7
    assert sibling.parent == outer.index and sibling.request == 5
    # the worker's spans have the worker's own stack
    assert w_outer.parent is None and w_outer.request == 9
    assert w_inner.parent == w_outer.index and w_inner.request == 9
    assert {r.thread for r in (outer, middle, inner, sibling)} == {main}
    assert {w_outer.thread, w_inner.thread} == {seen["thread"]}
    assert outer.start_ns <= middle.start_ns <= inner.start_ns \
        <= inner.end_ns <= middle.end_ns <= sibling.start_ns \
        <= sibling.end_ns <= outer.end_ns
    # records come back in the order the spans opened
    assert [r.index for r in tracing.records()] == sorted(
        r.index for r in tracing.records())


def test_the_ring_is_bounded(monkeypatch):
    assert tracing._ring.maxlen == tracing.RING == 65536
    monkeypatch.setattr(tracing, "_ring", collections.deque(maxlen=16))
    with _profiler():
        for k in range(40):
            with tracing.span("s", k):
                pass
    recs = tracing.records()
    assert len(recs) == 16
    assert [r.request for r in recs] == list(range(24, 40))


def test_a_collection_is_counted_and_recorded():
    tracing.clear()
    with _profiler():
        with tracing.span("outer", 4):
            gc.collect()
    counts = tracing.counters()
    assert counts["gc_collections"] >= 1 and counts["gc_ms"] > 0
    recs = _by_name(tracing.records())
    outer = recs["outer"][0]
    hits = [r for r in recs["host.gc"] if r.parent == outer.index]
    assert hits and all(r.request == 4 for r in hits)
    # the hook does nothing once the profiler has stopped
    gc.collect()
    assert tracing.counters()["gc_collections"] == counts["gc_collections"]


def test_transfers_are_counted_across_host_and_device():
    tracing.clear()
    host = torch.ones(4, 3)
    tracing.count_transfer(host, "cpu")
    assert tracing.counters()["h2d_copies"] == 0
    tracing.count_transfer(host, "meta")
    tracing.count_transfer(torch.ones(5, device="meta"), torch.device("cpu"))
    counts = tracing.counters()
    assert (counts["h2d_bytes"], counts["h2d_copies"]) == (48, 1)
    assert (counts["d2h_bytes"], counts["d2h_copies"]) == (20, 1)
    tracing.clear()
    assert tracing.counters()["h2d_bytes"] == 0


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    root = tmp_path_factory.mktemp("dumps")
    rng = np.random.default_rng(0)
    for i in range(4):
        frames = 30 + 5 * i
        np.save(root / f"utt{i}-wave.npy",
                (0.1 * rng.standard_normal(frames * HOP)).astype(np.float32))
        np.save(root / f"utt{i}-feats.npy",
                rng.standard_normal((frames, MELS)).astype(np.float32))
    return str(root)


def _train(dumps, outdir, **overrides):
    config = dict(load_config(DEBUG_YAML), format="npy", batch_size=2,
                  batch_max_steps=1024, eval_interval_steps=100,
                  save_interval_steps=100, log_interval_steps=4,
                  train_max_steps=8, **overrides)
    return train_cli.run(config, dumps, dumps, outdir, device="cpu",
                         dump_config=False)


def test_the_step_phases_lie_inside_each_profiled_step(dumps, tmp_path):
    """Steps 6 and 7, past the discriminator's start at 5: each
    ``train_step <n>`` range of the written trace holds the eight phases of
    a full step in order, on the clock of the step's own ops; the records
    agree; the profiler changes no number."""
    tracing.clear()
    prof = str(tmp_path / "prof")
    traced = _train(dumps, str(tmp_path / "exp"), profile_dir=prof,
                    profile_start_step=6, profile_num_steps=2)
    plain = _train(dumps, str(tmp_path / "exp2"))
    assert traced.profile_trace.endswith("rank0-steps6-7.pt.trace.json")
    assert traced.last_train_loss == plain.last_train_loss
    assert traced.last_train_loss
    for k, v in plain.state.params_g.items():
        assert torch.equal(traced.state.params_g[k], v), k
    for k, v in plain.state.params_d.items():
        assert torch.equal(traced.state.params_d[k], v), k

    with open(traced.profile_trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    ranges = {int(m.group(1)): e for e in events
              for m in [re.fullmatch(r"train_step (\d+)", e["name"])] if m}
    assert sorted(ranges) == [6, 7]
    for n, step in ranges.items():
        lo, hi = step["ts"], step["ts"] + step["dur"]
        inside = sorted((e for e in events if e["name"].startswith("step.")
                         and lo <= e["ts"] and e["ts"] + e["dur"] <= hi),
                        key=lambda e: e["ts"])
        assert [e["name"] for e in inside] == PHASES, n
        forward = inside[0]
        ops = [e for e in events if e.get("cat") == "cpu_op"
               and forward["ts"] <= e["ts"]
               and e["ts"] + e["dur"] <= forward["ts"] + forward["dur"]]
        assert any("conv" in e["name"] for e in ops), n
        for name in ("train.rng", "train.h2d", "train.accumulate"):
            assert any(e["name"] == name and lo <= e["ts"]
                       and e["ts"] + e["dur"] <= hi for e in events), name

    recs = tracing.records()
    steps = [r for r in recs if r.name == "train.step"]
    assert [r.request for r in steps] == [6, 7]
    for step in steps:
        children = [r for r in recs if r.parent == step.index]
        names = [r.name for r in children]
        assert names == ["train.rng", "train.h2d"] + PHASES + [
            "train.accumulate"] + (["train.log"] if step.request == 7 else [])
        assert all(r.request == step.request for r in children)
        assert all(step.start_ns <= r.start_ns <= r.end_ns <= step.end_ns
                   for r in children)


def _small_pwg():
    config = load_config(DEBUG_YAML)
    gen = get_model_class(config["generator_type"])(
        **config["generator_params"])
    params: dict = {}
    for name, t in gen.state_dict().items():
        node = params
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.numpy()
    return InferenceModel(config, {"params": params}, device="cpu")


def test_a_serving_call_records_its_layers():
    model = _small_pwg()
    rng = np.random.default_rng(0)
    mels = [rng.standard_normal((n, MELS)).astype(np.float32)
            for n in (20, 33)]

    def call():
        return model.synthesize_batch(
            mels, generator=torch.Generator().manual_seed(1), bucket_size=8)

    want = call()
    tracing.clear()
    with _profiler():
        got = call()
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    recs = tracing.records()
    by_index = {r.index: r for r in recs}
    (top,) = [r for r in recs if r.name == "serve.call"]
    assert top.request == model.calls == 2

    def children(r):
        return [c.name for c in recs if c.parent == r.index]

    assert children(top) == ["serve.prepare", "serve.forward",
                             "serve.readback"]
    (prepare,) = [r for r in recs if r.name == "serve.prepare"]
    assert children(prepare) == ["serve.pad", "serve.h2d", "serve.noise"]
    assert all(r.request == 2 for r in recs)
    assert all(r.parent is None or by_index[r.parent].start_ns <= r.start_ns
               for r in recs)
    # the host is the device here: no transfer is counted
    assert tracing.counters()["h2d_copies"] == 0


def test_the_loader_records_collation_and_waits():
    data = [{"x": np.full(3, k, np.float32)} for k in range(10)]

    def collate(items):
        return {"x": np.stack([it["x"] for it in items])}

    loader = DataLoader(data, collate, batch_size=2, shuffle=False,
                        prefetch=2)
    tracing.clear()
    with _profiler():
        batches = list(loader)
    assert len(batches) == 5
    recs = _by_name(tracing.records())
    main = threading.get_ident()
    collates = recs["data.collate"]
    assert [r.request for r in collates] == [0, 1, 2, 3, 4]
    assert {r.thread for r in collates} != {main}
    assert len({r.thread for r in collates}) == 1
    waits = recs["data.wait"]
    assert len(waits) == 6  # five batches and the end of the epoch
    assert {r.thread for r in waits} == {main}
