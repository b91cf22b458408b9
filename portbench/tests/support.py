"""What the harness's tests share: the card fixture (the card's presence
is decided inside it, never at import), and toy sizes of the cells for
runs on the CPU (the configuration's families at a few layers, short
utterances, small batches)."""

import contextlib
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


from portbench.core import manifest as mf  # noqa: E402


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


def toy_config(name: str) -> dict:
    c = _real["config"](name)
    if name == "pwg_v1":
        c["generator_params"].update(layers=4, stacks=2)
        c["discriminator_params"].update(layers=4)
        c["batch_size"], c["batch_max_steps"] = 2, 2048
    return c


def toy_traffic(name: str) -> dict:
    t = _real["traffic"](name)
    t["lengths"].update(min=20, max=40, pool=12)
    if t["kind"] == "decode":
        t.update(batch=3, bucket_frames=8)
    return t


_real = {"config": mf.config, "traffic": mf.traffic}


@contextlib.contextmanager
def toy_sizes(monkeypatch):
    monkeypatch.setattr(mf, "config", toy_config)
    monkeypatch.setattr(mf, "traffic", toy_traffic)
    yield


def run_toy(root: str, cell_name: str, trace: bool = False,
            seconds: float = 0.6, seed: int = 2 ** 32 + 5):
    import time

    from portbench.core.cell import run_cell

    manifest = mf.Manifest(root)
    cell = manifest.cell(cell_name)
    outcome = run_cell(root, cell, manifest.metrics(cell_name, trace),
                       seed, seconds, trace, "cpu", time.perf_counter(), {})
    return outcome.result, outcome.checks
