"""A new family is new files and a configuration that names them: the
training driver and the model-operation metrics reach a family's step,
parameters, row check and counts through the modules its configuration
names, so a toy family with modules of its own runs with no edit of
``portbench/core/``."""

import sys
import time

import pytest

from portbench.core import manifest as mf
from portbench.tests.support import ROOT, toy_config, toy_traffic

TRAIN_MODULE = '''
from portbench.reference.pwg_train import LOSSES, Step as _Step, bad_rows
from portbench.reference.pwg_train import shapes as _shapes

CALLS = []


def shapes(config):
    CALLS.append("shapes")
    return _shapes(config)


class Step(_Step):
    def __call__(self, batch):
        CALLS.append("step")
        return super().__call__(batch)
'''

COUNTS_MODULE = '''
CALLS = []


def forward_flops(config, samples):
    CALLS.append(("forward", samples))
    return 1.0e6 * samples


def train_step_flops(config, batch, samples):
    CALLS.append(("step", batch, samples))
    return 1.0e9 * batch * samples
'''


@pytest.mark.parametrize("cell,base,metric", [
    ("pwg_v1.train_adv_b6_f32", "pwg_v1", "mfu.train"),
    ("pwg_v1.decode_ljspeech_b32_f32", "pwg_v1", "mfu.decode"),
])
def test_a_toy_family_runs_through_its_own_modules(monkeypatch, tmp_path,
                                                   cell, base, metric):
    from portbench.core.cell import run_cell
    from portbench.core.train import CHECK_STEPS

    (tmp_path / "toyfam_train.py").write_text(TRAIN_MODULE)
    (tmp_path / "toyfam_counts.py").write_text(COUNTS_MODULE)
    monkeypatch.syspath_prepend(str(tmp_path))
    for name in ("toyfam_train", "toyfam_counts"):
        sys.modules.pop(name, None)

    def config(name):
        c = toy_config(base)
        if name == "toyfam":
            c["portbench"] = dict(c["portbench"],
                                  train_reference="toyfam_train",
                                  counts="toyfam_counts")
        return c

    monkeypatch.setattr(mf, "config", config)
    monkeypatch.setattr(mf, "traffic", toy_traffic)
    manifest = mf.Manifest(ROOT)
    entry = dict(manifest.cell(cell), config="toyfam")
    metrics = [m for m in manifest.data["per_layer"] if m["name"] == metric]
    outcome = run_cell(ROOT, entry, metrics, 2 ** 32 + 11, 0.3, False,
                       "cpu", time.perf_counter(), {})
    assert outcome.result["correct"], outcome.checks
    assert outcome.result["metrics"][metric]["value"] > 0
    train = sys.modules.get("toyfam_train")
    counts = sys.modules["toyfam_counts"]
    assert counts.CALLS
    if metric == "mfu.train":
        assert train.CALLS.count("shapes") == 1
        assert train.CALLS.count("step") == CHECK_STEPS
        assert counts.CALLS == [("step", 2, 2048)]
    else:  # serving never loads the training reference
        assert train is None
        assert all(kind == "forward" for kind, _ in counts.CALLS)
