"""The trainer's profiler hook on the CPU: a run with ``profile_dir``
writes rank 0's Chrome trace of exactly the steps [profile_start_step,
profile_start_step + profile_num_steps) that ran a step function, as the
JAX trainer's hook traces them; a run that ends inside the window still
writes the steps it ran (the JAX trace is never stopped there); a window
that starts on a warm-up step never opens, as in JAX."""

import json
import os
import re

import numpy as np
import pytest
import torch

from parallelwavegan_torch.bin import train as train_cli
from parallelwavegan_torch.utils.io import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEBUG_YAML = os.path.join(REPO, "egs", "yesno", "voc1", "conf",
                          "parallel_wavegan.v1.debug.yaml")
HOP, MELS = 64, 40

torch.set_num_threads(2)


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


def _run(dumps, outdir, **overrides):
    config = dict(load_config(DEBUG_YAML), format="npy", batch_size=2,
                  batch_max_steps=1024, eval_interval_steps=100,
                  save_interval_steps=100, log_interval_steps=100,
                  **overrides)
    return train_cli.run(config, dumps, dumps, outdir, device="cpu",
                         dump_config=False)


def _traced_steps(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    return sorted(int(m.group(1)) for n in names
                  for m in [re.fullmatch(r"train_step (\d+)", n)] if m), names


def test_profile_dir_traces_the_window(dumps, tmp_path):
    prof = str(tmp_path / "prof")
    trainer = _run(dumps, str(tmp_path / "exp"), train_max_steps=5,
                   profile_dir=prof, profile_start_step=1,
                   profile_num_steps=2)
    assert trainer.steps == 5
    assert trainer.profile_trace == os.path.join(
        prof, "rank0-steps1-2.pt.trace.json")
    assert os.listdir(prof) == ["rank0-steps1-2.pt.trace.json"]
    steps, names = _traced_steps(trainer.profile_trace)
    assert steps == [1, 2]
    # the step's own ops are in the trace
    assert any("conv" in n for n in names)


def test_a_run_ending_inside_the_window_writes_what_ran(dumps, tmp_path):
    """Deviation kept on purpose: the JAX trainer never stops a trace whose
    window outlasts the run; the port writes the steps that ran."""
    prof = str(tmp_path / "prof")
    trainer = _run(dumps, str(tmp_path / "exp"), train_max_steps=3,
                   profile_dir=prof, profile_start_step=1)
    assert trainer.profile_trace == os.path.join(
        prof, "rank0-steps1-2.pt.trace.json")
    assert _traced_steps(trainer.profile_trace)[0] == [1, 2]


def test_a_window_opening_on_a_warm_up_step_never_opens(dumps, tmp_path):
    """Steps 0 and 1 train nothing (G from step 2, D later): the hook, as
    the JAX one, runs only before a step function, so a window that starts
    at 1 never opens; without profile_dir nothing is traced."""
    prof = str(tmp_path / "prof")
    trainer = _run(dumps, str(tmp_path / "exp"), train_max_steps=4,
                   generator_train_start_steps=1,
                   discriminator_train_start_steps=100,
                   profile_dir=prof, profile_start_step=1)
    assert trainer.profile_trace is None and not os.path.exists(prof)
    trainer = _run(dumps, str(tmp_path / "exp2"), train_max_steps=2)
    assert trainer.profile_trace is None
