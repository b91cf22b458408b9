"""The whole-top-level-name check, and what the harness and the
reference load."""

import json
import os
import subprocess
import sys

from portbench.core.env import banned_modules
from portbench.tests.support import ROOT


def test_names_are_compared_whole():
    assert banned_modules(["parallelwavegan_torch.ops", "jaxtyping",
                           "flaxen", "numpy"]) == []
    assert banned_modules(["parallelwavegan_tpu.models", "numpy"]) == [
        "parallelwavegan_tpu"]
    assert banned_modules(["jax", "jaxlib.xla_client", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_the_program_nor_jax():
    loaded = _loaded_after(
        "import portbench.reference.parallel_wavegan, "
        "portbench.reference.hifigan, portbench.reference.pwg_train, "
        "portbench.reference.gckpt, portbench.counts.parallel_wavegan, "
        "portbench.counts.hifigan")
    assert not loaded & {"jax", "jaxlib", "flax", "parallelwavegan_tpu",
                         "parallelwavegan_torch"}


def test_a_toy_run_of_every_cell_loads_no_jax():
    code = (
        "import sys, time, pytest\n"
        "from portbench.tests import support\n"
        "from portbench.core import manifest as mf\n"
        "mf.config, mf.traffic = support.toy_config, support.toy_traffic\n"
        "for cell in [w['name'] for w in mf.Manifest(support.ROOT)"
        ".data['workloads']]:\n"
        "    r, _ = support.run_toy(support.ROOT, cell, seconds=0.2)\n"
        "    assert r['correct'], cell\n")
    loaded = _loaded_after(code)
    assert "parallelwavegan_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "parallelwavegan_tpu"}


def test_run_fails_without_a_card_or_without_the_program(tmp_path):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "pwg_v1.decode_ljspeech_b32_f32", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
