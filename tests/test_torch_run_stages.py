"""The port's recipe stage runner (``bin/run_stages.py``) on the CPU: its
stage 1 (two feature jobs a set) against ``bash`` running
``egs/common/run_stages.sh`` stage 1 (the JAX package's CLIs) from a
throwaway ``run.sh`` on a tiny corpus the test writes, the dumps and
``stats.h5`` within ``test_torch_preprocess.py``'s tolerances; then its
stages 2-4 at the yesno recipe's debug width (training through
``egs/common/run_job.sh`` as ``--cmd``), and the round-robin shards
against the shell's awk."""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import yaml

from parallelwavegan_torch.bin import run_stages
from parallelwavegan_torch.utils.io import read_wav, write_wav
from tests.test_torch_preprocess import MEL_TOL, NORM_TOL, STATS_TOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEBUG_YAML = os.path.join(REPO, "egs", "yesno", "voc1", "conf",
                          "parallel_wavegan.v1.debug.yaml")
SR, HOP = 8000, 64
SETS = {"train": 4, "dev": 2, "eval": 2}
# the recipe's steps and intervals cut to two steps, one evaluation, one
# checkpoint, at two utterances a batch
CUT = dict(batch_size=2, train_max_steps=2, save_interval_steps=2,
           eval_interval_steps=2, log_interval_steps=1,
           discriminator_train_start_steps=0)
RUN_SH = """#!/usr/bin/env bash
cd "$(dirname "$0")"
conf=conf.yaml
download() {{ :; }}
data_prep() {{ :; }}
source {common}/run_stages.sh "$@"
"""


def _write_recipe(root, rng):
    """data/{train,dev,eval}/wav.scp over 0.75 s noisy sines, and the
    debug yaml with CUT as conf.yaml."""
    os.makedirs(root)
    k = 0
    for set_name, n in SETS.items():
        os.makedirs(os.path.join(root, "data", set_name))
        lines = []
        for _ in range(n):
            t = np.arange(int(0.65 * SR)) / SR
            wave = 0.4 * np.sin(2 * np.pi * (110 + 35 * k) * t)
            wave += 0.01 * rng.standard_normal(len(t))
            wave = np.concatenate([np.zeros(int(0.1 * SR)), wave])
            path = os.path.join(root, "wavs", f"{set_name}{k}.wav")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_wav(path, wave.astype(np.float32), SR)
            lines.append(f"{set_name}{k} {path}\n")
            k += 1
        with open(os.path.join(root, "data", set_name, "wav.scp"), "w") as f:
            f.writelines(lines)
    with open(DEBUG_YAML) as f:
        config = dict(yaml.safe_load(f), **CUT)
    with open(os.path.join(root, "conf.yaml"), "w") as f:
        yaml.safe_dump(config, f)


def _read(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f}


def _dumps(dirname):
    return {name[:-3]: _read(os.path.join(dirname, name))
            for name in sorted(os.listdir(dirname)) if name.endswith(".h5")}


@pytest.fixture(scope="module")
def recipes(tmp_path_factory):
    """The same recipe through the shell (JAX CLIs) and through the port's
    stage runner (``--device cpu``), stage 1, two jobs."""
    root = tmp_path_factory.mktemp("recipes")
    rng = np.random.default_rng(0)
    shell, port = str(root / "shell"), str(root / "port")
    _write_recipe(shell, rng)
    _write_recipe(port, np.random.default_rng(0))
    with open(os.path.join(shell, "run.sh"), "w") as f:
        f.write(RUN_SH.format(common=os.path.join(REPO, "egs", "common")))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    sh = subprocess.Popen(
        ["bash", os.path.join(shell, "run.sh"), "--stage", "1",
         "--stop_stage", "1", "--n_jobs", "2"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    py = subprocess.run(
        [sys.executable, "-m", "parallelwavegan_torch.bin.run_stages",
         "--conf", "conf.yaml", "--stop-stage", "1", "--n-jobs", "2",
         "--device", "cpu"], cwd=port, env=dict(env, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=600)
    sh_out = sh.communicate(timeout=600)[0]
    assert sh.returncode == 0, sh_out[-3000:]
    assert py.returncode == 0, (py.stdout + py.stderr)[-3000:]
    return {"shell": shell, "port": port, "stdout": py.stdout}


def test_stage1_matches_the_shell_recipe(recipes):
    """The same shards (wav.1.scp, wav.2.scp) and logs, the same dump files
    and keys: waves bit for bit, the log-mel within MEL_TOL, stats.h5
    within STATS_TOL, the normalized feats within NORM_TOL."""
    shell, port = recipes["shell"], recipes["port"]
    assert "Stage 1" in recipes["stdout"]
    for set_name, n in SETS.items():
        raw = {d: os.path.join(d, "dump", set_name, "raw")
               for d in (shell, port)}
        for j in (1, 2):
            with open(os.path.join(raw[shell], f"wav.{j}.scp")) as a, \
                    open(os.path.join(raw[port], f"wav.{j}.scp")) as b:
                assert [ln.split()[0] for ln in a] == \
                    [ln.split()[0] for ln in b]
            assert os.path.exists(os.path.join(raw[port],
                                               f"preprocessing.{j}.log"))
        for stage in ("raw", "norm"):
            want = _dumps(os.path.join(shell, "dump", set_name, stage))
            got = _dumps(os.path.join(port, "dump", set_name, stage))
            assert sorted(got) == sorted(want) and len(got) == n
            for utt, arrays in want.items():
                assert sorted(got[utt]) == sorted(arrays) == ["feats", "wave"]
                np.testing.assert_array_equal(got[utt]["wave"],
                                              arrays["wave"])
                np.testing.assert_allclose(
                    got[utt]["feats"], arrays["feats"], rtol=0,
                    atol=MEL_TOL if stage == "raw" else NORM_TOL)
    want = _read(os.path.join(shell, "dump", "train", "stats.h5"))
    got = _read(os.path.join(port, "dump", "train", "stats.h5"))
    assert sorted(got) == sorted(want) == ["mean", "scale"]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=STATS_TOL)


def test_stages_2_to_4_on_the_cpu(recipes):
    """Training (two steps, through ``run_job.sh`` as ``--cmd``), decoding
    of the eval dumps with the newest checkpoint, and both scores over the
    raw dumps' ground truth, in the shell's layout."""
    port = recipes["port"]
    out = subprocess.run(
        [sys.executable, "-m", "parallelwavegan_torch.bin.run_stages",
         "--conf", "conf.yaml", "--stage", "2", "--n-jobs", "2",
         "--device", "cpu", "--cmd",
         f"bash {os.path.join(REPO, 'egs', 'common', 'run_job.sh')}"],
        cwd=port, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    expdir = os.path.join(port, "exp", "conf")
    with open(os.path.join(expdir, "train.log")) as f:
        assert "Finished training (2 steps)" in f.read()
    assert os.path.exists(os.path.join(expdir, "checkpoint-2steps.ckpt"))
    for utt, arrays in _dumps(os.path.join(port, "dump", "eval",
                                           "raw")).items():
        wave, sr = read_wav(os.path.join(expdir, "wav", f"{utt}_gen.wav"))
        assert sr == SR and len(wave) == len(arrays["feats"]) * HOP
        assert np.isfinite(wave).all()
        gt, _ = read_wav(os.path.join(expdir, "gt_wav", f"{utt}.wav"))
        assert len(gt) == len(arrays["wave"])
    for line in ("Stage 2", "Stage 3", "Stage 4", "Mean MCD",
                 "Mean log-F0", "Finished."):
        assert line in out.stdout, line


def test_shards_are_the_shells_awk(tmp_path):
    scp = tmp_path / "wav.scp"
    scp.write_text("".join(f"u{i} /x/u{i}.wav\n" for i in range(7)))
    paths = run_stages.shard_scp(str(scp), str(tmp_path), 3)
    for j, path in enumerate(paths, 1):
        awk = subprocess.run(
            ["awk", "-v", f"j={j}", "-v", "n=3", "NR % n == j % n",
             str(scp)], capture_output=True, text=True, check=True).stdout
        with open(path) as f:
            assert f.read() == awk


def test_stages_before_1_belong_to_the_recipe(tmp_path):
    with pytest.raises(ValueError, match="data_prep"):
        run_stages.run(str(tmp_path / "conf.yaml"), stage=-1, stop_stage=0)
