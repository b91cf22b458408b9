"""Data-parallel training of the port on the CPU (gloo): the launcher, the
rank-aware step against the JAX package's ``shard_map`` step, the per-rank
random streams, the dead-code restart's collectives and a two-rank
``bin.train`` run."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from parallelwavegan_tpu.parallel.mesh import make_mesh, replicate
from parallelwavegan_torch.distributed import launch
from parallelwavegan_torch.engine.build import init_train_state
from parallelwavegan_torch.engine.criterion import build_criterion
from parallelwavegan_torch.engine.step import (
    DROPOUT_STREAM,
    SHARED_STREAM,
    build_steps,
    step_generator,
)
from parallelwavegan_torch.parallel.dist import Group, per_rank_batch
from parallelwavegan_torch.tools.dp_emulation import ThreadGroup, run_ranks
from tests.torch_helpers import (
    as_jax,
    as_torch,
    assert_first_moment,
    assert_losses,
    assert_params,
    both_train_states,
    sine_batch,
    small_melgan_train_config,
    small_vqvae_train_config,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
DEBUG_YAML = os.path.join(
    REPO, "egs/yesno/voc1/conf/parallel_wavegan.v1.debug.yaml")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def _launch(args, nproc=2, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "parallelwavegan_torch.distributed.launch",
         "--nproc_per_node", str(nproc), "--master_port", str(_free_port())]
        + list(args),
        capture_output=True, text=True, cwd=REPO, timeout=timeout,
        env=_env())


class _TwoRanks:
    """The worker's two ranks on ``batches`` (global batches, each split
    between the ranks), started at once; ``result()`` waits for their
    outputs, in rank order."""

    def __init__(self, tmp_path, config, init, flags, batches):
        self.tmp_path = tmp_path
        job = tmp_path / "job.pt"
        torch.save({"config": config, "init": init, "flags": flags,
                    "batches": [_shards(as_torch(b), 2) for b in batches]},
                   job)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "parallelwavegan_torch.distributed.launch",
             "--nproc_per_node", "2", "--master_port", str(_free_port()),
             WORKER, str(job), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=_env())

    def result(self):
        out, err = self.proc.communicate(timeout=300)
        assert self.proc.returncode == 0, out + err
        assert out.count("backend gloo") == 2, out
        return [torch.load(self.tmp_path / f"rank{r}.pt", weights_only=False)
                for r in range(2)]


def _shards(batch, world):
    """Each rank's rows of a global batch, in rank order."""
    n = next(iter(batch.values())).shape[0] // world
    return [{k: v[r * n:(r + 1) * n] for k, v in batch.items()}
            for r in range(world)]


def _assert_replicas_equal(ranks):
    want = ranks[0]["tensors"]
    for other in ranks[1:]:
        assert list(other["tensors"]) == list(want)
        for name, t in other["tensors"].items():
            assert torch.equal(t, want[name]), name


def _pwg_config():
    with open(DEBUG_YAML) as f:
        config = yaml.safe_load(f)
    config.update(format="npy", batch_size=4, fused_wavenet=False)
    return config


CONFIGS = {"pwg": _pwg_config,
           "mb_melgan": lambda: small_melgan_train_config("mb_melgan",
                                                          batch_size=4)}


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_two_ranks_match_the_jax_shard_map_step(tmp_path, kind):
    """Two G+adv+D steps on two gloo ranks, each on its half of the global
    batch, against the JAX step built on a mesh of two CPU devices
    (``shard_map``, ``pmean`` of the gradients and the metrics) from the
    same parameters: the mean losses to 1e-4 relative, the parameters to
    2e-6 and the first moments as in ``test_torch_train_step.py``; every
    tensor of the state bit-equal across the ranks."""
    config = CONFIGS[kind]()
    mesh = make_mesh(jax.devices()[:2])
    state, (factory, _), t_state, _ = both_train_states(config, mesh=mesh)
    batches = [sine_batch(config, seed=10 + i) for i in range(2)]
    init = {k: v.detach().clone() for k, v in t_state.tensors().items()}
    ranks = _TwoRanks(tmp_path, config, init, (True, True, True), batches)
    step = factory(True, True, True)
    state = replicate(mesh, state)  # as the step returns it: one compile
    refs = []
    for batch in batches:
        state, ref = step(state, as_jax(batch), jax.random.key(0))
        refs.append(ref)
    ranks = ranks.result()
    _assert_replicas_equal(ranks)
    for got, ref in zip((r for r in ranks[0]["metrics"]), refs):
        got = {k: torch.tensor(v) for k, v in got.items()}
        assert_losses(got, ref, sorted(got), rtol=1e-4)
    with torch.no_grad():
        for name, t in t_state.tensors().items():
            t.copy_(ranks[0]["tensors"][name])
    assert int(state.steps) == 2
    assert_params(t_state.generator, state.params_g, 2e-6, "G")
    assert_params(t_state.discriminator, state.params_d, 2e-6, "D")
    assert_first_moment(t_state.opt_g, state.opt_g, "G")
    assert_first_moment(t_state.opt_d, state.opt_d, "D")


def test_step_generator_is_unchanged_at_world_one_and_distinct_per_rank():
    """One process draws what it drew before ranks existed (the seed
    (seed, steps, stream)); at world 2 every stream but the shared one
    differs across the ranks, as JAX folds the device index into every
    stream but the restart gate's."""
    def draws(g):
        return torch.rand(8, generator=g)

    for stream in (0, 1, SHARED_STREAM, DROPOUT_STREAM):
        seq = np.random.SeedSequence([3, 7, stream])
        want = torch.rand(8, generator=torch.Generator().manual_seed(
            int(seq.generate_state(1, np.uint64)[0])))
        assert torch.equal(draws(step_generator(3, 7, stream)), want)
        assert torch.equal(draws(step_generator(3, 7, stream, rank=5,
                                                world=1)), want)
        r0 = draws(step_generator(3, 7, stream, rank=0, world=2))
        r1 = draws(step_generator(3, 7, stream, rank=1, world=2))
        assert torch.equal(r0, r1) == (stream == SHARED_STREAM), stream
        if stream == SHARED_STREAM:
            assert torch.equal(r0, want)


def test_vq_restart_is_replicated_and_equals_the_one_process_emulation(
        tmp_path):
    """Two steps of the small VQ-VAE with restarts (prob 0.5) on two gloo
    ranks: the codebook and every other tensor bit-equal across the ranks,
    and equal to a one-process emulation of JAX's rule (the ranks as two
    threads whose collectives sum the code counts, ``psum``, and average
    the restart rows, ``pmean``; ``tools/dp_emulation.ThreadGroup``) on
    the same shards and draws. Held against the port's emulation and not
    the JAX step: the JAX step draws its rows under ``shard_map`` from a
    key folded with the device index, and ``JaxDraws`` can hand one
    stream to the JAX module but not one per shard."""
    config = small_vqvae_train_config(
        "none", batch_size=4, vq_dead_code_restart=True, vq_restart_prob=0.5)
    batches = [{"y": sine_batch(config, seed=10 + i)["y"]} for i in range(2)]
    t_state = init_train_state(config, 0, device="cpu")[0]
    init = {k: v.detach().clone() for k, v in t_state.tensors().items()}
    ranks = _TwoRanks(tmp_path, config, init, (True, True, True), batches)

    group = ThreadGroup(2)
    shards = [_shards(as_torch(b), 2) for b in batches]

    def emulated(rank):
        state, gen, dis, opt_g, opt_d = init_train_state(config, 0, "cpu")
        with torch.no_grad():
            for name, t in state.tensors().items():
                t.copy_(init[name])
        factory, _ = build_steps(config, gen, dis, build_criterion(config),
                                 opt_g, opt_d, group=group)
        step = factory(True, True, True)
        metrics = []
        for s, shard in enumerate(shards):
            _, m = step(state, shard[rank],
                        step_generator(0, s, rank=rank, world=2),
                        step_generator(0, s, SHARED_STREAM))
            metrics.append(float(m["vq_codes_used"]))
        return state.tensors(), metrics

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' arithmetic: one thread each
    try:
        emulation = run_ranks(group, emulated)
    finally:
        torch.set_num_threads(threads)
    ranks = ranks.result()
    _assert_replicas_equal(ranks)
    used = [m["vq_codes_used"] for m in ranks[0]["metrics"]]
    assert all(1 <= u < 16 for u in used), used  # codes were dead
    assert emulation[0][1] == emulation[1][1] == used
    for name, t in emulation[0][0].items():
        assert torch.equal(t, ranks[0]["tensors"][name]), name


def test_collectives_of_the_emulated_group():
    """Sums and means through one bucket per dtype, metrics averaged,
    broadcast from rank 0; a global batch the ranks cannot share raises
    with both numbers."""
    group = ThreadGroup(2)

    def body(rank):
        def fresh():
            return [torch.tensor([1.0, 2.0]) * (rank + 1),
                    torch.tensor([[3, 4]], dtype=torch.int64) * (rank + 1),
                    torch.tensor(float(rank))]

        given = fresh()
        sums = group.all_reduce_sum(given)  # in place, in their dtypes
        assert all(s is g for s, g in zip(sums, given))
        means = group.all_reduce_mean(fresh()[::2])
        metric = torch.tensor(2.0 * rank)
        metrics = group.mean_metrics({"x": metric})
        assert float(metric) == 2.0 * rank
        own = torch.full((3,), float(rank))
        group.broadcast_tensors_([own])
        return sums, means, metrics, own

    for sums, means, metrics, own in run_ranks(group, body):
        assert torch.equal(sums[0], torch.tensor([3.0, 6.0]))
        assert torch.equal(sums[1], torch.tensor([[9, 12]]))
        assert sums[1].dtype == torch.int64 and float(sums[2]) == 1.0
        assert torch.equal(means[0], torch.tensor([1.5, 3.0]))
        assert float(means[1]) == 0.5 and float(metrics["x"]) == 1.0
        assert torch.equal(own, torch.zeros(3))
    assert per_rank_batch(6, 2) == 3
    with pytest.raises(ValueError, match="batch_size 3 .* world size 2"):
        per_rank_batch(3, 2)
    config = _pwg_config()
    state, gen, dis, opt_g, opt_d = init_train_state(
        dict(config, batch_size=3), 0, "cpu")
    with pytest.raises(ValueError, match="batch_size 3"):
        build_steps(dict(config, batch_size=3), gen, dis,
                    build_criterion(config), opt_g, opt_d, group=group)
    assert isinstance(group, Group)


def test_launcher_environment(tmp_path):
    """The JAX launcher's flags and variables (plus LOCAL_WORLD_SIZE), a
    command with ``-c``, and a failed rank ending the run: the launcher
    terminates the rank still waiting and raises its exit code."""
    script = tmp_path / "echo_rank.py"
    script.write_text(
        "import os\n"
        "print('RANK', os.environ['RANK'], 'WORLD', os.environ['WORLD_SIZE'],"
        " 'LOCAL', os.environ['LOCAL_RANK'], os.environ['LOCAL_WORLD_SIZE'],"
        " os.environ['MASTER_ADDR'], os.environ['MASTER_PORT'])\n")
    result = subprocess.run(
        [sys.executable, "-m", "parallelwavegan_torch.distributed.launch",
         "--nnodes", "2", "--node_rank", "1", "--nproc_per_node", "2",
         "--master_port", "29511", str(script)],
        capture_output=True, text=True, cwd=REPO, env=_env(), timeout=120)
    assert result.returncode == 0, result.stderr
    assert "RANK 2 WORLD 4 LOCAL 0 2 127.0.0.1 29511" in result.stdout
    assert "RANK 3 WORLD 4 LOCAL 1 2 127.0.0.1 29511" in result.stdout
    args = launch.parse_args(["-c", "--nproc_per_node", "3", "echo", "x"])
    envs = launch.rank_environments(args)
    assert [e["RANK"] for e in envs] == ["0", "1", "2"]
    assert args.command and args.training_script_args == ["x"]

    failing = tmp_path / "fail_one.py"
    failing.write_text(
        "import os, sys, time\n"
        "if os.environ['RANK'] == '1':\n    sys.exit(3)\n"
        "time.sleep(120)\n")
    result = subprocess.run(
        [sys.executable, "-m", "parallelwavegan_torch.distributed.launch",
         "--nproc_per_node", "2", str(failing)],
        capture_output=True, text=True, cwd=REPO, env=_env(), timeout=60)
    assert result.returncode != 0
    assert "returned non-zero exit status 3" in result.stderr


def _write_dumps(root, config, n=4):
    rng = np.random.default_rng(0)
    os.makedirs(root)
    hop = config["hop_size"]
    for i in range(n):
        frames = 40 + 4 * i
        t = np.arange(frames * hop) / config["sampling_rate"]
        wave = 0.3 * np.sin(2 * np.pi * 200 * (i + 1) * t) \
            + 0.01 * rng.standard_normal(t.shape)
        np.save(os.path.join(root, f"utt{i}-wave.npy"),
                wave.astype(np.float32))
        np.save(os.path.join(root, f"utt{i}-feats.npy"),
                rng.standard_normal((frames, config["num_mels"]))
                .astype(np.float32))


def test_two_rank_train_cli_writes_one_checkpoint_and_config(tmp_path):
    """``bin.train --device cpu`` on two ranks through the launcher: each
    rank on gloo, rank 0 alone writes ``config.yml`` and the checkpoint,
    which loads back with the steps taken."""
    config = _pwg_config()
    config.update(batch_size=2, batch_max_steps=1024, train_max_steps=3,
                  save_interval_steps=100, eval_interval_steps=100,
                  log_interval_steps=1, discriminator_train_start_steps=1,
                  num_save_intermediate_results=1)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    dump = tmp_path / "dump"
    _write_dumps(str(dump), config)
    out = tmp_path / "exp"
    result = _launch(["-c", sys.executable, "-m",
                      "parallelwavegan_torch.bin.train",
                      "--train-dumpdir", str(dump), "--dev-dumpdir", str(dump),
                      "--outdir", str(out), "--config", str(path),
                      "--device", "cpu"])
    assert result.returncode == 0, result.stdout + result.stderr
    assert result.stdout.count("backend gloo") == 2, result.stdout
    # beside them a TensorBoard event file, where tensorboardX is installed
    written = sorted(f for f in os.listdir(out) if not f.startswith("events"))
    assert written == ["checkpoint-3steps.ckpt", "config.yml"], written
    with open(out / "config.yml") as f:
        assert yaml.safe_load(f)["batch_size"] == 2
    state = init_train_state(config, 0, device="cpu")[0]
    from parallelwavegan_torch.engine.checkpoint import load_checkpoint

    load_checkpoint(str(out / "checkpoint-3steps.ckpt"), state)
    assert state.steps == 3 and state.opt_g.count == 2
