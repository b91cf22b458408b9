"""Training traffic: the recipe's loop, as ``Trainer._train_epoch`` runs it.

Set-up writes a seeded corpus in the recipe's own dump format under the
run's ``TMPDIR`` (LJSpeech lengths; mel and audio cropped together from the
repository's asset utterances), builds the loader with
``bin.train.build_loader`` and the ``Trainer``, loads the weights made from
the seed into both networks, and sets the step counter past
``discriminator_train_start_steps`` so that every step is the full (G,
adv, D) step. Its first steps are the check's: they go through the same
loader and ``Trainer._train_step`` as the window's, and what they took and
left (the batches, each step's losses, the optimizers' first moments after
one step, the parameters after the last) is kept for the reference, which
follows them after the window has closed. The window then iterates the
loader and calls ``_train_step`` until the time is up, and waits for the
card before it closes.

What belongs to the family (its parameters, its step in the reference,
the check of the loader's rows) comes from the training reference the
configuration names (``portbench.train_reference``; see
``portbench/reference/pwg_train.py`` for what it gives).
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from portbench.core import weights as weights_lib
from portbench.core.lengths import Assets, length_pool
from portbench.core.manifest import plugin
from portbench.core.serve import TRACED_SHARE, sub_seed
from portbench.core.trace import Profiler, span

# steps the reference follows (RAdam rectifies from its sixth update on,
# as every step of the window does: the last three checked steps are
# rectified); then steps of warm-up before the window
CHECK_STEPS, WARM_STEPS = 8, 2

Params = Dict[str, torch.Tensor]


def leaf_norms(tensors: Params) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   keep: List[str]) -> Tuple[float, str]:
    """max over ``keep`` of |got - want| / max(want, the median leaf's
    want), and the leaf that gives it."""
    ordered = sorted(want[k] for k in keep)
    median = ordered[len(ordered) // 2]
    worst, where = 0.0, ""
    for k in keep:
        gap = abs(got[k] - want[k]) / max(want[k], median, 1e-30)
        if gap > worst:
            worst, where = gap, k
    return worst, where


def _first_moments(state: dict) -> Dict[str, torch.Tensor]:
    """The ``mu`` tree of an optimizer's state (clip, RAdam, rate)."""
    if "mu" in state:
        return state["mu"]
    for value in state.values():
        if isinstance(value, dict):
            found = _first_moments(value)
            if found:
                return found
    return {}


class Training:
    def __init__(self, root: str, config: dict, traffic: dict, seed: int,
                 device: str, clock: Dict[str, float]):
        from parallelwavegan_torch.bin.train import build_dataset, build_loader
        from parallelwavegan_torch.engine.trainer import Trainer
        from parallelwavegan_torch.utils import hdf5_lite

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.ref = plugin(config, "train_reference")
        self.tmp = tempfile.mkdtemp(prefix="portbench-train-")
        hop = config["hop_size"]

        t = time.perf_counter()
        assets = Assets(root, with_audio=True)
        lengths = length_pool(traffic["lengths"])
        rng = np.random.default_rng(sub_seed(seed, 1))
        dump = os.path.join(self.tmp, "dump")
        os.makedirs(dump)
        self.corpus: List[tuple] = []
        for k, n in enumerate(lengths):
            mel, audio = assets.utterance(int(n), rng, hop)
            self.corpus.append((audio, mel))
            hdf5_lite.write(os.path.join(dump, f"utt{k:04d}.h5"),
                            {"wave": audio, "feats": mel})
        clock["data"] = time.perf_counter() - t

        t = time.perf_counter()
        loader_seed = sub_seed(seed, 5) % 2 ** 31
        dataset = build_dataset(config, dump)
        # every utterance read once, as after a first epoch (``allow_cache``):
        # the recipe's steady state, 183 epochs over LJSpeech in 400,000 steps
        for k in range(len(dataset)):
            dataset[k]
        loader = build_loader(config, dataset, loader_seed)
        self.trainer = Trainer(config, loader, None, seed=loader_seed,
                               outdir=os.path.join(self.tmp, "exp"),
                               device=device)
        shapes = self.ref.shapes(config)
        tree = weights_lib.seeded({f"{net}.{k}": v for net in ("G", "D")
                                   for k, v in shapes[net].items()},
                                  seed, device)
        self.g0 = {k[2:]: v for k, v in tree.items() if k.startswith("G.")}
        self.d0 = {k[2:]: v for k, v in tree.items() if k.startswith("D.")}
        with torch.no_grad():
            self.trainer.state.generator.load_state_dict(self.g0, strict=True)
            self.trainer.state.discriminator.load_state_dict(self.d0,
                                                             strict=True)
        start = int(traffic["start_step"])
        self.trainer.steps = self.trainer.state.steps = start
        self.epoch = 0
        self.batches = iter(loader)
        self.step_seconds = 0.0
        clock["weights"] = time.perf_counter() - t

    def next_batch(self) -> Dict[str, np.ndarray]:
        while True:
            try:
                return next(self.batches)
            except StopIteration:
                self.epoch += 1
                self.trainer.train_loader.set_epoch(self.epoch)
                self.batches = iter(self.trainer.train_loader)

    def check_steps(self) -> Dict[str, Any]:
        """The first steps, through the window's loader and call; what the
        reference follows."""
        trainer = self.trainer
        seen: Dict[str, float] = {}
        out: Dict[str, Any] = {"batches": [], "losses": []}
        for k in range(CHECK_STEPS):
            batch = self.next_batch()
            out["batches"].append(batch)
            trainer._train_step(batch)
            losses = {}
            for name in self.ref.LOSSES:
                total = float(trainer.total_train_loss[f"train/{name}"])
                losses[name] = total - seen.get(name, 0.0)
                seen[name] = total
            out["losses"].append(losses)
            if k == 0:
                out["grad_g"] = self._first_grads(trainer.state.opt_g,
                                                  "generator")
                out["grad_d"] = self._first_grads(trainer.state.opt_d,
                                                  "discriminator")
        with torch.no_grad():
            out["change_g"] = leaf_norms(
                {k: v - self.g0[k] for k, v in trainer.state.params_g.items()})
            out["change_d"] = leaf_norms(
                {k: v - self.d0[k] for k, v in trainer.state.params_d.items()})
        return out

    def _first_grads(self, opt, net: str) -> Dict[str, float]:
        """Each leaf's norm of the gradient the optimizer got at its first
        update: mu / (1 - b1) after one step."""
        b1 = self.config.get(f"{net}_optimizer_params", {}).get(
            "betas", (0.9, 0.999))[0]
        mu = _first_moments(opt.state)
        return {k: float(torch.linalg.vector_norm(v.double())) / (1 - b1)
                for k, v in mu.items()}

    def warm_up(self, steps: int) -> None:
        t = time.perf_counter()
        for _ in range(steps):
            self.trainer._train_step(self.next_batch())
        self._sync()
        self.step_seconds = (time.perf_counter() - t) / max(steps, 1)

    def window(self, seconds: float, trace: bool) -> Dict[str, Any]:
        """Steps until ``seconds`` have passed, then a wait for the card;
        with ``trace``, the last ``TRACED_SHARE`` of the window (two steps
        at the least) is profiled."""
        trainer = self.trainer
        waits: List[float] = []
        prof = Profiler() if trace else None
        log_span = _LogSpan(trainer)
        steps = traced_from = 0
        t0 = time.perf_counter()
        while True:
            elapsed = time.perf_counter() - t0
            if prof is not None and not prof.active and seconds - elapsed \
                    <= max(TRACED_SHARE * seconds, 2 * self.step_seconds):
                prof.start()
                log_span.__enter__()
                traced_from = steps
            # a traced run traces one step at the least, even where a slow
            # step crossed the window's end before the profiler started
            if elapsed >= seconds and (prof is None or steps > traced_from):
                break
            t = time.perf_counter()
            with span("loader_next"):
                batch = self.next_batch()
            waits.append(time.perf_counter() - t)
            with span("step"):
                trainer._train_step(batch)
            steps += 1
        with span("sync"):
            self._sync()
        t1 = time.perf_counter()
        peak = (torch.cuda.max_memory_allocated()
                if self.device == "cuda" else 0)
        out = {"t0": t0, "t1": t1, "steps": steps, "waits": waits,
               "memory_peak": peak, "attempted": steps, "failed": 0}
        if prof is not None and prof.active:
            log_span.__exit__()
            out["trace"] = prof.stop()
            out["traced_steps"] = steps - traced_from
        return out

    def _sync(self) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()

    def free_program(self) -> None:
        self.trainer = None
        self.batches = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, kept: Dict[str, Any]) -> Dict[str, float]:
        """The numbers ``correct`` is decided on: the reference's steps
        against the program's, and the loader's rows."""
        numbers = compare_training(program_follow(kept),
                                   reference_follow(self, kept["batches"]))
        numbers["bad_windows"] = float(self.ref.bad_rows(
            self.config, self.corpus, kept["batches"]))
        return numbers

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


class _LogSpan:
    """A ``log`` span around the trainer's log-interval check, for the
    traced stretch only (an instance attribute over the method)."""

    def __init__(self, trainer):
        self.trainer = trainer

    def __enter__(self):
        original = self.trainer._check_log_interval

        def check():
            with span("log"):
                original()

        self.trainer._check_log_interval = check
        return self

    def __exit__(self, *exc):
        del self.trainer._check_log_interval
        return False


def reference_follow(training: Training, batches: List[dict],
                     tf32: bool = False, rows: slice = slice(None)
                     ) -> Dict[str, Any]:
    """The reference's first steps from the benchmark's weights on the
    kept batches (only ``rows`` of each, where given: a fault), in float32
    with TF32 off (on for ``tf32``: the control): each step's losses,
    each leaf's first gradient and its largest over the steps, each
    leaf's change after the steps."""
    dev = training.device
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    out: Dict[str, Any] = {"losses": [], "grad_max": {}}
    try:
        step = training.ref.Step(training.config, training.g0, training.d0)
        for k, batch in enumerate(batches):
            losses, gg, gd = step({n: torch.from_numpy(v[rows]).to(dev)
                                   for n, v in batch.items()})
            out["losses"].append(losses)
            norms = {**_tagged("G", leaf_norms(gg)),
                     **_tagged("D", leaf_norms(gd))}
            if k == 0:
                out["grad"] = norms
            for n, v in norms.items():
                out["grad_max"][n] = max(out["grad_max"].get(n, 0.0), v)
        out["change"] = {
            **_tagged("G", leaf_norms(
                {n: step.g[n] - training.g0[n] for n in step.g})),
            **_tagged("D", leaf_norms(
                {n: step.d[n] - training.d0[n] for n in step.d}))}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return out


def _tagged(tag: str, norms: Dict[str, float]) -> Dict[str, float]:
    return {f"{tag}.{n}": v for n, v in norms.items()}


def program_follow(kept: Dict[str, Any]) -> Dict[str, Any]:
    """What the program's first steps left, in ``reference_follow``'s
    form."""
    return {"losses": kept["losses"],
            "grad": {**_tagged("G", kept["grad_g"]),
                     **_tagged("D", kept["grad_d"])},
            "change": {**_tagged("G", kept["change_g"]),
                       **_tagged("D", kept["change_d"])}}


def compare_training(got: Dict[str, Any], want: Dict[str, Any]
                     ) -> Dict[str, float]:
    """The worst step's relative loss gap, and by the worst leaf the gap
    of the first gradient's norm and of the change's norm, against the
    leaf's own or the median leaf's norm, whichever is larger; leaves whose
    reference gradient stays under a thousandth of the median leaf's are
    left out of the change."""
    loss_gap = max(abs(g[n] - w[n]) / abs(w[n])
                   for g, w in zip(got["losses"], want["losses"]) for n in w)
    ordered = sorted(want["grad_max"].values())
    median = ordered[len(ordered) // 2]
    moving = [n for n, v in want["grad_max"].items() if v >= 1e-3 * median]
    grad_gap, grad_leaf = worst_leaf_gap(
        got["grad"], want["grad"], list(want["grad"]))
    change_gap, change_leaf = worst_leaf_gap(
        got["change"], want["change"], moving)
    print(f"portbench: worst leaves: gradient {grad_leaf}, change "
          f"{change_leaf}", file=sys.stderr)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}
