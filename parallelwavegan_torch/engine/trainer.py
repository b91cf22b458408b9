"""Trainer: the host-side loop around the GAN train step.

Counterpart of ``parallelwavegan_tpu/engine/trainer.py``: interval-driven
logging (TensorBoard when ``tensorboardX`` is installed), eval epochs with
wav/plot dumps, checkpoint save and resume, warm-up gating of the G and D
updates (which selects the step variant), and a final checkpoint on exit.
Device work stays in ``engine.step``. Metrics accumulate on the device and
are read back only at the log interval, so the loop does not wait for the
card every step. Each step gets a random source (``step.step_generator``)
seeded from the run's seed and the state's step count (each eval epoch one
of its own), so a run resumed from a ``.ckpt`` draws StyleMelGAN's noise
and windows, and a VQ-VAE's restarted codes, as an unbroken run does; the
restart's gate comes from the stream ``SHARED_STREAM`` of the same seed
and step, UHiFiGAN's dropout masks from the stream ``DROPOUT_STREAM``,
seeded on the models' device.

Data-parallel (started by ``distributed/launch.py``, the process group
joined by ``parallel.dist.init_distributed``): every rank builds the same
seeded state and takes rank 0's by broadcast (``replicate``: after the
init, ``--pretrain`` and ``--resume``), its step all-reduces (the step's
``group``), each rank's step generators fold in its rank (``SHARED_STREAM``
excepted), and only rank 0 logs, writes checkpoints and dumps intermediate
results, as the JAX trainer's ``process_index() == 0``. Every rank runs
the evaluation on the whole dev loader, so the ranks stay in step.

The profiler hook of the JAX trainer: a config with ``profile_dir``
traces the steps [``profile_start_step``, ``profile_start_step`` +
``profile_num_steps``) (defaults 10 and 5) that run a step function (a
warm-up step that trains nothing is skipped, and a window that starts on
one never opens, as in JAX), on ``torch.profiler`` with the CPU and, on a
card, the CUDA activities; rank 0 alone traces and writes the Chrome trace
``<profile_dir>/rank0-steps<first>-<last>.pt.trace.json``, each step under
a ``train_step <n>`` range. If the run ends inside the window the
trace of the steps run so far is still written, where the JAX trace is
never stopped. There is no ``--profile-dir`` flag (the JAX CLI has none).
Inside each ``train_step <n>`` range the trace holds the loop's spans
(``utils/tracing.py``; they record under any profiler open in the
process): ``train.rng`` (the step's three random sources), ``train.h2d``
(the batch's copy to the device), the step function's phases
``step.g_forward``, ``step.g_loss``, ``step.g_backward``,
``step.g_update``, ``step.d_recompute``, ``step.d_loss``,
``step.d_backward``, ``step.d_update`` (those the step variant runs, and
``step.all_reduce`` around each data-parallel collective), then
``train.accumulate`` and, where an interval falls, ``train.log``,
``train.eval`` and ``train.save``; the loader's ``data.wait`` lies before
the range, its worker's ``data.collate`` on its own thread, and Python's
collections are ``host.gc`` ranges wherever they fall.

Not carried over from the JAX trainer: ``dispatch_queue_depth``, which
bounds that package's unbounded asynchronous dispatch queue; the CUDA
runtime bounds its own launch queue.

Runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
import os
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np
import torch

from parallelwavegan_torch.engine import checkpoint as ckpt_lib
from parallelwavegan_torch.engine.build import init_train_state
from parallelwavegan_torch.engine.criterion import build_criterion
from parallelwavegan_torch.engine.step import (
    DROPOUT_STREAM,
    SHARED_STREAM,
    build_steps,
    make_generator_forward,
    step_generator,
    with_noise,
)
from parallelwavegan_torch.parallel.dist import (
    default_group,
    rank,
    world_size,
)
from parallelwavegan_torch.utils import tracing


class Trainer:
    def __init__(
        self,
        config: Dict[str, Any],
        train_loader,
        eval_loader=None,
        seed: int = 0,
        outdir: Optional[str] = None,
        device: Any = "cuda",
    ):
        self.config = config
        self.seed = seed
        self.outdir = outdir or config.get("outdir", "exp")
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        (self.state, self.generator, self.discriminator, opt_g, opt_d) = (
            init_train_state(config, seed, device)
        )
        self.device = next(self.generator.parameters()).device
        self.group = default_group()
        self.rank, self.world = rank(), world_size()
        self.is_main = self.rank == 0
        self.criterion = build_criterion(config)
        self.train_step_factory, self.eval_step = build_steps(
            config, self.generator, self.discriminator, self.criterion,
            opt_g, opt_d, group=self.group,
        )
        self.replicate()
        self.gen_forward = make_generator_forward(config, self.generator)

        self.steps = 0
        self.epochs = 0
        self.finish_train = False
        self.total_train_loss: Dict[str, Any] = defaultdict(float)
        # the averages last logged, as floats
        self.last_train_loss: Dict[str, float] = {}
        self.last_eval_loss: Dict[str, float] = {}
        self._accum_steps = 0
        self._log_tic = time.time()
        # the open torch.profiler of the profile window, and the trace file
        # written when it closed
        self.profiler = None
        self.profile_trace: Optional[str] = None
        self.writer = None
        if self.outdir and self.is_main:
            os.makedirs(self.outdir, exist_ok=True)
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(self.outdir)
            except Exception as e:  # pragma: no cover
                logging.warning(f"tensorboard disabled: {e}")

    # ------------------------------------------------------------------
    def _flags(self):
        g_start = self.config.get("generator_train_start_steps", 0)
        d_start = self.config.get("discriminator_train_start_steps", 100000)
        train_g = self.steps > g_start
        use_adv = self.steps > d_start
        train_d = self.steps > d_start
        return train_g, use_adv, train_d

    def replicate(self) -> None:
        """Every rank takes rank 0's state (``GANTrainState.tensors``), as
        the reference's DDP broadcasts at its start; nothing for one
        process."""
        if self.group is not None:
            self.group.broadcast_tensors_(list(self.state.tensors().values()))

    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """The batch on the models' device; a token generator's ids are
        checked against its tables first, on the host."""
        if hasattr(self.generator, "check_ids"):
            self.generator.check_ids(batch["c"])
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            tracing.count_transfer(v, self.device)
            out[k] = v.to(self.device, non_blocking=True)
        return out

    def _train_step(self, batch):
        train_g, use_adv, train_d = self._flags()
        if not (train_g or train_d):
            # warm-up step that trains nothing: only the counters move
            self.state.steps += 1
            self.steps += 1
            return
        step_fn = self.train_step_factory(train_g, use_adv, train_d)
        steps = self.state.steps
        ranks = dict(rank=self.rank, world=self.world)
        self._maybe_profile()
        n = self.steps
        with tracing.span("train.step", n, f"train_step {n}"):
            with tracing.span("train.rng"):
                rngs = (step_generator(self.seed, steps, **ranks),
                        step_generator(self.seed, steps, SHARED_STREAM),
                        step_generator(self.seed, steps, DROPOUT_STREAM,
                                       self.device, **ranks))
            with tracing.span("train.h2d"):
                batch = self._to_device(batch)
            self.state, metrics = step_fn(self.state, batch, *rngs)
            with tracing.span("train.accumulate"):
                for k, v in metrics.items():
                    # stays on the device
                    self.total_train_loss[f"train/{k}"] += v
            self._accum_steps += 1
            self.steps += 1
            self._check_log_interval()
            self._check_eval_interval()
            self._check_save_interval()
        if self.steps >= self.config["train_max_steps"]:
            self.finish_train = True

    def _train_epoch(self):
        self.train_loader.set_epoch(self.epochs)
        n = 0
        for n, batch in enumerate(self.train_loader, 1):
            self._train_step(batch)
            if self.finish_train:
                break
        self.epochs += 1
        if n == 0:
            raise RuntimeError(
                "The training data loader produced 0 batches: dataset "
                "smaller than batch size, or all utterances were filtered."
            )
        logging.info(
            f"(Steps: {self.steps}) Finished {self.epochs} epoch training "
            f"({n} steps per epoch)."
        )

    def run(self):
        """Train until ``train_max_steps``; always leaves a final
        checkpoint in ``outdir``."""
        self._log_tic = time.time()
        try:
            while not self.finish_train:
                self._train_epoch()
        finally:
            self._stop_profile()
            if self.is_main:
                self.save_checkpoint(os.path.join(
                    self.outdir, f"checkpoint-{self.steps}steps.ckpt"))
        logging.info(f"Finished training ({self.steps} steps).")

    # ------------------------------------------------------------------
    def _maybe_profile(self) -> None:
        """Open the trace before step ``profile_start_step`` and close it
        before step ``profile_start_step + profile_num_steps``, as the JAX
        trainer's hook (called before each step function)."""
        profile_dir = self.config.get("profile_dir")
        if not profile_dir or not self.is_main:
            return
        start = int(self.config.get("profile_start_step", 10))
        n = int(self.config.get("profile_num_steps", 5))
        if self.profiler is None and self.steps == start:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self.profiler = profile(activities=activities)
            self.profiler.__enter__()
            self._profile_first = self.steps
            logging.info(f"profiler trace started -> {profile_dir}")
        elif self.profiler is not None and self.steps >= start + n:
            self._stop_profile()

    def _stop_profile(self) -> None:
        """Close an open trace and write it; the path is kept in
        ``profile_trace``."""
        if self.profiler is None:
            return
        prof, self.profiler = self.profiler, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        profile_dir = self.config["profile_dir"]
        os.makedirs(profile_dir, exist_ok=True)
        self.profile_trace = os.path.join(
            profile_dir, f"rank{self.rank}-steps{self._profile_first}-"
            f"{self.steps - 1}.pt.trace.json")
        prof.export_chrome_trace(self.profile_trace)
        logging.info(f"profiler trace stopped -> {self.profile_trace}")

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str):
        ckpt_lib.save_checkpoint(path, self.state)
        logging.info(f"Successfully saved checkpoint @ {self.steps} steps.")

    def load_checkpoint(self, path: str, load_only_params: bool = False):
        if load_only_params:
            ckpt_lib.load_params_only(path, self.state, config=self.config)
        else:
            ckpt_lib.load_checkpoint(path, self.state)
            self.steps = self.state.steps
        self.replicate()

    # ------------------------------------------------------------------
    def _check_log_interval(self):
        interval = self.config.get("log_interval_steps", 100)
        if self.steps % interval == 0 and self.total_train_loss:
            with tracing.span("train.log"):
                # divide by the steps that contributed: after warm-up ends or a
                # resume lands mid-interval, fewer than `interval` accumulated
                n_accum = max(self._accum_steps, 1)
                for key in sorted(self.total_train_loss):
                    self.total_train_loss[key] = (
                        float(self.total_train_loss[key]) / n_accum
                    )
                    if self.is_main:
                        logging.info(f"(Steps: {self.steps}) {key} = "
                                     f"{self.total_train_loss[key]:.4f}.")
                if self.writer:
                    for k, v in self.total_train_loss.items():
                        self.writer.add_scalar(k, v, self.steps)
                    self.writer.add_scalar(
                        "train/steps_per_sec",
                        n_accum / max(time.time() - self._log_tic, 1e-6),
                        self.steps,
                    )
                self._log_tic = time.time()
                self.last_train_loss = dict(self.total_train_loss)
                self.total_train_loss = defaultdict(float)
                self._accum_steps = 0

    def _check_save_interval(self):
        interval = self.config.get("save_interval_steps", 10000)
        if self.steps % interval == 0 and self.is_main:
            with tracing.span("train.save"):
                self.save_checkpoint(os.path.join(
                    self.outdir, f"checkpoint-{self.steps}steps.ckpt"))

    def _check_eval_interval(self):
        interval = self.config.get("eval_interval_steps", 1000)
        if self.steps % interval == 0 and self.eval_loader is not None:
            with tracing.span("train.eval"):
                self._eval_epoch()

    # ------------------------------------------------------------------
    def _eval_epoch(self):
        logging.info(f"(Steps: {self.steps}) Start evaluation.")
        totals: Dict[str, Any] = defaultdict(float)
        n_batches = 0
        _, use_adv, _ = self._flags()
        first_batch = None
        rng = step_generator(self.seed, self.state.steps, stream=1)
        for n_batches, batch in enumerate(self.eval_loader, 1):
            batch = self._to_device(batch)
            if first_batch is None:
                first_batch = batch
            metrics = self.eval_step(self.state, batch, use_adv, rng)
            for k, v in metrics.items():
                totals[f"eval/{k}"] += v  # on the device; read back below
        for k in totals:
            totals[k] = float(totals[k]) / max(n_batches, 1)
            if self.is_main:
                logging.info(
                    f"(Steps: {self.steps}) {k} = {totals[k]:.4f}.")
        if self.writer:
            for k, v in totals.items():
                self.writer.add_scalar(k, v, self.steps)
        self.last_eval_loss = dict(totals)
        if first_batch is not None and self.is_main:
            self._generate_and_save_intermediate_result(first_batch)

    def _generate_and_save_intermediate_result(self, batch):
        """Dump a few generated/reference wav pairs and plots. The batch
        goes to the generator as the loader gave it: a VQ-VAE at
        ``in_channels`` > 1 is not given its PQMF subbands here, and its
        dump fails with a warning, as in the JAX trainer."""
        try:
            from parallelwavegan_torch.utils.io import write_wav

            batch = with_noise(self.generator, batch,
                               step_generator(self.seed, self.state.steps, 2))
            with torch.no_grad():
                y_hat = self.gen_forward(self.state.params_g, batch)[0]
                if self.config.get("generator_params", {}).get(
                        "out_channels", 1) > 1:  # subbands -> one band
                    y_hat = self.criterion["pqmf"].synthesis(y_hat)
            y_hat = y_hat.float().cpu().numpy()
            y = batch["y"].float().cpu().numpy()
            dirname = os.path.join(
                self.outdir, "predictions", f"{self.steps}steps"
            )
            os.makedirs(dirname, exist_ok=True)
            sr = self.config.get("sampling_rate", 22050)
            n_dump = self.config.get("num_save_intermediate_results", 4)
            for idx in range(min(n_dump, len(y))):
                write_wav(os.path.join(dirname, f"{idx}_ref.wav"),
                          y[idx, :, 0], sr)
                write_wav(os.path.join(dirname, f"{idx}_gen.wav"),
                          y_hat[idx, :, 0], sr)
                self._save_plot(os.path.join(dirname, f"{idx}.png"),
                                y[idx, :, 0], y_hat[idx, :, 0])
        except Exception as e:  # pragma: no cover
            logging.warning(f"intermediate dump failed: {e}")

    @staticmethod
    def _save_plot(path, y, y_hat):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, axes = plt.subplots(2, 1, figsize=(6, 4))
            axes[0].plot(y)
            axes[0].set_title("groundtruth speech")
            axes[1].plot(y_hat)
            axes[1].set_title("generated speech")
            fig.tight_layout()
            fig.savefig(path)
            plt.close(fig)
        except Exception:  # pragma: no cover
            pass
