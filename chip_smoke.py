#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and builds every CUDA
   kernel from csrc/ with nvcc (one process per source, started together);
2. holds each kernel against its plain PyTorch version on the card (f32 and
   bf16, small and Parallel WaveGAN v1 shapes, ragged T, dilations past T):
   the stack forward, the forward with saved inputs, and every output of
   the backward;
3. drives the serving path at full PWG v1 width with seeded weights written
   to and read back from a .gckpt: InferenceModel on cuda, (a) batch 1 in
   f32 against the unfused plain generator, (b) batch 32 x 512 frames in
   bf16, whose run must launch the forward kernel 30 times;
4. times the forward, the stack kernel and its plain version with CUDA
   events;
5. drives the training path at full PWG v1 width: a seeded corpus of npy
   dumps, bin.train.run on cuda for 6 steps across the discriminator's
   start (batch 6 x 25,600 samples, f32), whose run must launch the forward
   and the backward kernel the expected number of times, end with finite
   losses under every name, changed G and D parameters and a .ckpt that
   loads back; then two resumed steps with mixed_precision;
6. holds one generator loss and gradient at that shape through the kernels
   against the same through their plain versions, times the (G, adv, D)
   step, both kernels at the training shape and the backward's plain
   version, and prints where a step's device time goes (torch.profiler);
7. prints a JSON line of kernels, the card line, and as the last line
   {"ok": true, "device": {...}}.

Exits non-zero, printing no result, on any failure or without a GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published dense peaks of an H100 SXM at 700 W (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
HOP, SR, BENCH_BATCH, BENCH_FRAMES = 256, 22050, 32, 512
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # x (1 + max|plain|)

TRAIN_BATCH, TRAIN_SAMPLES = 6, 25600

# Parallel WaveGAN v1 (egs/ljspeech/voc1/conf/parallel_wavegan.v1.yaml)
PWG_V1 = {
    "sampling_rate": SR,
    "hop_size": HOP,
    "num_mels": 80,
    "format": "npy",
    "generator_type": "ParallelWaveGANGenerator",
    "generator_params": {
        "in_channels": 1, "out_channels": 1, "kernel_size": 3, "layers": 30,
        "stacks": 3, "residual_channels": 64, "gate_channels": 128,
        "skip_channels": 64, "aux_channels": 80, "aux_context_window": 2,
        "dropout": 0.0, "use_weight_norm": True,
        "upsample_net": "ConvInUpsampleNetwork",
        "upsample_params": {"upsample_scales": [4, 4, 4, 4]},
    },
    "discriminator_type": "ParallelWaveGANDiscriminator",
    "discriminator_params": {
        "in_channels": 1, "out_channels": 1, "kernel_size": 3, "layers": 10,
        "conv_channels": 64, "bias": True, "use_weight_norm": True,
        "nonlinear_activation": "LeakyReLU",
        "nonlinear_activation_params": {"negative_slope": 0.2},
    },
    "stft_loss_params": {
        "fft_sizes": [1024, 2048, 512], "hop_sizes": [120, 240, 50],
        "win_lengths": [600, 1200, 240], "window": "hann_window",
    },
    "lambda_adv": 4.0,
    "batch_size": TRAIN_BATCH,
    "batch_max_steps": TRAIN_SAMPLES,
    "remove_short_samples": True,
    "allow_cache": True,
    "generator_optimizer_params": {"lr": 1e-4, "eps": 1e-6,
                                   "weight_decay": 0.0},
    "generator_scheduler_params": {"step_size": 200000, "gamma": 0.5},
    "generator_grad_norm": 10,
    "discriminator_optimizer_params": {"lr": 5e-5, "eps": 1e-6,
                                       "weight_decay": 0.0},
    "discriminator_scheduler_params": {"step_size": 200000, "gamma": 0.5},
    "discriminator_grad_norm": 1,
    # the yaml trains 400,000 steps with the discriminator from 100,000;
    # cut so that six steps cross the discriminator's start
    "discriminator_train_start_steps": 2,
    "train_max_steps": 6,
    "save_interval_steps": 6,
    "eval_interval_steps": 6,
    "log_interval_steps": 3,
}
LOSS_NAMES = (
    "spectral_convergence_loss", "log_stft_magnitude_loss",
    "adversarial_loss", "generator_loss", "real_loss", "fake_loss",
    "discriminator_loss",
)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a: torch.Tensor, b: torch.Tensor, dtype) -> tuple:
    """(max |a - b|, allowed) with allowed = tol * (1 + max |b|)."""
    a, b = a.float(), b.float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite values")
    return (a - b).abs().max().item(), TOL[dtype] * (1 + b.abs().max().item())


def stack_inputs(gen: torch.Generator, B, T, L, dtype, dev):
    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    w = {"w_tap": rnd(L, 3, 64, 128, scale=0.1), "b_tap": rnd(L, 128, scale=0.1),
         "w_aux": rnd(L, 80, 128, scale=0.1), "w_so": rnd(L, 64, 128, scale=0.1),
         "b_so": rnd(L, 128, scale=0.1)}
    return rnd(B, T, 64), rnd(B, T, 80), w


def check(what: str, got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    """Print and enforce max |got - want| <= TOL[dtype] * (1 + max |want|)."""
    err, allowed = max_err(got, want, dtype)
    print(f"{what}: max_abs_err {err:.3e} (allowed {allowed:.3e})")
    if err > allowed:
        raise AssertionError(f"{what} disagrees with its plain version")
    return err


def stack_grads(fn, x, c, w, dils, ux, us):
    """Gradients of sum(x_out * ux) + sum(skip * us) through ``fn`` with
    respect to x, c and every weight: {"dx", "dc", "w_tap", ...}."""
    x = x.detach().requires_grad_()
    c = c.detach().requires_grad_()
    w = {k: v.detach().requires_grad_() for k, v in w.items()}
    xo, sk = fn(x, c, w, dils)
    loss = (xo.float() * ux).sum() + (sk * us).sum()
    names = list(w)
    grads = torch.autograd.grad(loss, [x, c] + [w[k] for k in names])
    return dict(zip(["dx", "dc"] + names, grads))


def check_training_kernels(gen: torch.Generator, dev, cases) -> dict:
    """The forward kernel with saved inputs and the backward kernel against
    their plain versions (autograd through the plain forward), every
    output. The weight gradients are sums over B*T rows taken in another
    order than autograd's matmuls take them; relative to the largest
    entry that stays well inside the elementwise tolerance, so one
    tolerance holds for every output. Returns the largest error seen."""
    from parallelwavegan_torch.ops.cuda.wavenet_stack import (
        wavenet_stack,
        wavenet_stack_reference,
    )
    from parallelwavegan_torch.ops.cuda.wavenet_stack_train import (
        wavenet_stack_train,
        wavenet_stack_train_reference,
    )

    worst = {"wavenet_stack": 0.0, "wavenet_stack_backward": 0.0}
    for dtype, B, T, dils in cases:
        tag = (f"{str(dtype)[6:]} B={B} T={T} L={len(dils)} "
               f"max_d={max(dils)}")
        x, c, w = stack_inputs(gen, B, T, len(dils), dtype, dev)
        xo, sk, xs = wavenet_stack(x, c, w, dils, save_inputs=True)
        torch.cuda.synchronize()
        plain = wavenet_stack_reference(x, c, w, dils, save_inputs=True)
        for what, a, b in zip(("x", "skip", "xs"), (xo, sk, xs), plain):
            err = check(f"stack+save_inputs {tag} {what}", a, b, dtype)
            worst["wavenet_stack"] = max(worst["wavenet_stack"], err)
        ux = torch.randn(xo.shape, generator=gen).to(dev)
        us = torch.randn(sk.shape, generator=gen).to(dev)
        got = stack_grads(wavenet_stack_train, x, c, w, dils, ux, us)
        torch.cuda.synchronize()
        want = stack_grads(wavenet_stack_train_reference, x, c, w, dils, ux,
                           us)
        for what in want:
            err = check(f"stack backward {tag} {what}", got[what],
                        want[what], dtype)
            worst["wavenet_stack_backward"] = max(
                worst["wavenet_stack_backward"], err)
    return worst


def stack_bound_ms(B, T, L, dtype) -> tuple:
    """Least time for the stack call: operations at the type's peak vs
    bytes (x, c in; x out; skip out f32; weights) at the memory rate."""
    R, G, S, A = 64, 128, 64, 80
    flops = 2 * (3 * R * G + A * G + R * (S + R)) * B * T * L
    item = torch.finfo(dtype).bits // 8
    weights = L * (3 * R * G + G + A * G + R * (S + R) + S + R) * item
    nbytes = B * T * ((2 * R + A) * item + S * 4) + weights
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def backward_bound_ms(B, T, L, A, dtype) -> tuple:
    """Least time for the stack backward: 3 (3R + A) G + 2 R (S + R) MAC per
    row and layer at the type's peak vs the bytes that must move (xs, c and
    the cotangents in, dx and dc out, weights in, their gradients out). The
    gate product is recomputed and then transposed twice (dz . W^T and
    in^T . dz); the skip/out 1x1 is only transposed twice (dg = dso . Wso^T,
    dWso = g^T . dso): its forward output is never needed again."""
    R, G, S = 64, 128, 64
    flops = 2 * (3 * (3 * R + A) * G + 2 * R * (S + R)) * B * T * L
    item = torch.finfo(dtype).bits // 8
    weights = L * (3 * R * G + G + A * G + R * (S + R) + S + R) * item
    nbytes = (B * T * (L * R * item + A * item + S * 4 + 2 * R * item
                       + A * item) + 2 * weights)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def write_corpus(root: str, rng: np.random.Generator, n_utts: int = 8) -> None:
    """Seeded utterances as npy dumps: sines plus noise, and features of
    the right shape (frames, 80) drawn from the same seed."""
    os.makedirs(root)
    for i in range(n_utts):
        frames = 120 + 10 * i  # longer than the 100-frame training window
        t = np.arange(frames * HOP) / SR
        wave = sum(0.2 / (k + 1) * np.sin(2 * np.pi * (110 * (i + 1)) * (k + 1)
                                          * t) for k in range(3))
        wave = wave + 0.01 * rng.standard_normal(t.shape)
        np.save(os.path.join(root, f"utt{i}-wave.npy"),
                wave.astype(np.float32))
        np.save(os.path.join(root, f"utt{i}-feats.npy"),
                rng.standard_normal((frames, 80)).astype(np.float32))


def check_trainer(trainer, what: str) -> None:
    for split, losses in (("train", trainer.last_train_loss),
                          ("eval", trainer.last_eval_loss)):
        if split == "eval" and not losses:  # a run without an eval epoch
            continue
        if sorted(losses) != sorted(f"{split}/{n}" for n in LOSS_NAMES):
            raise AssertionError(f"{what}: {split} losses {sorted(losses)}")
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{what}: non-finite {split} loss {losses}")
        print(f"{what} {split}: " + ", ".join(
            f"{k.split('/')[1]} {v:.4f}" for k, v in sorted(losses.items())))


def training_phase(dev, smi: str) -> dict:
    """Steps 5 and 6 of the module docstring. Returns what the kernels line
    needs: launches on the training path, errors and times."""
    from parallelwavegan_torch.bin.train import run
    from parallelwavegan_torch.engine import checkpoint as ckpt
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.ops.cuda import pwg_infer
    from parallelwavegan_torch.ops.cuda.wavenet_stack import (
        wavenet_stack,
        wavenet_stack_reference,
    )
    from parallelwavegan_torch.ops.cuda.wavenet_stack_train import (
        wavenet_stack_backward,
        wavenet_stack_train,
        wavenet_stack_train_reference,
    )

    rng = np.random.default_rng(1)
    L = PWG_V1["generator_params"]["layers"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "dump")
        write_corpus(dump, rng)

        # 5. six f32 steps through the entry point a user calls. Steps 1..5
        # update G (step 0 trains nothing: the gates are strict), steps 3..5
        # add the adversarial loss and update D, step 6 evaluates one batch
        # and dumps its prediction.
        g_updates, d_updates, eval_forwards = 5, 3, 2
        initial, _, _, _, _ = init_train_state(PWG_V1, seed=0, device=dev)
        torch.cuda.synchronize()
        wavenet_stack.launches = wavenet_stack_backward.launches = 0
        t0 = time.perf_counter()
        trainer = run(PWG_V1, dump, dump, os.path.join(tmp, "exp"), seed=0,
                      device="cuda", dump_config=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["fwd_launches"] = wavenet_stack.launches
        out["bwd_launches"] = wavenet_stack_backward.launches
        print(f"training path f32 {TRAIN_BATCH} x {TRAIN_SAMPLES} samples: "
              f"{trainer.steps} steps in {wall:.1f} s wall (first calls), "
              f"wavenet_stack launches {out['fwd_launches']}, backward "
              f"launches {out['bwd_launches']}")
        if trainer.steps != 6 or trainer.device.type != "cuda":
            raise AssertionError("the trainer did not take 6 steps on cuda")
        if out["fwd_launches"] != L * (g_updates + d_updates + eval_forwards):
            raise AssertionError("unexpected forward kernel launches")
        if out["bwd_launches"] != L * g_updates:
            raise AssertionError("unexpected backward kernel launches")
        check_trainer(trainer, "training path f32")
        for name, module, start in (
            ("G", trainer.generator, initial.generator),
            ("D", trainer.discriminator, initial.discriminator),
        ):
            before = dict(start.named_parameters())
            moved = sum(not torch.equal(p, before[k])
                        for k, p in module.named_parameters())
            finite = all(torch.isfinite(p).all()
                         for p in module.parameters())
            print(f"  {name}: {moved} of {len(before)} parameters changed")
            # the last layer's residual 1x1 (v, g, bias) feeds nothing, and
            # first_conv's kernel_v has a zero gradient but for rounding
            if moved < len(before) - 4 or not finite:
                raise AssertionError(f"{name} parameters did not train")
        path = os.path.join(tmp, "exp", "checkpoint-6steps.ckpt")
        ckpt.load_checkpoint(path, initial)
        if initial.steps != 6 or initial.opt_g.count != g_updates \
                or initial.opt_d.count != d_updates:
            raise AssertionError("the .ckpt did not restore the counters")
        for module, loaded in ((trainer.generator, initial.generator),
                               (trainer.discriminator, initial.discriminator)):
            want = dict(module.named_parameters())
            for key, p in loaded.named_parameters():
                if not torch.equal(p, want[key]):
                    raise AssertionError(f".ckpt differs on {key}")
        print(f"  {os.path.basename(path)} "
              f"({os.path.getsize(path) / 1e6:.1f} MB) loads back")
        del initial

        # two more steps in mixed precision, resumed from that checkpoint
        mixed_config = dict(PWG_V1, mixed_precision=True, train_max_steps=8,
                            eval_interval_steps=1000, log_interval_steps=2,
                            save_interval_steps=1000)
        wavenet_stack.launches = wavenet_stack_backward.launches = 0
        mixed = run(mixed_config, dump, dump, os.path.join(tmp, "exp_mixed"),
                    resume=path, seed=0, device="cuda", dump_config=False)
        torch.cuda.synchronize()
        print(f"training path mixed precision: steps 6 -> {mixed.steps}, "
              f"wavenet_stack launches {wavenet_stack.launches}, backward "
              f"launches {wavenet_stack_backward.launches}")
        if mixed.steps != 8 or wavenet_stack.launches != 4 * L \
                or wavenet_stack_backward.launches != 2 * L:
            raise AssertionError("unexpected launches in mixed precision")
        check_trainer(mixed, "training path mixed")
        if any(p.dtype != torch.float32 for p in mixed.generator.parameters()):
            raise AssertionError("master parameters left float32")

        # 6. one generator loss and gradient at the training shape: through
        # the kernels, and through their plain versions
        batch = mixed._to_device(next(iter(mixed.train_loader)))
        gen, dis, crit = trainer.generator, trainer.discriminator, \
            trainer.criterion
        names = [n for n, _ in gen.named_parameters()]

        def loss_and_grads():
            y_ = gen(batch["z"], batch["c"], fused=True, trainable=True)
            sc, mag = crit["stft"](y_[..., 0], batch["y"][..., 0])
            loss = sc + mag + 4.0 * crit["gen_adv"](dis(y_))
            grads = torch.autograd.grad(loss, list(gen.parameters()),
                                        allow_unused=True)
            return loss.item(), dict(zip(names, grads))

        loss_k, grads_k = loss_and_grads()
        kernel_route = pwg_infer.wavenet_stack_train
        pwg_infer.wavenet_stack_train = wavenet_stack_train_reference
        try:
            loss_p, grads_p = loss_and_grads()
        finally:
            pwg_infer.wavenet_stack_train = kernel_route
        largest = max(g.abs().max().item() for g in grads_p.values()
                      if g is not None)
        worst = 0.0
        for key, want in grads_p.items():
            if want is None:
                continue
            err = (grads_k[key] - want).abs().max().item()
            # f32 sums in another order, then a log and a division by small
            # STFT magnitudes: 2e-3 of the gradient's largest entry plus
            # 2e-5 of the largest gradient in the network
            allowed = 2e-3 * want.abs().max().item() + 2e-5 * largest
            worst = max(worst, err / allowed)
            if not err <= allowed:
                raise AssertionError(f"generator gradient differs on {key}: "
                                     f"{err:.3e} > {allowed:.3e}")
        print(f"generator loss at the training shape: kernels {loss_k:.6f}, "
              f"plain {loss_p:.6f}; gradients of {len(names)} parameters "
              f"agree (largest {largest:.3e}, worst error {worst:.2f} of "
              f"its allowance)")
        if not abs(loss_k - loss_p) <= 1e-4 * abs(loss_p):
            raise AssertionError("generator loss differs from the plain one")
        del grads_k, grads_p

        # timing: the (G, adv, D) step in f32 and in mixed precision
        for what, t in (("f32", trainer), ("mixed", mixed)):
            step = t.train_step_factory(True, True, True)
            out[f"step_ms_{what}"] = time_ms(lambda: step(t.state, batch),
                                             reps=3)
        profile_step(trainer, batch, "f32")
        torch.cuda.reset_peak_memory_stats()
        trainer.train_step_factory(True, True, True)(trainer.state, batch)
        torch.cuda.synchronize()
        out["step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"(G, adv, D) step {TRAIN_BATCH} x {TRAIN_SAMPLES}: f32 "
              f"{out['step_ms_f32']:.1f} ms "
              f"({1e3 / out['step_ms_f32']:.2f} steps/s), mixed precision "
              f"{out['step_ms_mixed']:.1f} ms "
              f"({1e3 / out['step_ms_mixed']:.2f} steps/s), peak memory "
              f"{out['step_peak_gb']:.2f} GB on {smi}")

        # both kernels alone at the training shape, as the step calls them:
        # three groups of ten layers, f32, with the trained weights
        with torch.no_grad():
            w = pwg_infer.fuse_wavenet_stack_params(gen.conv_layers)
            c_up = gen.upsample_net(batch["c"]).contiguous()
            x0 = pwg_infer._conv1x1(gen.first_conv, batch["z"]).contiguous()
        dils = gen.dilations
        groups = [({k: v[g0:g0 + 10].contiguous() for k, v in w.items()},
                   tuple(dils[g0:g0 + 10])) for g0 in range(0, L, 10)]
        gen_t = torch.Generator().manual_seed(3)
        ux = torch.randn(x0.shape, generator=gen_t).to(dev)
        us = torch.randn(x0.shape, generator=gen_t).to(dev)
        wg, dg = groups[0]
        got = wavenet_stack(x0, c_up, wg, dg, save_inputs=True)
        torch.cuda.synchronize()
        with torch.no_grad():
            want = wavenet_stack_reference(x0, c_up, wg, dg, save_inputs=True)
        out["fwd_err"] = max(
            check(f"stack+save_inputs at the training shape f32 {k}", a, b,
                  torch.float32)
            for k, a, b in zip(("x", "skip", "xs"), got, want))
        xs = got[2]
        got = stack_grads(wavenet_stack_train, x0, c_up, wg, dg, ux, us)
        want = stack_grads(wavenet_stack_train_reference, x0, c_up, wg, dg,
                           ux, us)
        out["bwd_err"] = max(
            check(f"stack backward at the training shape f32 {k}", got[k],
                  want[k], torch.float32) for k in want)
        del got, want

        def forward_groups(save):
            x = x0
            for wg, dg in groups:
                x = wavenet_stack(x, c_up, wg, dg, save_inputs=save)[0]

        def backward_groups():
            for wg, dg in groups:
                wavenet_stack_backward(xs, c_up, wg, dg, ux, us)

        out["fwd_train_ms"] = time_ms(lambda: forward_groups(True), reps=3)
        out["fwd_infer_ms"] = time_ms(lambda: forward_groups(False), reps=3)
        out["bwd_ms"] = time_ms(backward_groups, reps=3)

        # the plain versions over the same three groups: the forward as
        # one chain, the backward as autograd over graphs built (untimed)
        # before each repetition and freed by it
        def forward_plain():
            x = x0
            for wg, dg in groups:
                x = wavenet_stack_reference(x, c_up, wg, dg)[0]

        with torch.no_grad():
            out["fwd_plain_ms"] = time_ms(forward_plain, reps=2)

        xr = x0.detach().requires_grad_()
        cr = c_up.detach().requires_grad_()
        plain = []
        for wg, dg in groups:
            wr = {k: v.detach().requires_grad_() for k, v in wg.items()}
            plain.append((wr, dg, [xr, cr] + list(wr.values())))

        def plain_backward_ms():
            losses = []
            for wr, dg, _ in plain:
                xo, sk = wavenet_stack_reference(xr, cr, wr, dg)
                losses.append((xo * ux).sum() + (sk * us).sum())
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for loss, (_, _, leaves) in zip(losses, plain):
                torch.autograd.grad(loss, leaves)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end)

        plain_backward_ms()  # warm-up
        out["bwd_plain_ms"] = sum(plain_backward_ms() for _ in range(2)) / 2
    B, T = x0.shape[:2]
    out["bwd_bound_ms"], out["bwd_bound_by"] = backward_bound_ms(
        B, T, L, c_up.shape[-1], torch.float32)
    out["fwd_bound_ms"], _ = stack_bound_ms(B, T, L, torch.float32)
    print(f"training shape f32 {B} x {T}, {L} layers in 3 groups: backward "
          f"kernel {out['bwd_ms']:.2f} ms (plain {out['bwd_plain_ms']:.2f} "
          f"ms, bound {out['bwd_bound_ms']:.2f} ms by "
          f"{out['bwd_bound_by']}); forward kernel with saved inputs "
          f"{out['fwd_train_ms']:.2f} ms, without "
          f"{out['fwd_infer_ms']:.2f} ms (plain {out['fwd_plain_ms']:.2f} "
          f"ms, bound {out['fwd_bound_ms']:.2f} ms) on {smi}")
    return out


def profile_step(trainer, batch, what: str) -> None:
    """Where one (G, adv, D) step's device time goes: torch.profiler over
    two steps, device time by kernel name. Printed, never a failure."""
    from torch.profiler import ProfilerActivity, profile

    step = trainer.train_step_factory(True, True, True)
    n = 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(trainer.state, batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = [(e.key, getattr(e, "device_time_total", 0.0) / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and "cuda" in str(e.device_type).lower()]
    busy = sum(ms for _, ms, _ in rows)
    if busy <= 0:
        print(f"step profile {what}: the profiler shows no device time")
        return
    print(f"step profile {what}: {wall_ms:.1f} ms wall a step under the "
          f"profiler, device busy {busy:.1f} ms; device time by kernel:")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:14]:
        print(f"  {ms:8.2f} ms {100 * ms / busy:5.1f} %  x{count:6.1f}  "
              f"{name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from parallelwavegan_torch.engine.checkpoint import (
        save_generator_checkpoint,
    )
    from parallelwavegan_torch.models import ParallelWaveGANGenerator
    from parallelwavegan_torch.ops.cuda.build import build_libraries
    from parallelwavegan_torch.ops.cuda.pwg_infer import _conv1x1
    from parallelwavegan_torch.ops.cuda.wavenet_stack import (
        wavenet_stack,
        wavenet_stack_reference,
    )
    from parallelwavegan_torch.utils.model_loader import load_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    # 1. build
    t0 = time.perf_counter()
    built = build_libraries(["wavenet_stack", "wavenet_stack_bwd"])
    print(f"build: {time.perf_counter() - t0:.1f} s wall")
    for name, info in built.items():
        print(f"  {name}: {info['seconds']:.1f} s -> {info['path']}")
        for line in str(info["log"]).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. kernel against plain on the card
    gen = torch.Generator().manual_seed(0)
    cases = [  # (dtype, B, T, dilations)
        (torch.float32, 2, 1000, (1, 2, 4, 1, 2, 4)),
        (torch.bfloat16, 2, 1000, (1, 2, 4, 1, 2, 4)),
        (torch.float32, 3, 300, tuple(2 ** (i % 10) for i in range(30))),
        (torch.bfloat16, 2, 4133, tuple(2 ** (i % 10) for i in range(30))),
        (torch.float32, 1, 77, (3,)),
        (torch.bfloat16, 1, 130, (512, 1)),
    ]
    for dtype, B, T, dils in cases:
        x, c, w = stack_inputs(gen, B, T, len(dils), dtype, dev)
        xo, sk = wavenet_stack(x, c, w, dils)
        torch.cuda.synchronize()
        xo_p, sk_p = wavenet_stack_reference(x, c, w, dils)
        for what, a, b in (("x", xo, xo_p), ("skip", sk, sk_p)):
            err, allowed = max_err(a, b, dtype)
            print(f"stack {str(dtype)[6:]} B={B} T={T} L={len(dils)} "
                  f"max_d={max(dils)} {what}: max_abs_err {err:.3e} "
                  f"(allowed {allowed:.3e})")
            if err > allowed:
                raise AssertionError(f"wavenet_stack disagrees on {what}")
    train_cases = [
        (torch.float32, 2, 1000, (1, 2, 4, 1, 2, 4)),
        (torch.bfloat16, 2, 1000, (1, 2, 4, 1, 2, 4)),
        (torch.float32, 2, 333, tuple(2 ** i for i in range(10))),
        (torch.bfloat16, 3, 2117, tuple(2 ** i for i in range(10))),
        (torch.float32, 1, 77, (3,)),
        (torch.bfloat16, 1, 130, (512, 1)),
    ]
    worst = check_training_kernels(gen, dev, train_cases)

    # 3. main path at full PWG v1 width, through a .gckpt the port writes
    model_gen = ParallelWaveGANGenerator(
        **PWG_V1["generator_params"], generator=torch.Generator().manual_seed(0)
    )
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "generator.gckpt")
        save_generator_checkpoint(ckpt, model_gen)
        model32 = load_model(ckpt, PWG_V1, dtype=torch.float32, device="cuda")
        model16 = load_model(ckpt, PWG_V1, dtype=torch.bfloat16,
                             device="cuda")
    if model32.stack_params is None or model16.stack_params is None:
        raise AssertionError("InferenceModel does not route to the kernel")

    # (a) batch 1, f32: fused serving path vs the unfused plain generator
    mel = rng.standard_normal((60, 80)).astype(np.float32)
    noise = lambda: torch.Generator(device=dev).manual_seed(7)  # noqa: E731
    wave = model32.synthesize_batch([mel], generator=noise(), bucket_size=1)[0]
    _, (c1, z1), _ = model32.prepare_batch([mel], generator=noise(),
                                           bucket_size=1)
    with torch.inference_mode():
        y_plain = model32.generator(z1, c1)[0].float().cpu()
    err, allowed = max_err(torch.from_numpy(wave), y_plain, torch.float32)
    print(f"main path (a) f32 batch 1 x 60 frames: max_abs_err {err:.3e} vs "
          f"plain generator (allowed {allowed:.3e})")
    if wave.shape != (60 * HOP, 1) or err > allowed:
        raise AssertionError("fused f32 forward disagrees with the plain one")

    # (b) bench shape, bf16: the counted run of the main path
    mels = [rng.standard_normal((BENCH_FRAMES, 80)).astype(np.float32)
            for _ in range(BENCH_BATCH)]
    torch.cuda.synchronize()
    wavenet_stack.launches = 0
    t0 = time.perf_counter()
    waves = model16.synthesize_batch(mels)
    wall = time.perf_counter() - t0
    launches = wavenet_stack.launches
    print(f"main path (b) bf16 {BENCH_BATCH} x {BENCH_FRAMES} frames: "
          f"synthesize_batch {wall * 1e3:.1f} ms wall (first call), "
          f"wavenet_stack launches {launches}")
    if launches != model16.generator.layers:
        raise AssertionError(f"expected {model16.generator.layers} launches")
    for w in waves:
        if w.shape != (BENCH_FRAMES * HOP, 1) or not np.isfinite(w).all():
            raise AssertionError("bad bf16 output")

    # 4. timing at the main path's shapes
    fn, (c, z), _ = model16.prepare_batch(mels)
    fwd_ms = time_ms(lambda: fn(c, z), reps=3)
    g16 = model16.generator
    with torch.inference_mode():
        c_up = g16.upsample_net(c).contiguous()
        x0 = _conv1x1(g16.first_conv, z).contiguous()
        w = model16.stack_params
        dils = g16.dilations
        xo, sk = wavenet_stack(x0, c_up, w, dils)
        xo_p, sk_p = wavenet_stack_reference(x0, c_up, w, dils)
        errs = [max_err(a, b, torch.bfloat16) for a, b in
                ((xo, xo_p), (sk, sk_p))]
        del xo, sk, xo_p, sk_p
        stack_ms = time_ms(lambda: wavenet_stack(x0, c_up, w, dils), reps=3)
        plain_ms = time_ms(lambda: wavenet_stack_reference(x0, c_up, w, dils),
                           reps=2)
    for what, (err, allowed) in zip(("x", "skip"), errs):
        print(f"stack at main-path shape bf16 {what}: max_abs_err {err:.3e} "
              f"(allowed {allowed:.3e})")
        if err > allowed:
            raise AssertionError(f"wavenet_stack disagrees on {what}")
    B, T = x0.shape[:2]
    bound_ms, bound_by = stack_bound_ms(B, T, len(dils), torch.bfloat16)
    audio_s = BENCH_BATCH * BENCH_FRAMES * HOP / SR
    print(f"forward bf16 {BENCH_BATCH} x {BENCH_FRAMES} frames: "
          f"{fwd_ms:.2f} ms, {audio_s / (fwd_ms / 1e3):.1f} audio-s/s; "
          f"wavenet_stack {stack_ms:.2f} ms (plain {plain_ms:.2f} ms, bound "
          f"{bound_ms:.2f} ms by {bound_by}) on {smi}")

    # 5, 6. the training path
    train = training_phase(dev, smi)
    if min(launches, train["fwd_launches"], train["bwd_launches"]) < 1:
        raise AssertionError("a kernel of a main path was never launched")

    # no single PyTorch call computes the stack or its backward: library_ms
    # is null for both. ms, plain_ms and bound_ms are at the shape of the
    # path that "launches" counts: serving for the forward (its launches and
    # times on the training path beside them), training for the backward.
    print(json.dumps({"kernels": [{
        "name": "wavenet_stack",
        "route": "cuda",
        "source": "parallelwavegan_torch/csrc/wavenet_stack.cu",
        "replaces": "parallelwavegan_tpu/ops/pallas/wavenet_stack.py:113",
        "launches": launches,
        "max_abs_err": max(max(e for e, _ in errs), worst["wavenet_stack"],
                           train["fwd_err"]),
        "ms": stack_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "train_launches": train["fwd_launches"],
        "train_ms": train["fwd_train_ms"],
        "train_plain_ms": train["fwd_plain_ms"],
        "train_bound_ms": train["fwd_bound_ms"],
    }, {
        "name": "wavenet_stack_backward",
        "route": "cuda",
        "source": "parallelwavegan_torch/csrc/wavenet_stack_bwd.cu",
        "replaces":
            "parallelwavegan_tpu/ops/pallas/wavenet_stack_train.py:62",
        "launches": train["bwd_launches"],
        "max_abs_err": max(train["bwd_err"],
                           worst["wavenet_stack_backward"]),
        "ms": train["bwd_ms"],
        "plain_ms": train["bwd_plain_ms"],
        "bound_ms": train["bwd_bound_ms"],
        "bound_by": train["bwd_bound_by"],
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
