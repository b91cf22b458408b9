#!/usr/bin/env python3
"""``chip_smoke.py`` step 15 (e)'s gradient gate on many card-trained
states of the duration recipe, with what can part the card from float64.

    python duration_gate_states.py [--states 24] [--first 0] [--locate] \
        [--probe-distributed]

Run from the root of a checkout, on the card (it takes the recipe, the
corpus and the gate from ``chip_smoke``, beside it). State i trains the duration
recipe (``chip_smoke.DISCRETE_RECIPES["duration"]``, 16 x 10,240) through
``bin.train.run`` from seed i // 2 on a corpus seeded 18 + i, then (i % 4)
x 2 more (G, adv, D) steps on the loader's first batch, and holds that
batch's first row (its tokens, dropout masks seeded 15 + i, D in eval
mode) with ``hold_gate(gate_gradients(...))``, printing every set; a
failed gate is reported, not raised. Beside the gate, for each state:

- G's LeakyReLU branches (the trunk's and the residual blocks' ``act``)
  on the card's f32 route and the CPU's against float64's: how many
  inputs took the other branch, and the smallest |input| among them;
- the predicted log-durations on the card, with the duration predictor's
  convs as the port runs them (matrix products) and through ``F.conv1d``
  under cuDNN's default and deterministic algorithms and without cuDNN,
  against float64 (the CPU's f32 beside them);
- the input conv's weight gradient on the card's saved input and a
  seeded cotangent, under each cuDNN setting and with TF32, against
  float64, three times each;
- with ``--locate``, the gradients at the embedding's output, the length
  regulator's output and the input conv's output on every route under one
  set of seeded cotangents, then the embedding's, the regulator's, the
  duration predictor's (its convs as products and through ``F.conv1d``)
  and the input conv's backward alone on float64's upstream gradient.

``--probe-distributed`` first all-reduces and broadcasts a CUDA tensor
across two gloo processes on this card and one NCCL process. One JSON line
a state at the end; each line's numbers are max |route - float64| over
the largest |float64| where they are relative.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import torch
import torch.nn.functional as F

CUDNN = {
    "default": dict(enabled=True, deterministic=False, benchmark=False,
                    allow_tf32=False),
    "deterministic": dict(enabled=True, deterministic=True, benchmark=False,
                          allow_tf32=False),
    "benchmark": dict(enabled=True, deterministic=False, benchmark=True,
                      allow_tf32=False),
    "no_cudnn": dict(enabled=False, allow_tf32=False),
    "tf32": dict(enabled=True, deterministic=False, benchmark=False,
                 allow_tf32=True),
}


@contextlib.contextmanager
def predictor_convs_through_f_conv1d():
    """The duration predictor's convs through ``ops.conv.conv1d``
    (``F.conv1d``: cuDNN on the card) instead of one matrix product each."""
    from parallelwavegan_torch.layers import duration
    from parallelwavegan_torch.ops.conv import conv1d

    own = duration.conv1d_product
    duration.conv1d_product = conv1d
    try:
        yield
    finally:
        duration.conv1d_product = own


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def probe_distributed() -> None:
    """A CUDA tensor all-reduced and broadcast by two gloo processes on
    this card, and by one NCCL process."""
    code = textwrap.dedent('''
        import sys, torch, torch.distributed as dist
        rank, world, backend, port = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4])
        dist.init_process_group(backend, rank=rank, world_size=world,
                                init_method=f"tcp://127.0.0.1:{port}")
        t = torch.full((1000,), float(rank + 1), device="cuda:0")
        try:
            dist.all_reduce(t)
            b = torch.arange(5.0, device="cuda:0") * (rank + 1)
            dist.broadcast(b, 0)
            print(f"{backend} rank {rank}/{world}: all_reduce cuda "
                  f"{t[0].item()} broadcast {b.tolist()}", flush=True)
        except Exception as e:
            print(f"{backend} rank {rank}: FAILED {type(e).__name__}: {e}",
                  flush=True)
        dist.destroy_process_group()
    ''')
    for backend, world in (("gloo", 2), ("nccl", 1)):
        port = free_port()
        procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                                   str(world), backend, str(port)])
                 for r in range(world)]
        for p in procs:
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                print(f"{backend}: timed out")


class BranchRecorder:
    """Records the sign pattern (input > 0) and |input| of every call of
    G's ``act`` (the trunk's and the residual blocks') until restored."""

    def __init__(self, gen):
        self.masks, self.pre, self.saved = [], [], []
        for m in [gen.trunk] + [m for m in gen.modules()
                                if type(m).__name__ == "HiFiGANResidualBlock"]:
            self.saved.append((m, m.act))
            m.act = self._wrap(m.act)

    def _wrap(self, act):
        def recorded(x):
            self.masks.append((x.detach() > 0).cpu())
            self.pre.append(x.detach().double().abs().cpu())
            return act(x)
        return recorded

    def restore(self) -> None:
        for m, act in self.saved:
            m.act = act


def branch_flips(routes: dict, forward) -> dict:
    """Per f32 route: G's activation inputs on the other branch than
    float64's, the first call with one, the smallest such |input|."""
    recs = {}
    for r, (gen, _, b) in routes.items():
        rec = BranchRecorder(gen)
        try:
            with torch.no_grad():
                forward(gen, b)
        finally:
            rec.restore()
        recs[r] = rec
    out = {}
    for r in "kp":
        n, first, smallest = 0, None, None
        for i, (a, e) in enumerate(zip(recs[r].masks, recs["e"].masks)):
            d = a != e
            if d.any():
                n += int(d.sum())
                first = i if first is None else first
                m = float(recs["e"].pre[i][d].min())
                smallest = m if smallest is None else min(smallest, m)
        out[r] = {"flips": n, "first_call": first, "min_abs_pre_e": smallest}
    return out


def log_duration_errors(routes: dict, forward) -> dict:
    """max |log-durations - float64's| on the CPU's f32 route and on the
    card's: the predictor's convs as matrix products (``product``), and
    through ``F.conv1d`` under three cuDNN settings."""
    (ge, _, be), (gp, _, bp), (gk, _, bk) = (routes[r] for r in "epk")
    with torch.no_grad():
        e = forward(ge, be)[1].double().cpu()
        out = {"p": float((forward(gp, bp)[1].double() - e).abs().max()),
               "product": float(
                   (forward(gk, bk)[1].double().cpu() - e).abs().max())}
        with predictor_convs_through_f_conv1d():
            for name in ("default", "deterministic", "no_cudnn"):
                with torch.backends.cudnn.flags(**CUDNN[name]):
                    out[name] = float(
                        (forward(gk, bk)[1].double().cpu() - e).abs().max())
    return out


def input_conv_wgrad(gen, b, forward, seed: int) -> dict:
    """The input conv's weight gradient on the card's saved input and a
    seeded cotangent under each cuDNN setting (three times each) and on
    the CPU in f32, relative to float64's largest entry."""
    conv = gen.trunk.input_conv
    saved = {}
    hook = conv.register_forward_hook(
        lambda m, i, o: saved.update(x=i[0].detach()))
    with torch.no_grad():
        forward(gen, b)
    hook.remove()
    x, kernel = saved["x"], conv.folded_kernel().detach()
    K = kernel.shape[0]
    dy = torch.randn(x.shape[0], x.shape[1], kernel.shape[2],
                     generator=torch.Generator().manual_seed(seed))

    def wgrad(device, dtype, flags):
        xx = x.to(device, dtype)
        kk = kernel.to(device, dtype).requires_grad_()
        with torch.backends.cudnn.flags(**flags):
            y = F.conv1d(xx.transpose(1, 2), kk.permute(2, 1, 0),
                         padding=(K - 1) // 2).transpose(1, 2)
            return torch.autograd.grad(y, kk, dy.to(device, dtype))[0] \
                .double().cpu()

    ref = wgrad("cpu", torch.float64, CUDNN["no_cudnn"])
    scale = float(ref.abs().max())
    out = {"p": float((wgrad("cpu", torch.float32, CUDNN["no_cudnn"])
                       - ref).abs().max()) / scale}
    for name, flags in CUDNN.items():
        out[name] = [float((wgrad(x.device, torch.float32, flags)
                            - ref).abs().max()) / scale for _ in range(3)]
    return out


def locate(routes: dict, forward, seed: int) -> dict:
    """Where a route's token-table gradient parts from float64's: the
    gradients at the embedding's, the regulator's and the input conv's
    outputs on every route under one set of seeded cotangents, then each
    piece's backward alone on float64's upstream gradient."""
    from parallelwavegan_torch.layers.duration import length_regulator

    g = torch.Generator().manual_seed(seed)
    ge, _, be = routes["e"]
    with torch.no_grad():
        outs_e = forward(ge, be)
    cot = [torch.randn(o.shape, generator=g, dtype=torch.float64)
           for o in outs_e]
    cap = {}
    for r in "kpe":
        gen, _, b = routes[r]
        c = {}

        def grab(t, name, c=c):
            c[name + "_v"] = t
            t.register_hook(lambda gr: c.__setitem__(name, gr))

        hooks = [
            gen.emb.register_forward_hook(
                lambda m, i, o: grab(o, "emb_out")),
            gen.trunk.input_conv.register_forward_pre_hook(
                lambda m, i: grab(i[0], "reg")),
            gen.trunk.input_conv.register_forward_hook(
                lambda m, i, o: grab(o, "conv_out"))]
        outs = forward(gen, b)
        (c["emb_w"],) = torch.autograd.grad(
            outs, [gen.emb.embedding],
            [t.to(o.device, o.dtype) for t, o in zip(cot, outs)])
        for h in hooks:
            h.remove()
        cap[r] = {k: v.detach().double().cpu() for k, v in c.items()}
    res = {}
    for name in ("conv_out", "reg", "emb_out", "emb_w"):
        e = cap["e"][name]
        res[name] = {r: float((cap[r][name] - e).abs().max())
                     / float(e.abs().max()) for r in "kp"}
    dev = routes["k"][2]["c"].device
    ids = routes["k"][2]["c"][..., 0].long()
    ds = routes["k"][2]["ds"]
    masks = [routes["k"][2][f"mask_{j}"] for j in range(2)]

    def alone(fn, *settings):
        ref = fn("cpu", torch.float64, CUDNN["no_cudnn"])
        scale = float(ref.abs().max())
        out = {"p": float((fn("cpu", torch.float32, CUDNN["no_cudnn"])
                           - ref).abs().max()) / scale}
        for name in settings:
            out[name] = float((fn(dev, torch.float32, CUDNN[name])
                               - ref).abs().max()) / scale
        return out

    def embedding(device, dtype, flags):
        w = ge.emb.embedding.detach().to(device, dtype).requires_grad_()
        return torch.autograd.grad(
            F.embedding(ids.to(device), w), w,
            cap["e"]["emb_out"].to(device, dtype))[0].double().cpu()

    def regulator(device, dtype, flags):
        x = cap["e"]["emb_out_v"].to(device, dtype).requires_grad_()
        y, _ = length_regulator(x, ds.to(device), cap["e"]["reg"].shape[1])
        return torch.autograd.grad(y, x, cap["e"]["reg"].to(device, dtype))[
            0].double().cpu()

    def predictor(device, dtype, flags):
        m = copy.deepcopy(ge.duration_predictor).to(device, dtype)
        x = cap["e"]["emb_out_v"].to(device, dtype).requires_grad_()
        with torch.backends.cudnn.flags(**flags):
            y = m(x, False, [mk.to(device) for mk in masks])
            return torch.autograd.grad(y, x, cot[1].to(device, dtype))[0] \
                .double().cpu()

    def input_conv(device, dtype, flags):
        m = copy.deepcopy(ge.trunk.input_conv).to(device, dtype)
        x = cap["e"]["reg_v"].to(device, dtype).requires_grad_()
        with torch.backends.cudnn.flags(**flags):
            return torch.autograd.grad(
                m(x), x, cap["e"]["conv_out"].to(device, dtype))[0] \
                .double().cpu()

    res["alone_embedding_bwd"] = alone(embedding, "default")
    res["alone_regulator_bwd"] = alone(regulator, "default")
    res["alone_predictor_bwd"] = alone(predictor, "default")
    with predictor_convs_through_f_conv1d():
        res["alone_predictor_bwd_f_conv1d"] = alone(predictor, "default",
                                                    "no_cudnn")
    res["alone_input_conv_dgrad"] = alone(input_conv, "default",
                                          "deterministic", "no_cudnn")
    return res


def main(argv=None) -> int:
    import chip_smoke as cs
    from parallelwavegan_torch.bin.train import run
    from parallelwavegan_torch.engine.step import (
        DROPOUT_STREAM,
        SHARED_STREAM,
        step_generator,
    )

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--states", type=int, default=24)
    parser.add_argument("--first", type=int, default=0)
    parser.add_argument("--locate", action="store_true")
    parser.add_argument("--probe-distributed", action="store_true")
    args = parser.parse_args(argv)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    print(sys.version, torch.__version__, torch.version.cuda,
          torch.backends.cudnn.version())
    if args.probe_distributed:
        probe_distributed()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    summary = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.first, args.first + args.states):
            t0 = time.perf_counter()
            seed, extra = i // 2, (i % 4) * 2
            config = dict(cs.DISCRETE_RECIPES["duration"],
                          **dict(cs.DURATION_TRAIN_CUT,
                                 eval_interval_steps=1000))
            dump = os.path.join(tmp, f"dump{i}")
            cs.write_discrete_corpus(dump, np.random.default_rng(18 + i),
                                     config["batch_size"], config)
            trainer = run(config, dump, dump, os.path.join(tmp, f"exp{i}"),
                          seed=seed, device="cuda", dump_config=False)
            batch = trainer._to_device(next(iter(trainer.train_loader)))
            step = trainer.train_step_factory(True, True, True)
            for _ in range(extra):
                s = trainer.state.steps
                step(trainer.state, batch, step_generator(seed, s),
                     step_generator(seed, s, SHARED_STREAM),
                     step_generator(seed, s, DROPOUT_STREAM, dev))
            torch.cuda.synchronize()
            gen = trainer.generator
            b = {k: v[:1] for k, v in batch.items()}
            n_tok = int((b["ds"] > 0).sum())
            b = {**b, "c": b["c"][:, :n_tok], "ds": b["ds"][:, :n_tok]}
            for j, m in enumerate(gen.batch_dropout_masks(
                    b, torch.Generator().manual_seed(15 + i))):
                b[f"mask_{j}"] = m.to(dev)
            crit = dict(trainer.criterion)
            crit["mel"] = dataclasses.replace(crit["mel"], method="matmul")
            dis = trainer.discriminator.eval()
            forward, terms, d_loss = cs.discrete_gate_losses(crit)
            routes = cs.gate_routes(gen, dis, b)
            tag = f"state {i} (seed {seed}, {3 + extra} steps)"
            res = {"state": i, "seed": seed, "steps": 3 + extra,
                   "flips": branch_flips(routes, forward),
                   "log_durations": log_duration_errors(routes, forward),
                   "input_conv_wgrad": input_conv_wgrad(gen, b, forward, i)}
            for key in ("flips", "log_durations", "input_conv_wgrad"):
                print(f"{tag} {key}: {res[key]}")
            if args.locate:
                res["locate"] = locate(routes, forward, i)
                print(f"{tag} locate: {res['locate']}")
            try:
                res["gates"] = cs.hold_gate(tag, cs.gate_gradients(
                    routes, forward, terms, d_loss),
                    config["batch_max_steps"], B=1)
                res["failed"] = None
            except AssertionError as err:
                res["failed"] = str(err)[:500]
                print(f"{tag}: GATE FAILED {err}")
            res["s"] = time.perf_counter() - t0
            print(f"{tag}: {res['s']:.1f} s")
            summary.append(res)
            del trainer, gen, dis, routes, batch, b
            torch.cuda.empty_cache()
    for res in summary:
        print(json.dumps(res, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
