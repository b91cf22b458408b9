"""Parallel WaveGAN v1's (G, adv, D) training step, plain PyTorch.

The generator update: the multi-resolution STFT loss (spectral convergence
plus log-magnitude, averaged over the resolutions, on ``torch.stft`` with a
periodic Hann window, centred with reflect padding, magnitudes
sqrt(max(power, 1e-7))) times ``lambda_aux``, plus ``lambda_adv`` times the
least-squares adversarial loss mean((D(G(z, c)) - 1)^2); gradients clipped
to a global norm, then RAdam. The discriminator update on the output of
the updated generator: mean((D(y) - 1)^2) + mean(D(G(z, c))^2), clipped,
RAdam. RAdam and the clipping follow the arithmetic of the configuration's
optimizer chain (clip by global norm: scale max / max(norm, max); RAdam
with its rectification threshold 5, which the first five updates fall
under, then the learning rate of the update count before it).

What the benchmark's training driver takes from a family's training
reference (the configuration names the module as
``portbench.train_reference``): ``LOSSES``, the names of the losses a
step reports; ``shapes(config)``, both networks' parameters in the
training form; ``Step(config, g0, d0)``, whose call takes one batch (a
dict of tensors, as the recipe's loader names them) and returns the
losses and both clipped gradients; ``bad_rows(config, corpus, batches)``,
the loader's rows that are no window of the corpus written.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import parallel_wavegan as pwg

Params = Dict[str, torch.Tensor]

LOSSES = ("generator_loss", "discriminator_loss")


def shapes(config: dict) -> Dict[str, Dict[str, Tuple]]:
    """Every parameter of G and D in the training form (weight norm as v
    and g), name -> shape."""
    return {"G": pwg.generator_shapes(config["generator_params"], True),
            "D": pwg.discriminator_shapes(config["discriminator_params"],
                                          True)}


def stft_mag(x: torch.Tensor, fft: int, hop: int, win: int) -> torch.Tensor:
    window = torch.hann_window(win, dtype=x.dtype, device=x.device)
    spec = torch.stft(x, fft, hop, win, window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2
    return torch.sqrt(torch.clamp(power, min=1e-7))


def stft_loss(y_hat: torch.Tensor, y: torch.Tensor, p: dict
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spectral convergence, log-magnitude), each the mean over the
    resolutions, of (B, T) signals."""
    sc, mag = 0.0, 0.0
    res = list(zip(p["fft_sizes"], p["hop_sizes"], p["win_lengths"]))
    for fft, hop, win in res:
        xm, ym = stft_mag(y_hat, fft, hop, win), stft_mag(y, fft, hop, win)
        sc = sc + torch.linalg.norm(ym - xm) / torch.linalg.norm(ym)
        mag = mag + torch.mean(torch.abs(torch.log(ym) - torch.log(xm)))
    return sc / len(res), mag / len(res)


class RAdam:
    """Clip by global norm, RAdam, step-decayed learning rate."""

    def __init__(self, params: Params, opt: dict, sched: dict,
                 max_norm: float):
        self.lr, self.eps = opt["lr"], opt.get("eps", 1e-8)
        self.b1, self.b2 = opt.get("betas", (0.9, 0.999))
        self.step_size, self.gamma = sched["step_size"], sched["gamma"]
        self.max_norm = max_norm
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def clip(self, grads: Params) -> Params:
        if self.max_norm <= 0:
            return grads
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = self.max_norm / torch.clamp(norm, min=self.max_norm)
        return {k: g * scale for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        lr = self.lr * self.gamma ** (self.count // self.step_size)
        self.count += 1
        t, b1, b2 = self.count, self.b1, self.b2
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = ro_inf - 2 * t * b2 ** t / (1 - b2 ** t)
        for k, g in grads.items():
            self.mu[k].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            update = self.mu[k] / (1 - b1 ** t)
            if ro >= 5.0:
                rect = math.sqrt((ro - 4) * (ro - 2) * ro_inf
                                 / ((ro_inf - 4) * (ro_inf - 2) * ro))
                denom = torch.sqrt(self.nu[k] / (1 - b2 ** t)) + self.eps
                update = rect * update / denom
            params[k].sub_(lr * update)


def _grads(loss: torch.Tensor, params: Params) -> Params:
    names = list(params)
    got = torch.autograd.grad(loss, [params[k] for k in names],
                              allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g
            for k, g in zip(names, got)}


class Step:
    """The state (G and D parameters in the training form, both
    optimizers) and one full step at a time."""

    def __init__(self, config: dict, params_g: Params, params_d: Params):
        self.config = config
        self.g = {k: v.detach().clone() for k, v in params_g.items()}
        self.d = {k: v.detach().clone() for k, v in params_d.items()}
        self.opt_g = RAdam(self.g, config["generator_optimizer_params"],
                           config["generator_scheduler_params"],
                           config["generator_grad_norm"])
        self.opt_d = RAdam(self.d, config["discriminator_optimizer_params"],
                           config["discriminator_scheduler_params"],
                           config["discriminator_grad_norm"])

    def __call__(self, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[Dict[str, float], Params, Params]:
        """One step on the batch (y (B, T, 1), c, z). Returns the losses
        and the clipped gradients of G and D as their optimizers got them."""
        y, c, z = batch["y"], batch["c"], batch["z"]
        cfg = self.config
        gp, dp = cfg["generator_params"], cfg["discriminator_params"]
        g = {k: v.requires_grad_() for k, v in self.g.items()}
        y_hat = pwg.generator(g, gp, c, z)
        sc, mag = stft_loss(y_hat[..., 0], y[..., 0], cfg["stft_loss_params"])
        fixed_d = {k: v.detach() for k, v in self.d.items()}
        adv = torch.mean((pwg.discriminator(fixed_d, dp, y_hat) - 1.0) ** 2)
        gen_loss = cfg.get("lambda_aux", 1.0) * (sc + mag) \
            + cfg["lambda_adv"] * adv
        grads_g = self.opt_g.clip(_grads(gen_loss, g))
        for v in g.values():
            v.requires_grad_(False)
        self.opt_g.step(self.g, grads_g)

        with torch.no_grad():
            y_hat = pwg.generator(self.g, gp, c, z)
        d = {k: v.requires_grad_() for k, v in self.d.items()}
        real = torch.mean((pwg.discriminator(d, dp, y) - 1.0) ** 2)
        fake = torch.mean(pwg.discriminator(d, dp, y_hat) ** 2)
        dis_loss = real + fake
        grads_d = self.opt_d.clip(_grads(dis_loss, d))
        for v in d.values():
            v.requires_grad_(False)
        self.opt_d.step(self.d, grads_d)
        losses = {"generator_loss": float(gen_loss.detach()),
                  "discriminator_loss": float(dis_loss.detach())}
        return losses, grads_g, grads_d


def bad_rows(config: dict, corpus: List[tuple], batches: List[dict]
             ) -> int:
    """Rows of the batches that are not a window of the corpus (the
    audio, and the mel frames with their context, at the same start) or
    whose noise is not finite N(0, 1)-like: mean and deviation within five
    of their standard errors of 0 and 1. ``corpus`` holds (audio, mel)
    pairs as written."""
    hop = config["hop_size"]
    ctx = config["generator_params"]["aux_context_window"]
    index: Dict[bytes, List[tuple]] = {}
    for u, (_, mel) in enumerate(corpus):
        for f in range(ctx, len(mel)):
            index.setdefault(mel[f].tobytes(), []).append((u, f))
    bad = 0
    for batch in batches:
        y, c, z = batch["y"], batch["c"], batch["z"]
        for b in range(len(y)):
            rows = y.shape[1]
            ok = False
            for u, f in index.get(c[b, ctx].tobytes(), []):
                audio, mel = corpus[u]
                if (f - ctx >= 0 and f + c.shape[1] - ctx <= len(mel)
                        and np.array_equal(mel[f - ctx:f - ctx + c.shape[1]],
                                           c[b])
                        and np.array_equal(audio[f * hop:f * hop + rows],
                                           y[b, :, 0])):
                    ok = True
                    break
            zb = z[b].astype(np.float64)
            n = zb.size
            if not (ok and np.isfinite(zb).all()
                    and abs(zb.mean()) < 5.0 / np.sqrt(n)
                    and abs(zb.std() - 1.0) < 5.0 / np.sqrt(2.0 * n)):
                bad += 1
    return bad
