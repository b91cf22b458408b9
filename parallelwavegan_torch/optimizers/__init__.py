"""Optimizer and scheduler factories for the reference's YAML names.

Counterpart of ``parallelwavegan_tpu/optimizers/__init__.py``, which maps
the names onto optax. ``torch.optim`` is not used: its schedulers and the
optax ones count steps differently, its ``clip_grad_norm_`` adds 1e-6 to
the norm, and its ``Adam(weight_decay=...)`` couples the decay where the
JAX package decouples it. The port instead carries the few optax
transformations the JAX package chains, with optax's arithmetic and
optax's state layout:

- a schedule is a function of the count of updates made so far, counted
  from 0, and an update uses the rate of the count *before* it;
- ``clip_by_global_norm`` scales by max_norm / max(norm, max_norm);
- an ``Optimizer``'s ``state_dict()`` is the tree flax serializes for the
  corresponding optax chain (tuples as {"0": ..., "1": ...}, named tuples
  as {field: ...}, parameter trees nested by module), so a train-state
  checkpoint of either package restores into the other.

Updates run in place on the parameters, without autograd.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from parallelwavegan_torch.utils.params import as_tensor, nested

Schedule = Callable[[int], float]
Params = Dict[str, torch.Tensor]


def build_schedule(scheduler_type: Optional[str],
                   scheduler_params: Optional[Dict[str, Any]],
                   base_lr: float) -> Schedule:
    """torch scheduler name -> learning rate as a function of the number of
    updates made so far (the scheduler is stepped every train step)."""
    p = dict(scheduler_params or {})
    if scheduler_type in ("StepLR", "ExponentialLR"):
        if scheduler_type == "StepLR":
            step_size, gamma = p.get("step_size", 1), p.get("gamma", 0.1)
        else:
            step_size, gamma = 1, p.get("gamma", 0.99)
        return lambda count: base_lr * gamma ** (count // step_size)
    if scheduler_type == "MultiStepLR":
        gamma = p.get("gamma", 0.1)
        milestones = sorted(int(m) for m in p.get("milestones", []))
        return lambda count: base_lr * gamma ** sum(
            count >= m for m in milestones)
    if scheduler_type == "CosineAnnealingLR":
        t_max = p.get("T_max", 1)
        alpha = p.get("eta_min", 0.0) / max(base_lr, 1e-12)

        def cosine(count: int) -> float:
            frac = min(count, t_max) / t_max
            return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac))
                              + alpha)

        return cosine
    if scheduler_type in (None, "None", "Constant"):
        return lambda count: base_lr
    raise ValueError(f"unsupported scheduler: {scheduler_type}")


# -- gradient transformations ------------------------------------------------
# Each has init(params) -> state (a dict, as flax would serialize the optax
# state) and update(updates, state, params) -> new updates; ``updates`` is a
# list of tensors in the order of ``params`` and is left as it was (a
# gradient may share memory with another tensor of the caller's).


class _ClipByGlobalNorm:
    def __init__(self, max_norm: float):
        self.max_norm = float(max_norm)

    def init(self, params: Params) -> Dict[str, Any]:
        return {}

    def update(self, updates, state, params):
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(updates)))
        scale = self.max_norm / torch.clamp(norm, min=self.max_norm)
        return torch._foreach_mul(updates, scale)


class _AddDecayedWeights:
    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def init(self, params: Params) -> Dict[str, Any]:
        return {}

    def update(self, updates, state, params):
        return torch._foreach_add(updates, list(params.values()),
                                  alpha=self.weight_decay)


class _ScaleByAdam:
    """optax.scale_by_adam, or scale_by_radam with ``rectified``."""

    def __init__(self, b1: float, b2: float, eps: float,
                 rectified: bool = False, threshold: float = 5.0):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.rectified, self.threshold = rectified, threshold

    def init(self, params: Params) -> Dict[str, Any]:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
        }

    def update(self, updates, state, params):
        b1, b2 = self.b1, self.b2
        mu, nu = list(state["mu"].values()), list(state["nu"].values())
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, updates, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, updates, updates, value=1 - b2)
        state["count"] = count = state["count"] + 1
        mu_hat = torch._foreach_div(mu, 1 - b1 ** count)
        if self.rectified:
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            b2t = b2 ** count
            ro = ro_inf - 2 * count * b2t / (1 - b2t)
            if ro < self.threshold:  # variance not tractable yet
                return mu_hat
            rect = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                             / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            torch._foreach_mul_(mu_hat, rect)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1 - b2 ** count))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        return mu_hat


class _Trace:
    """optax.trace: momentum for SGD."""

    def __init__(self, decay: float):
        self.decay = decay

    def init(self, params: Params) -> Dict[str, Any]:
        return {"trace": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(self, updates, state, params):
        trace = list(state["trace"].values())
        torch._foreach_mul_(trace, self.decay)
        torch._foreach_add_(trace, updates)
        return [t.clone() for t in trace]


class _ScaleBySchedule:
    """Multiply by -lr(count), then count one more update. A constant rate
    keeps no count, as in optax."""

    def __init__(self, schedule: Schedule, counted: bool = True):
        self.schedule, self.counted = schedule, counted

    def init(self, params: Params) -> Dict[str, Any]:
        return {"count": 0} if self.counted else {}

    def update(self, updates, state, params):
        rate = self.schedule(state.get("count", 0))
        if self.counted:
            state["count"] += 1
        return torch._foreach_mul(updates, -rate)


class _Chain:
    def __init__(self, *parts):
        self.parts = parts

    def init(self, params: Params) -> Dict[str, Any]:
        return {str(i): p.init(params) for i, p in enumerate(self.parts)}

    def update(self, updates, state, params):
        for i, part in enumerate(self.parts):
            updates = part.update(updates, state[str(i)], params)
        return updates


class Optimizer:
    """A chain of transformations and its state for one set of parameters.

    ``init(params)`` with the named parameters ({name: tensor}, names as
    ``module.named_parameters()`` gives them); ``step(params, grads)``
    applies one update in place; ``lr`` is the rate the next update uses.
    """

    def __init__(self, chain: _Chain, schedule: Schedule):
        self.chain = chain
        self.schedule = schedule
        self.state: Dict[str, Any] = {}
        self.count = 0

    def init(self, params: Params) -> "Optimizer":
        self.state = self.chain.init(params)
        self.count = 0
        return self

    @property
    def lr(self) -> float:
        return self.schedule(self.count)

    @torch.no_grad()
    def step(self, params: Params, grads: Sequence[torch.Tensor]) -> None:
        """One update of ``params`` in place from ``grads`` (in the order
        of ``params``), which are only read."""
        updates = self.chain.update(list(grads), self.state, params)
        torch._foreach_add_(list(params.values()), updates)
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        """The state as flax serializes the optax chain's: counts as int32
        scalars, moment trees nested by module path."""
        def convert(node):
            if isinstance(node, dict):
                if node and all(isinstance(v, torch.Tensor)
                                for v in node.values()):
                    return nested(node)
                return {k: convert(v) for k, v in node.items()}
            if isinstance(node, int):
                return torch.tensor(node, dtype=torch.int32)
            return node

        return convert(self.state)

    def load_state_dict(self, tree: Dict[str, Any]) -> None:
        """Restore from ``state_dict()``'s layout (of either package)."""
        def restore(node, saved, path):
            for key, value in node.items():
                if key not in saved:
                    raise KeyError(f"optimizer state lacks {path}{key}")
                if isinstance(value, int):
                    node[key] = int(saved[key])
                elif value and all(isinstance(v, torch.Tensor)
                                   for v in value.values()):
                    for name, t in value.items():
                        src = saved[key]
                        for part in name.split("."):
                            src = src[part]
                        t.copy_(as_tensor(src).to(t.dtype))
                else:
                    restore(value, saved[key], f"{path}{key}.")

        restore(self.state, tree, "")
        self.count = max(_counts(self.state), default=0)


def _counts(node) -> List[int]:
    out: List[int] = []
    for key, value in node.items():
        if key == "count":
            out.append(value)
        elif isinstance(value, dict):
            out.extend(_counts(value))
    return out


def build_optimizer(
    optimizer_type: str = "RAdam",
    optimizer_params: Optional[Dict[str, Any]] = None,
    scheduler_type: Optional[str] = "StepLR",
    scheduler_params: Optional[Dict[str, Any]] = None,
    grad_norm: float = -1,
) -> Optimizer:
    """clip -> optimizer -> learning-rate schedule, from the reference's
    config keys, nested as the JAX package nests its optax chain."""
    p = dict(optimizer_params or {})
    lr = p.pop("lr", 1e-3)
    b1, b2 = p.pop("betas", None) or (0.9, 0.999)
    eps = p.pop("eps", 1e-8)
    weight_decay = p.pop("weight_decay", 0.0)
    schedule = build_schedule(scheduler_type, scheduler_params, lr)
    scale = _ScaleBySchedule(
        schedule, counted=scheduler_type not in (None, "None", "Constant"))

    if optimizer_type == "RAdam":
        opt = _Chain(_ScaleByAdam(b1, b2, eps, rectified=True), scale)
        if weight_decay:
            opt = _Chain(_AddDecayedWeights(weight_decay), opt)
    elif optimizer_type == "Adam" and not weight_decay:
        opt = _Chain(_ScaleByAdam(b1, b2, eps), scale)
    elif optimizer_type in ("Adam", "AdamW"):
        opt = _Chain(_ScaleByAdam(b1, b2, eps),
                     _AddDecayedWeights(weight_decay or 0.01), scale)
    elif optimizer_type == "SGD":
        # the JAX package always passes a momentum, so optax always traces
        opt = _Chain(_Trace(p.pop("momentum", 0.0)), scale)
    else:
        raise ValueError(f"unsupported optimizer: {optimizer_type}")
    if grad_norm is not None and grad_norm > 0:
        opt = _Chain(_ClipByGlobalNorm(grad_norm), opt)
    return Optimizer(opt, schedule)
