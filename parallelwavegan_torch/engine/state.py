"""GAN training state: both networks, both optimizers, the step counter,
the EMA of the generator.

Counterpart of ``parallelwavegan_tpu/engine/state.py``. The JAX state is an
immutable pytree of parameter trees; here the parameters live in the two
``nn.Module``s and the train step updates them in place. ``extra_d`` is a
view of the discriminator's buffers (the spectral-norm vectors ``u``, which
flax keeps in the ``spectral`` collection). ``ema_g`` holds detached copies
of the generator's parameters under their names when
``generator_ema_decay`` is positive, else None.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from parallelwavegan_torch.optimizers import Optimizer


@dataclass
class GANTrainState:
    steps: int
    generator: nn.Module
    discriminator: nn.Module
    opt_g: Optimizer
    opt_d: Optimizer
    ema_g: Optional[Dict[str, torch.Tensor]] = None

    @property
    def params_g(self) -> Dict[str, torch.Tensor]:
        return dict(self.generator.named_parameters())

    @property
    def params_d(self) -> Dict[str, torch.Tensor]:
        return dict(self.discriminator.named_parameters())

    @property
    def extra_d(self) -> Dict[str, torch.Tensor]:
        return dict(self.discriminator.named_buffers())

    def seed_ema(self) -> None:
        """Start the EMA stream from copies of the generator's parameters."""
        self.ema_g = {k: v.detach().clone() for k, v in self.params_g.items()}

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor of the state by name: both networks' parameters and
        buffers, both optimizers' moments and the EMA; what data-parallel
        ranks hold alike (``Trainer.replicate`` broadcasts it)."""
        out: Dict[str, torch.Tensor] = {}
        for tag, module in (("G", self.generator), ("D", self.discriminator)):
            for name, t in module.named_parameters():
                out[f"{tag}.{name}"] = t
            for name, t in module.named_buffers():
                out[f"{tag}.{name}"] = t

        def walk(prefix: str, node: Any) -> None:
            if isinstance(node, torch.Tensor):
                out[prefix] = node
            elif isinstance(node, dict):
                for key, value in node.items():
                    walk(f"{prefix}.{key}", value)

        walk("opt_g", self.opt_g.state)
        walk("opt_d", self.opt_d.state)
        for name, t in (self.ema_g or {}).items():
            out[f"ema_g.{name}"] = t
        return out
