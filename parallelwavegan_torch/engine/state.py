"""GAN training state: both networks, both optimizers, the step counter.

Counterpart of ``parallelwavegan_tpu/engine/state.py``. The JAX state is an
immutable pytree of parameter trees; here the parameters live in the two
``nn.Module``s and the train step updates them in place. ``ema_g`` is kept
as a field for checkpoint compatibility; the EMA update is not ported yet
and it stays ``None``.
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
    ema_g: Optional[Dict[str, Any]] = None

    @property
    def params_g(self) -> Dict[str, torch.Tensor]:
        return dict(self.generator.named_parameters())

    @property
    def params_d(self) -> Dict[str, torch.Tensor]:
        return dict(self.discriminator.named_parameters())
