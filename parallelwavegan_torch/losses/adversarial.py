"""Adversarial losses over discriminator outputs.

Counterpart of ``parallelwavegan_tpu/losses/adversarial.py``. A
discriminator's output is a single tensor of logits, a list of tensors
(several discriminators), or a list of lists (feature maps, logits last).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch


def _leaves(outputs) -> List[torch.Tensor]:
    """The output convention as a list of logits tensors."""
    if isinstance(outputs, (tuple, list)):
        return [o[-1] if isinstance(o, (tuple, list)) else o for o in outputs]
    return [outputs]


def _check_loss_type(loss_type: str) -> None:
    if loss_type not in ("mse", "hinge"):
        raise ValueError(f"unsupported adversarial loss_type: {loss_type}")


@dataclass(frozen=True)
class GeneratorAdversarialLoss:
    average_by_discriminators: bool = True
    loss_type: str = "mse"

    def __post_init__(self):
        _check_loss_type(self.loss_type)

    def __call__(self, outputs) -> torch.Tensor:
        logits = _leaves(outputs)
        loss = 0.0
        for x in logits:
            if self.loss_type == "mse":
                loss = loss + torch.mean((x - 1.0) ** 2)
            else:
                loss = loss - torch.mean(x)
        if self.average_by_discriminators and isinstance(outputs,
                                                         (tuple, list)):
            loss = loss / len(logits)
        return loss


@dataclass(frozen=True)
class DiscriminatorAdversarialLoss:
    average_by_discriminators: bool = True
    loss_type: str = "mse"

    def __post_init__(self):
        _check_loss_type(self.loss_type)

    def __call__(self, outputs_hat, outputs):
        """(fake outputs, real outputs) -> (real_loss, fake_loss)."""
        fake, real = _leaves(outputs_hat), _leaves(outputs)
        real_loss, fake_loss = 0.0, 0.0
        for x_hat, x in zip(fake, real):
            if self.loss_type == "mse":
                real_loss = real_loss + torch.mean((x - 1.0) ** 2)
                fake_loss = fake_loss + torch.mean(x_hat ** 2)
            else:
                real_loss = real_loss - torch.mean(
                    torch.clamp(x - 1.0, max=0.0))
                fake_loss = fake_loss - torch.mean(
                    torch.clamp(-x_hat - 1.0, max=0.0))
        if self.average_by_discriminators and isinstance(outputs,
                                                         (tuple, list)):
            real_loss = real_loss / len(real)
            fake_loss = fake_loss / len(fake)
        return real_loss, fake_loss
