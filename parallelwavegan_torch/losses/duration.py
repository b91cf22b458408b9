"""Duration predictor loss.

Counterpart of ``parallelwavegan_tpu/losses/duration.py``: the mean squared
error between predicted log-durations and log(targets + offset), over a
mask where one is given. Its one field is ``offset``, as there (the
reference's ``reduction`` key is not a field in either package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class DurationPredictorLoss:
    offset: float = 1.0

    def __call__(self, outputs: torch.Tensor, targets: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        targets = torch.log(targets.to(outputs.dtype) + self.offset)
        sq = (outputs - targets) ** 2
        if mask is not None:
            mask = mask.to(outputs.dtype)
            return torch.sum(sq * mask) / torch.clamp(torch.sum(mask),
                                                      min=1.0)
        return torch.mean(sq)
