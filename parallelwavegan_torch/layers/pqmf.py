"""PQMF filterbank as a small stateless object.

Counterpart of ``parallelwavegan_tpu/layers/pqmf.py``: the filters are
constants (``ops/pqmf.py`` makes them once per device and dtype), not
parameters, so a multi-band generator's state_dict holds none of them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from parallelwavegan_torch.ops.pqmf import pqmf_analysis, pqmf_synthesis


@dataclass(frozen=True)
class PQMF:
    subbands: int = 4
    taps: int = 62
    cutoff_ratio: float = 0.142
    beta: float = 9.0

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, 1) -> (B, T / subbands, subbands)."""
        return pqmf_analysis(x, self.subbands, self.taps, self.cutoff_ratio,
                             self.beta)

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T / subbands, subbands) -> (B, T, 1)."""
        return pqmf_synthesis(x, self.subbands, self.taps, self.cutoff_ratio,
                              self.beta)
