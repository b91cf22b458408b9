"""Vector-quantisation codebook with the straight-through estimator.

Counterpart of ``VQCodebook`` in ``parallelwavegan_tpu/layers/vq.py``. The
nearest code of each latent is the argmin of ||z||^2 - 2 z.e + ||e||^2,
written as the JAX module writes it (not ``torch.cdist``, which rounds
otherwise), so that codes near a tie fall the same way in both packages;
``torch.argmin`` takes the first minimum, as ``jnp.argmin`` does. The
embedding (``embedding``, (K, D)) starts at U(+-1/K) from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def code_distances(z: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """||z||^2 - 2 z.e + ||e||^2 for z (..., D) and the rows of embedding
    (K, D): (..., K), in the dtype of z."""
    return (torch.sum(z ** 2, dim=-1, keepdim=True)
            - 2.0 * z @ embedding.t()
            + torch.sum(embedding ** 2, dim=-1))


def code_gaps(z_e: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """Per latent of z_e (..., D), the float64 gap between its two nearest
    codes' distances over ||z||^2 + max ||e||^2, the scale of the terms
    the distance is summed from: where it is below about 1e-5, f32
    rounding may take either code, so two routes (the card and the CPU,
    f32 and float64) may differ there. Flattened to (N,)."""
    z = z_e.detach().double().cpu().reshape(-1, z_e.shape[-1])
    e = embedding.detach().double().cpu()
    zz, ee = (z ** 2).sum(-1), (e ** 2).sum(-1)
    two = torch.topk(code_distances(z, e), 2, dim=-1, largest=False).values
    return (two[:, 1] - two[:, 0]) / (zz + ee.max())


class VQCodebook(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / num_embeddings
        self.embedding = nn.Parameter(
            (torch.rand((num_embeddings, embedding_dim), generator=generator)
             * 2 - 1) * bound)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """Nearest code indices for z (B, T, D) -> (B, T), int64."""
        return torch.argmin(code_distances(z, self.embedding), dim=-1)

    def straight_through(self, z: torch.Tensor,
                         indices: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(decoder input z + sg(z_q - z), z_q). ``indices`` replaces the
        nearest codes (a gradient check holds several routes on one set of
        codes); None takes them from z."""
        idx = self(z) if indices is None else indices
        z_q = self.lookup(idx)
        return z + (z_q - z).detach(), z_q

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        """The rows of the given code indices: (...) -> (..., D)."""
        return F.embedding(indices.long(), self.embedding)
