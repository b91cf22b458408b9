"""Feature-matching loss over discriminator feature maps.

Counterpart of ``parallelwavegan_tpu/losses/feat_match.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class FeatureMatchLoss:
    average_by_layers: bool = True
    average_by_discriminators: bool = True
    include_final_outputs: bool = False

    def __call__(self, feats_hat, feats) -> torch.Tensor:
        """feats_hat, feats: a list (per discriminator) of lists (per
        layer, the logits last); the real features carry no gradient."""
        total = 0.0
        n_disc = 0
        for feats_hat_, feats_ in zip(feats_hat, feats):
            n_disc += 1
            if not self.include_final_outputs:
                feats_hat_ = feats_hat_[:-1]
                feats_ = feats_[:-1]
            disc_loss = 0.0
            n_layers = 0
            for f_hat, f in zip(feats_hat_, feats_):
                n_layers += 1
                disc_loss = disc_loss + torch.mean(
                    torch.abs(f_hat - f.detach()))
            if self.average_by_layers:
                disc_loss = disc_loss / n_layers
            total = total + disc_loss
        if self.average_by_discriminators:
            total = total / n_disc
        return total
