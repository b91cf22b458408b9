"""Duration predictor, length regulator and variance predictor, channels-last.

Counterpart of ``parallelwavegan_tpu/layers/duration.py``. The duration
predictor is FastSpeech's: per layer a conv (``conv_<i>``), ReLU, a channel
LayerNorm (``norm_<i>``) and dropout, then ``linear`` to one channel; it
predicts log-durations, and ``inference`` turns them into integer durations
clip(round(exp(d) - offset), 0), rounding half to even as ``jnp.round``
does. ``length_regulator`` expands each symbol by its duration into a
sequence of the static length ``max_len``, as the JAX package does it:
an all-zero row falls back to duration 1 per symbol, a position past the
last symbol's end reads the last symbol, and positions past the sum of the
durations are zero-filled (the downstream convs see those zeros, so the
fill is observable). ``length_regulator_np`` is the host's dynamic-length
version for data preparation.

Dropout (the duration predictor's and the variance predictor's) takes its
keep masks from the caller, never drawn inside the forward: one bool mask
of (B, T, n_chans) per layer, in layer order (``draw_dropout_masks``
draws them from a ``torch.Generator``: uniform < keep probability, as
flax's ``bernoulli``). A kept entry is x / keep (the keep probability
rounded to x's dtype, as flax divides by a weakly typed scalar), a
dropped one 0.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from parallelwavegan_torch.layers.common import (
    ChannelLayerNorm,
    Conv1d,
    Dense,
    apply_dropout_mask,
    draw_keep_masks,
    torch_conv_default_init,
)
from parallelwavegan_torch.ops.conv import conv1d_product


class _ConvNormStack(nn.Module):
    """n_layers x (conv, ReLU, ChannelLayerNorm, dropout), then ``linear``
    to one channel: (B, T, in_channels) -> (B, T). Each conv is one matrix
    product (``ops.conv.conv1d_product``) on every device: on the card,
    cuDNN's f32 conv at this shape rounds 2-5 x more than a product."""

    def __init__(self, in_channels: int, n_layers: int, n_chans: int,
                 kernel_size: int, dropout_rate: float, bias: bool = True,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_layers, self.n_chans = n_layers, n_chans
        self.dropout_rate = float(dropout_rate)
        self.convs: List[Conv1d] = []
        self.norms: List[ChannelLayerNorm] = []
        cin = in_channels
        for i in range(n_layers):
            conv = Conv1d(cin, n_chans, kernel_size, bias=bias,
                          padding=(kernel_size - 1) // 2,
                          kernel_init=torch_conv_default_init,
                          bias_init=None, generator=generator)
            norm = ChannelLayerNorm(n_chans)
            self.add_module(f"conv_{i}", conv)
            self.add_module(f"norm_{i}", norm)
            self.convs.append(conv)
            self.norms.append(norm)
            cin = n_chans
        self.linear = Dense(cin, 1, generator=generator)
        self.act = F.relu

    def draw_dropout_masks(self, batch: int, length: int,
                           generator: Optional[torch.Generator] = None
                           ) -> List[torch.Tensor]:
        """Keep masks (bool, on ``generator``'s device) of the dropout
        layers for an input of (batch, length, C), in layer order: uniform
        < 1 - rate. An empty list when the rate is 0."""
        return draw_keep_masks([(batch, length, self.n_chans)]
                               * self.n_layers, self.dropout_rate, generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        drop = not deterministic and self.dropout_rate > 0.0
        if drop and masks is None:
            raise ValueError("dropout is on (deterministic=False): pass the "
                             "masks, drawn by draw_dropout_masks")
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            h = conv1d_product(x, conv.folded_kernel(), conv.bias,
                               conv.padding)
            x = norm(self.act(h))
            if drop:
                x = apply_dropout_mask(x, masks[i], self.dropout_rate)
        return self.linear(x)[..., 0]


class DurationPredictor(_ConvNormStack):
    """FastSpeech's duration predictor: (B, T, in_channels) -> predicted
    log-durations (B, T)."""

    def __init__(self, in_channels: int, n_layers: int = 2,
                 n_chans: int = 384, kernel_size: int = 3,
                 dropout_rate: float = 0.1, offset: float = 1.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, n_layers, n_chans, kernel_size,
                         dropout_rate, generator=generator)
        self.offset = float(offset)

    def inference(self, x: torch.Tensor) -> torch.Tensor:
        """Integer durations (B, T), int64: the deterministic forward's
        clip(round(exp(d) - offset), 0)."""
        return durations_from_log(self(x, True), self.offset)


def durations_from_log(log_d: torch.Tensor, offset: float) -> torch.Tensor:
    """clip(round(exp(log_d) - offset), 0) as int64, in log_d's dtype;
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    return torch.clamp(torch.round(torch.exp(log_d) - offset),
                       min=0.0).long()


def length_regulator(x: torch.Tensor, durations: torch.Tensor, max_len: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand (B, T, C) by per-symbol durations (B, T) to (B, max_len, C).

    Returns (expanded, mask), mask (B, max_len) marking the frames before
    the sum of the durations; the other frames are 0. A row of all-zero
    durations takes duration 1 per symbol; frame p reads the first symbol
    whose cumulative end exceeds p, clamped to the last symbol."""
    durations = durations.long()
    total = durations.sum(dim=1, keepdim=True)
    durations = torch.where(total == 0, torch.ones_like(durations),
                            durations)
    ends = torch.cumsum(durations, dim=1)  # non-decreasing
    pos = torch.arange(max_len, device=x.device)
    idx = torch.searchsorted(ends, pos.expand(x.shape[0], max_len)
                             .contiguous(), right=True)
    idx = torch.clamp(idx, max=x.shape[1] - 1)
    expanded = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    mask = pos[None, :] < durations.sum(dim=1, keepdim=True)
    return torch.where(mask[..., None], expanded,
                       torch.zeros_like(expanded)), mask


def length_regulator_np(x: np.ndarray, durations: np.ndarray) -> np.ndarray:
    """Host-side dynamic-length regulator for data preparation: (T, C) and
    (T,) -> (sum(durations), C); all-zero durations count 1 each."""
    durations = np.asarray(durations, dtype=np.int64)
    if durations.sum() == 0:
        durations = np.ones_like(durations)
    return np.repeat(x, durations, axis=0)


class VariancePredictor(_ConvNormStack):
    """FastSpeech 2's variance predictor (declared in the reference and
    wired to nothing, as in the JAX package): (B, T, in_channels) -> (B, T).
    """

    def __init__(self, in_channels: int, n_layers: int = 2,
                 n_chans: int = 384, kernel_size: int = 3, bias: bool = True,
                 dropout_rate: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, n_layers, n_chans, kernel_size,
                         dropout_rate, bias, generator=generator)
