"""Mel upsampling networks for Parallel WaveGAN, channels-last (B, T, C).

Counterpart of ``parallelwavegan_tpu/layers/upsample.py``. Each nearest
stretch x s followed by the (freq_k, 2s+1) mean-init smoothing Conv2d is
evaluated as a polyphase filter: output sample t = u*s + p depends on the
coarse frames u-1, u, u+1 only, with per-phase weights W[p, j] = the sum of
the conv taps that land on coarse frame u+j-1 at phase p. A stage is then
3 multiply-adds per freq tap over (B, T0, s, C), without building the
(B, 1, C, T) image the reference convolves. The parameter keeps the
Conv2d's (freq_k, 2s+1, 1, 1) layout, so checkpoints map one to one.
``use_causal_conv`` shifts the smoothing conv onto the past (coarse frames
u-2, u-1, u), and ``ConvInUpsampleNetwork``'s context conv then spans
aux_context_window + 1 frames, its last aux_context_window outputs cut.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from parallelwavegan_torch.layers.common import (
    Conv1d,
    WeightNormedConv,
    get_activation,
    mean_filter_init,
)

_N_TAPS = 3


def _polyphase_matrix(scale: int, kt: int, tp: int, n_taps: int,
                      j_start: int) -> np.ndarray:
    """0/1 matrix M (scale*n_taps, kt) with W = M @ k_time.

    Output t = u*scale + p equals sum_dt k[dt] * stretched[t + dt - tp] where
    stretched[m] = coarse[m // scale]; tap j covers coarse frame u + j_start
    + j, i.e. the dt with (t + dt - tp) // scale == u + j_start + j.
    """
    M = np.zeros((scale * n_taps, kt), dtype=np.float32)
    for p in range(scale):
        for j in range(n_taps):
            lo = (j_start + j) * scale + tp - p
            hi = lo + scale - 1
            for dt in range(max(lo, 0), min(hi, kt - 1) + 1):
                M[p * n_taps + j, dt] = 1.0
    return M


class _PolyphaseSmoothingConv(WeightNormedConv):
    """The reference's 1-channel smoothing Conv2d, evaluated polyphase."""

    def __init__(self, scale: int, freq_axis_kernel_size: int = 1,
                 use_causal_conv: bool = False,
                 use_weight_norm: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale = scale
        self.freq_axis_kernel_size = freq_axis_kernel_size
        # the coarse frames an output sees: u-1, u, u+1, or causal u-2..u
        self.j_start = -2 if use_causal_conv else -1
        kt = 2 * scale + 1
        self.init_kernel((freq_axis_kernel_size, kt, 1, 1), mean_filter_init,
                         use_weight_norm, generator)
        self.register_buffer(
            "phase_matrix",
            torch.from_numpy(_polyphase_matrix(
                scale, kt, 2 * scale if use_causal_conv else scale, _N_TAPS,
                self.j_start)),
            persistent=False,
        )

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        fk, s = self.freq_axis_kernel_size, self.scale
        M = self.phase_matrix.to(c.dtype)
        kernel = self.folded_kernel()[..., 0, 0].to(c.dtype)
        W = (kernel @ M.T).reshape(fk, s, _N_TAPS)
        B, T0, C = c.shape
        fp = (fk - 1) // 2
        cpad = F.pad(c, (fp, fp, -self.j_start, _N_TAPS - 1 + self.j_start))
        out = torch.zeros((B, T0, s, C), dtype=c.dtype, device=c.device)
        for df in range(fk):
            for j in range(_N_TAPS):
                view = cpad[:, j : j + T0, df : df + C]
                out = out + view[:, :, None, :] * W[df, :, j][None, None, :, None]
        return out.reshape(B, T0 * s, C)


class UpsampleNetwork(nn.Module):
    """Per scale s: nearest time-stretch x s, then the (freq_k, 2s+1)
    mean-init smoothing conv, fused into one polyphase stage."""

    def __init__(
        self,
        upsample_scales: Sequence[int],
        nonlinear_activation: Optional[str] = None,
        nonlinear_activation_params: Optional[dict] = None,
        interpolate_mode: str = "nearest",
        freq_axis_kernel_size: int = 1,
        use_causal_conv: bool = False,
        use_weight_norm: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if interpolate_mode != "nearest":
            raise ValueError("interpolate_mode must be nearest, as the JAX "
                             f"package asserts, not {interpolate_mode}")
        if (freq_axis_kernel_size - 1) % 2:
            raise ValueError("freq_axis_kernel_size must be odd")
        self.act = (
            get_activation(nonlinear_activation, nonlinear_activation_params)
            if nonlinear_activation is not None else None
        )
        self.n_stages = len(upsample_scales)
        for i, scale in enumerate(upsample_scales):
            self.add_module(f"conv_{i}", _PolyphaseSmoothingConv(
                scale, freq_axis_kernel_size, use_causal_conv,
                use_weight_norm, generator=generator,
            ))

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_stages):
            c = getattr(self, f"conv_{i}")(c)
            if self.act is not None:
                c = self.act(c)
        return c


class ConvInUpsampleNetwork(nn.Module):
    """Context Conv1d over +-aux_context_window frames, then UpsampleNetwork.

    The caller pre-pads the input by aux_context_window frames, so the
    context conv uses no padding.
    """

    def __init__(
        self,
        upsample_scales: Sequence[int],
        nonlinear_activation: Optional[str] = None,
        nonlinear_activation_params: Optional[dict] = None,
        interpolate_mode: str = "nearest",
        freq_axis_kernel_size: int = 1,
        aux_channels: int = 80,
        aux_context_window: int = 0,
        use_causal_conv: bool = False,
        use_weight_norm: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cut = aux_context_window if use_causal_conv else 0
        self.conv_in = Conv1d(aux_channels, aux_channels,
                              (aux_context_window + 1 if use_causal_conv
                               else 2 * aux_context_window + 1), bias=False,
                              use_weight_norm=use_weight_norm,
                              generator=generator)
        self.upsample = UpsampleNetwork(
            upsample_scales, nonlinear_activation, nonlinear_activation_params,
            interpolate_mode, freq_axis_kernel_size, use_causal_conv,
            use_weight_norm, generator=generator,
        )

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        c = self.conv_in(c)
        if self.cut:
            c = c[:, :-self.cut]
        return self.upsample(c)
