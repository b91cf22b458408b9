"""Parallel WaveGAN generator, channels-last (B, T, C).

Counterpart of ``ParallelWaveGANGenerator`` in
``parallelwavegan_tpu/models/parallel_wavegan.py``. Submodule and parameter
names follow the JAX package's parameter tree (``upsample_net``,
``first_conv``, ``conv_layers_<i>``, ``last_conv_0``/``_1``), so a converted
flax tree (``utils.params.convert_jax_params``) loads with ``strict=True``.
This forward runs every layer unfused; the serving path with the CUDA
kernel is ``ops/cuda/pwg_infer.pwg_fused_forward``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from parallelwavegan_torch.layers.common import Conv1d
from parallelwavegan_torch.layers.residual_block import WaveNetResidualBlock
from parallelwavegan_torch.layers.upsample import ConvInUpsampleNetwork

_DEFAULT_UPSAMPLE = {"upsample_scales": [4, 4, 4, 4]}


class ParallelWaveGANGenerator(nn.Module):
    """Non-causal WaveNet on noise z conditioned on upsampled mel.

    ``use_weight_norm`` is accepted for config compatibility; the modules
    hold folded kernels (inference only).
    """

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        kernel_size: int = 3,
        layers: int = 30,
        stacks: int = 3,
        residual_channels: int = 64,
        gate_channels: int = 128,
        skip_channels: int = 64,
        aux_channels: int = 80,
        aux_context_window: int = 2,
        dropout: float = 0.0,
        bias: bool = True,
        use_weight_norm: bool = True,
        use_causal_conv: bool = False,
        upsample_net: str = "ConvInUpsampleNetwork",
        upsample_params: Optional[Dict[str, Any]] = None,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if layers % stacks:
            raise ValueError("layers must be a multiple of stacks")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.layers, self.stacks = kernel_size, layers, stacks
        self.residual_channels = residual_channels
        self.gate_channels, self.skip_channels = gate_channels, skip_channels
        self.aux_channels = aux_channels
        self.aux_context_window = aux_context_window
        self.dropout, self.use_causal_conv = dropout, use_causal_conv
        up_params = dict(_DEFAULT_UPSAMPLE, **(upsample_params or {}))
        # the reference stores these in upsample_params; the arguments rule
        up_params.pop("aux_channels", None)
        up_params.pop("aux_context_window", None)
        up_params["use_causal_conv"] = use_causal_conv
        self.upsample_scales: List[int] = list(up_params["upsample_scales"])

        if upsample_net != "ConvInUpsampleNetwork":
            raise NotImplementedError(
                f"upsample_net {upsample_net} is not ported yet"
            )
        self.upsample_net = ConvInUpsampleNetwork(
            aux_channels=aux_channels, aux_context_window=aux_context_window,
            generator=generator, **up_params,
        )
        self.first_conv = Conv1d(in_channels, residual_channels, 1,
                                 generator=generator)
        lpc = layers // stacks
        self.conv_layers: List[WaveNetResidualBlock] = []
        for layer in range(layers):
            block = WaveNetResidualBlock(
                kernel_size=kernel_size,
                residual_channels=residual_channels,
                gate_channels=gate_channels,
                skip_channels=skip_channels,
                aux_channels=aux_channels,
                dilation=2 ** (layer % lpc),
                dropout=dropout,
                bias=bias,
                use_causal_conv=use_causal_conv,
                generator=generator,
            )
            self.add_module(f"conv_layers_{layer}", block)
            self.conv_layers.append(block)
        self.last_conv_0 = Conv1d(skip_channels, skip_channels, 1,
                                  generator=generator)
        self.last_conv_1 = Conv1d(skip_channels, out_channels, 1,
                                  generator=generator)

    @property
    def upsample_factor(self) -> int:
        return math.prod(self.upsample_scales)

    @property
    def dilations(self) -> List[int]:
        lpc = self.layers // self.stacks
        return [2 ** (i % lpc) for i in range(self.layers)]

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor]
                ) -> torch.Tensor:
        """z (B, T, in_channels) noise; c (B, T'(+2*ctx), aux) mel.

        Returns (B, T, out_channels).
        """
        if c is not None:
            c = self.upsample_net(c)
            if c.shape[1] != z.shape[1]:
                raise ValueError(f"upsampled c {tuple(c.shape)} vs z "
                                 f"{tuple(z.shape)}")
        x = self.first_conv(z)
        skips = 0.0
        for block in self.conv_layers:
            x, h = block(x, c)
            skips = skips + h
        x = F.relu(skips * math.sqrt(1.0 / self.layers))
        x = F.relu(self.last_conv_0(x))
        return self.last_conv_1(x)

    def inference(
        self,
        c: torch.Tensor,
        z: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        normalize_before: bool = False,
        mean: Optional[torch.Tensor] = None,
        scale: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Copy-synthesis: mel (T', C) -> wave (T, out_channels).

        The noise is ``z`` (1, T, in_channels) when given, else drawn from
        ``generator`` (a fresh one seeded 0 by default).
        """
        if normalize_before:
            c = (c - mean) / scale
        ctx = self.aux_context_window
        c = F.pad(c[None].transpose(1, 2), (ctx, ctx), mode="replicate")
        c = c.transpose(1, 2)
        T = (c.shape[1] - 2 * ctx) * self.upsample_factor
        if z is None:
            if generator is None:
                generator = torch.Generator(device=c.device).manual_seed(0)
            z = torch.randn((1, T, self.in_channels), generator=generator,
                            device=c.device, dtype=c.dtype)
        return self.forward(z, c)[0]
