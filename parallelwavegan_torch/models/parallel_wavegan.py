"""Parallel WaveGAN generator and discriminator, channels-last (B, T, C).

Counterpart of ``ParallelWaveGANGenerator``,
``ParallelWaveGANDiscriminator`` and ``ResidualParallelWaveGANDiscriminator``
in ``parallelwavegan_tpu/models/parallel_wavegan.py``. Submodule and parameter
names follow the JAX package's parameter tree (``upsample_net``,
``first_conv``, ``conv_layers_<i>``, ``last_conv_0``/``_1``; ``conv_<i>``,
``last_conv``), so a converted flax tree
(``utils.params.convert_jax_params``) loads with ``strict=True``.

Each model comes in two parameter forms. ``folded=True`` (the default, the
serving form) holds every kernel with weight norm already applied, whatever
``use_weight_norm`` says. ``folded=False`` (the training form, what
``engine.build.build_models`` makes) holds ``kernel_v``/``kernel_g`` where
``use_weight_norm`` asks for them, as the JAX package trains them.

The generator's plain forward runs every layer unfused; ``fused=True``
routes it through ``ops/cuda/pwg_infer.pwg_fused_forward`` (the CUDA
kernels). Its ``upsample_net`` is ``ConvInUpsampleNetwork`` (the default),
``UpsampleNetwork`` or a ``MelGANGenerator`` (no weight norm, no final
activation, ``aux_context_window`` 0), as in the JAX package. Dropout in
the WaveNet blocks (the generator's and the residual discriminator's)
takes keep masks from the caller, one (B, T, residual_channels) mask a
layer in layer order (``draw_dropout_masks``), never drawn inside the
forward: the train step draws them from its dropout source.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from parallelwavegan_torch.layers.common import (
    Conv1d,
    draw_keep_masks,
    get_activation,
    kaiming_normal_relu_init,
)
from parallelwavegan_torch.layers.residual_block import WaveNetResidualBlock
from parallelwavegan_torch.layers.upsample import (
    ConvInUpsampleNetwork,
    UpsampleNetwork,
)

_DEFAULT_UPSAMPLE = {"upsample_scales": [4, 4, 4, 4]}


class ParallelWaveGANGenerator(nn.Module):
    """Non-causal WaveNet on noise z conditioned on upsampled mel."""

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
        upsample_conditional_features: bool = True,
        upsample_net: str = "ConvInUpsampleNetwork",
        upsample_params: Optional[Dict[str, Any]] = None,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        weight_norm = use_weight_norm and not folded
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

        # without upsample_conditional_features c comes at the sample rate
        self.upsample_net = _upsample_net(
            upsample_net, up_params, aux_channels, aux_context_window,
            weight_norm, folded, generator
        ) if upsample_conditional_features else None
        self.first_conv = Conv1d(in_channels, residual_channels, 1,
                                 use_weight_norm=weight_norm,
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
                use_weight_norm=weight_norm,
                generator=generator,
            )
            self.add_module(f"conv_layers_{layer}", block)
            self.conv_layers.append(block)
        self.last_conv_0 = Conv1d(skip_channels, skip_channels, 1,
                                  use_weight_norm=weight_norm,
                                  generator=generator)
        self.last_conv_1 = Conv1d(skip_channels, out_channels, 1,
                                  use_weight_norm=weight_norm,
                                  generator=generator)
        # the tail's two ReLUs, as an attribute that a check can swap for
        # one with decided branches (chip_smoke.py's gradient gates)
        self.act = F.relu

    @property
    def upsample_factor(self) -> int:
        if self.upsample_net is None:
            return 1
        return math.prod(self.upsample_scales)

    @property
    def dilations(self) -> List[int]:
        lpc = self.layers // self.stacks
        return [2 ** (i % lpc) for i in range(self.layers)]

    def dropout_shapes(self, batch: int, samples: int
                       ) -> List[Tuple[int, int, int]]:
        """The dropout layers' input shapes, in call order, for noise of
        (batch, samples, in_channels)."""
        return [(batch, samples, self.residual_channels)] * self.layers

    def draw_dropout_masks(self, batch: int, samples: int,
                           generator: Optional[torch.Generator] = None
                           ) -> List[torch.Tensor]:
        """Keep masks (bool, on ``generator``'s device) of every layer's
        dropout, in layer order: uniform < 1 - dropout. An empty list when
        the rate is 0."""
        return draw_keep_masks(self.dropout_shapes(batch, samples),
                               self.dropout, generator)

    def batch_dropout_masks(self, batch: Dict[str, torch.Tensor],
                            generator: Optional[torch.Generator] = None
                            ) -> List[torch.Tensor]:
        """``draw_dropout_masks`` for a training forward of ``batch`` (its
        noise z (B, T, in_channels))."""
        B, T = batch["z"].shape[:2]
        return self.draw_dropout_masks(B, T, generator)

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor],
                fused: bool = False, trainable: bool = False,
                masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """z (B, T, in_channels) noise; c (B, T'(+2*ctx), aux) mel.

        Returns (B, T, out_channels). ``fused`` takes the fused path
        (``pwg_fused_forward``, with its ``trainable`` grouping and
        backward kernel) instead of the per-layer one below. ``masks``
        (``draw_dropout_masks``'s list) turns the dropout on.
        """
        if fused:
            from parallelwavegan_torch.ops.cuda.pwg_infer import (
                pwg_fused_forward,
            )

            return pwg_fused_forward(self, z, c, trainable=trainable)
        if c is not None:
            if self.upsample_net is not None:
                c = self.upsample_net(c)
            if c.shape[1] != z.shape[1]:
                raise ValueError(f"upsampled c {tuple(c.shape)} vs z "
                                 f"{tuple(z.shape)}")
        x = self.first_conv(z)
        skips = 0.0
        for i, block in enumerate(self.conv_layers):
            x, h = block(x, c, masks[i] if masks else None)
            skips = skips + h
        x = self.act(skips * math.sqrt(1.0 / self.layers))
        x = self.act(self.last_conv_0(x))
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


def _upsample_net(kind: str, up_params: Dict[str, Any], aux_channels: int,
                  aux_context_window: int, weight_norm: bool, folded: bool,
                  generator: Optional[torch.Generator]) -> nn.Module:
    """The generator's ``upsample_net`` of the config's type, as the JAX
    package's ``make_upsample_module`` builds it."""
    if kind == "ConvInUpsampleNetwork":
        return ConvInUpsampleNetwork(
            aux_channels=aux_channels, aux_context_window=aux_context_window,
            use_weight_norm=weight_norm, generator=generator, **up_params)
    if kind == "UpsampleNetwork":
        return UpsampleNetwork(use_weight_norm=weight_norm,
                               generator=generator, **up_params)
    if kind == "MelGANGenerator":
        from parallelwavegan_torch.models.melgan import MelGANGenerator

        if aux_context_window != 0:
            raise ValueError("a MelGANGenerator upsample_net takes "
                             "aux_context_window 0")
        return MelGANGenerator(
            **dict(up_params, use_weight_norm=False,
                   use_final_nonlinear_activation=False),
            folded=folded, generator=generator)
    raise ValueError(f"unknown upsample_net: {kind}")


class ParallelWaveGANDiscriminator(nn.Module):
    """Dilated conv stack (dilations 1, 1, 2, ..., layers - 2 with
    ``dilation_factor`` 1, else factor ** i) with LeakyReLU(0.2) between;
    returns (B, T, out_channels) logits."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        kernel_size: int = 3,
        layers: int = 10,
        conv_channels: int = 64,
        dilation_factor: int = 1,
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: Optional[Dict[str, Any]] = None,
        bias: bool = True,
        use_weight_norm: bool = True,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if (kernel_size - 1) % 2:
            raise ValueError("kernel_size must be odd")
        if dilation_factor <= 0:
            raise ValueError("dilation_factor must be positive")
        self.layers = layers
        self.act = get_activation(
            nonlinear_activation,
            dict({"negative_slope": 0.2}, **(nonlinear_activation_params or {})),
        )
        weight_norm = use_weight_norm and not folded
        channels = in_channels
        for i in range(layers - 1):
            if i == 0:
                dilation = 1
            else:
                dilation = i if dilation_factor == 1 else dilation_factor ** i
            self.add_module(f"conv_{i}", Conv1d(
                channels, conv_channels, kernel_size, dilation=dilation,
                bias=bias, padding=(kernel_size - 1) // 2 * dilation,
                use_weight_norm=weight_norm, generator=generator,
            ))
            channels = conv_channels
        self.last_conv = Conv1d(
            channels, out_channels, kernel_size, bias=bias,
            padding=(kernel_size - 1) // 2, use_weight_norm=weight_norm,
            generator=generator,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers - 1):
            x = self.act(getattr(self, f"conv_{i}")(x))
        return self.last_conv(x)


class ResidualParallelWaveGANDiscriminator(nn.Module):
    """WaveNet-style discriminator without conditioning: first 1x1 +
    activation, ``layers`` gated residual blocks (``aux_channels=0``,
    dilations 2 ** (i % (layers / stacks))), the skip sum x sqrt(1 /
    layers), then activation, 1x1, activation, 1x1 -> (B, T, out_channels)
    logits. Names ``first_conv``, ``conv_layers_<i>``, ``last_conv_0`` /
    ``_1``, as in the flax tree."""

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
        dropout: float = 0.0,
        bias: bool = True,
        use_weight_norm: bool = True,
        use_causal_conv: bool = False,
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: Optional[Dict[str, Any]] = None,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if (kernel_size - 1) % 2:
            raise ValueError("kernel_size must be odd")
        if layers % stacks:
            raise ValueError("layers must be divisible by stacks")
        self.act = get_activation(
            nonlinear_activation,
            dict({"negative_slope": 0.2}, **(nonlinear_activation_params or {})),
        )
        weight_norm = use_weight_norm and not folded
        kw = dict(bias=True, kernel_init=kaiming_normal_relu_init,
                  use_weight_norm=weight_norm, generator=generator)
        self.first_conv = Conv1d(in_channels, residual_channels, 1, **kw)
        lpc = layers // stacks
        self.conv_layers: List[WaveNetResidualBlock] = []
        for i in range(layers):
            block = WaveNetResidualBlock(
                kernel_size=kernel_size, residual_channels=residual_channels,
                gate_channels=gate_channels, skip_channels=skip_channels,
                aux_channels=0, dropout=dropout, dilation=2 ** (i % lpc),
                bias=bias, use_causal_conv=use_causal_conv,
                use_weight_norm=weight_norm, generator=generator,
            )
            self.add_module(f"conv_layers_{i}", block)
            self.conv_layers.append(block)
        self.last_conv_0 = Conv1d(skip_channels, skip_channels, 1, **kw)
        self.last_conv_1 = Conv1d(skip_channels, out_channels, 1, **kw)
        self.dropout = float(dropout)
        self.residual_channels = residual_channels

    def draw_dropout_masks(self, batch: int, samples: int,
                           generator: Optional[torch.Generator] = None
                           ) -> List[torch.Tensor]:
        """Keep masks of every layer's dropout for an input of (batch,
        samples, in_channels), in layer order, as the generator's."""
        return draw_keep_masks(
            [(batch, samples, self.residual_channels)]
            * len(self.conv_layers), self.dropout, generator)

    def forward(self, x: torch.Tensor,
                masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """``masks`` (``draw_dropout_masks``'s list) turns the dropout
        on."""
        x = self.act(self.first_conv(x))
        skips = 0.0
        for i, block in enumerate(self.conv_layers):
            x, h = block(x, None, masks[i] if masks else None)
            skips = skips + h
        x = self.act(skips * math.sqrt(1.0 / len(self.conv_layers)))
        return self.last_conv_1(self.act(self.last_conv_0(x)))
