"""MelGAN generator and discriminators, channels-last (B, T, C).

Counterparts of ``MelGANGenerator``, ``MelGANDiscriminator`` and
``MelGANMultiScaleDiscriminator`` in ``parallelwavegan_tpu/models/
melgan.py``. The generator: Conv7 -> per scale [activation, transposed conv (k = 2 s),
``stacks`` residual stacks with dilations k^j] -> activation, Conv7
(-> tanh). With ``out_channels`` > 1 it is a multi-band generator whose
subbands the caller merges by PQMF synthesis (``InferenceModel`` does).
``use_causal_conv`` swaps in the causal convs and upsamplers. Submodules
are named ``layer_<i>`` in order, as in the flax tree, so a converted tree
loads with ``strict=True``. The convs take N(0, 0.02) kernels and torch's
uniform biases, as the JAX module's.

``folded=True`` (the default, the serving form) holds every kernel with
weight norm applied; ``folded=False`` holds ``kernel_v``/``kernel_g``
where ``use_weight_norm`` asks for them.

The discriminator is a reflect-padded conv of kernel prod(kernel_sizes),
grouped strided convs (kernel 10 s + 1, ``in_chs // 4`` groups) per
downsampling scale, then two plain convs; it returns every layer's feature
map, the logits last. The multi-scale discriminator runs copies of it on
the signal average-pooled between scales and returns their lists.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from parallelwavegan_torch.layers.causal_conv import (
    CausalConv1d,
    CausalConvTranspose1d,
)
from parallelwavegan_torch.layers.common import (
    Conv1d,
    ConvTranspose1d,
    get_activation,
    normal_init,
    pad_mode_from_torch,
)
from parallelwavegan_torch.layers.residual_stack import ResidualStack
from parallelwavegan_torch.ops.conv import avg_pool1d, pad1d


class MelGANGenerator(nn.Module):
    """Mel (B, T', in_channels) -> (B, T' * prod(scales), out_channels)."""

    def __init__(
        self,
        in_channels: int = 80,
        out_channels: int = 1,
        kernel_size: int = 7,
        channels: int = 512,
        bias: bool = True,
        upsample_scales: Sequence[int] = (8, 8, 2, 2),
        stack_kernel_size: int = 3,
        stacks: int = 3,
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: Optional[Dict[str, Any]] = None,
        pad: str = "ReflectionPad1d",
        pad_params: Optional[Dict[str, Any]] = None,
        use_final_nonlinear_activation: bool = True,
        use_weight_norm: bool = True,
        use_causal_conv: bool = False,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        # pad_params is read by neither package: the reference's pads take
        # none but ConstantPad1d's value, which the JAX module fixes at 0
        del pad_params
        if channels < math.prod(upsample_scales):
            raise ValueError("channels must be at least prod(upsample_scales)")
        if channels % (2 ** len(upsample_scales)):
            raise ValueError("channels must be divisible by "
                             "2 ** len(upsample_scales)")
        if not use_causal_conv and (kernel_size - 1) % 2:
            raise ValueError("kernel_size must be odd")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.upsample_scales = tuple(upsample_scales)
        self.use_causal_conv = use_causal_conv
        self.use_final_nonlinear_activation = use_final_nonlinear_activation
        self.stacks = stacks
        act_params = dict({"negative_slope": 0.2},
                          **(nonlinear_activation_params or {}))
        self.act = get_activation(nonlinear_activation, act_params)
        self.pad_mode = pad_mode_from_torch(pad)
        self.edge = (kernel_size - 1) // 2
        kw = dict(bias=bias, kernel_init=normal_init(0.02),
                  use_weight_norm=use_weight_norm and not folded,
                  generator=generator)
        self.layers: List[nn.Module] = []

        def conv7(cin: int, cout: int) -> nn.Module:
            if use_causal_conv:
                return CausalConv1d(cin, cout, kernel_size, pad=pad, **kw)
            return Conv1d(cin, cout, kernel_size, bias_init=None, **kw)

        self._add(conv7(in_channels, channels))
        for i, s in enumerate(self.upsample_scales):
            cin, cout = channels // 2 ** i, channels // 2 ** (i + 1)
            if use_causal_conv:
                self._add(CausalConvTranspose1d(cin, cout, 2 * s, stride=s,
                                                **kw))
            else:
                self._add(ConvTranspose1d(cin, cout, 2 * s, stride=s,
                                          padding=s // 2 + s % 2,
                                          output_padding=s % 2, **kw))
            for j in range(stacks):
                self._add(ResidualStack(
                    kernel_size=stack_kernel_size, channels=cout,
                    dilation=stack_kernel_size ** j,
                    nonlinear_activation=nonlinear_activation,
                    nonlinear_activation_params=act_params, pad=pad,
                    use_causal_conv=use_causal_conv, **kw))
        self._add(conv7(channels // 2 ** len(self.upsample_scales),
                        out_channels))

    def _add(self, module: nn.Module) -> None:
        self.add_module(f"layer_{len(self.layers)}", module)
        self.layers.append(module)

    @property
    def upsample_factor(self) -> int:
        return math.prod(self.upsample_scales)

    def _conv7(self, layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if not self.use_causal_conv:
            x = pad1d(x, (self.edge, self.edge), self.pad_mode)
        return layer(x)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        x = self._conv7(self.layers[0], c)
        i = 1
        for _ in self.upsample_scales:
            x = self.layers[i](self.act(x))
            for stack in self.layers[i + 1: i + 1 + self.stacks]:
                x = stack(x)
            i += 1 + self.stacks
        x = self._conv7(self.layers[i], self.act(x))
        return torch.tanh(x) if self.use_final_nonlinear_activation else x


class MelGANDiscriminator(nn.Module):
    """(B, T, in_channels) -> the list of every layer's feature map, the
    logits (B, T / prod(downsample_scales), out_channels) last. Submodules
    are ``layer_<i>``, as in the flax tree; N(0, 0.02) kernels and torch's
    uniform biases, as the JAX module's."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        kernel_sizes: Sequence[int] = (5, 3),
        channels: int = 16,
        max_downsample_channels: int = 1024,
        bias: bool = True,
        downsample_scales: Sequence[int] = (4, 4, 4, 4),
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: Optional[Dict[str, Any]] = None,
        pad: str = "ReflectionPad1d",
        pad_params: Optional[Dict[str, Any]] = None,
        use_weight_norm: bool = True,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        del pad_params  # read by neither package, as the generator's
        if len(kernel_sizes) != 2 or not all(k % 2 for k in kernel_sizes):
            raise ValueError("kernel_sizes must be two odd sizes")
        self.act = get_activation(
            nonlinear_activation,
            dict({"negative_slope": 0.2}, **(nonlinear_activation_params
                                              or {})))
        self.pad_mode = pad_mode_from_torch(pad)
        k0 = math.prod(kernel_sizes)
        self.edge = (k0 - 1) // 2
        kw = dict(bias=bias, kernel_init=normal_init(0.02), bias_init=None,
                  use_weight_norm=use_weight_norm and not folded,
                  generator=generator)
        self.layers: List[Conv1d] = []
        self._add(Conv1d(in_channels, channels, k0, **kw))
        in_chs = channels
        for s in downsample_scales:
            out_chs = min(in_chs * s, max_downsample_channels)
            self._add(Conv1d(in_chs, out_chs, s * 10 + 1, stride=s,
                             padding=s * 5, groups=in_chs // 4, **kw))
            in_chs = out_chs
        out_chs = min(in_chs * 2, max_downsample_channels)
        self._add(Conv1d(in_chs, out_chs, kernel_sizes[0],
                         padding=(kernel_sizes[0] - 1) // 2, **kw))
        self._add(Conv1d(out_chs, out_channels, kernel_sizes[1],
                         padding=(kernel_sizes[1] - 1) // 2, **kw))

    def _add(self, module: nn.Module) -> None:
        self.add_module(f"layer_{len(self.layers)}", module)
        self.layers.append(module)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = pad1d(x, (self.edge, self.edge), self.pad_mode)
        outs = []
        for layer in self.layers[:-1]:
            x = self.act(layer(x))
            outs.append(x)
        outs.append(self.layers[-1](x))
        return outs


class MelGANMultiScaleDiscriminator(nn.Module):
    """``scales`` MelGAN discriminators (``discriminators_<i>``) on the
    signal average-pooled between scales; returns their lists of feature
    maps. Pooling other than ``AvgPool1d`` raises, as in the JAX module."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        scales: int = 3,
        downsample_pooling: str = "AvgPool1d",
        downsample_pooling_params: Optional[Dict[str, Any]] = None,
        kernel_sizes: Sequence[int] = (5, 3),
        channels: int = 16,
        max_downsample_channels: int = 1024,
        bias: bool = True,
        downsample_scales: Sequence[int] = (4, 4, 4, 4),
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: Optional[Dict[str, Any]] = None,
        pad: str = "ReflectionPad1d",
        pad_params: Optional[Dict[str, Any]] = None,
        use_weight_norm: bool = True,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if downsample_pooling != "AvgPool1d":
            raise NotImplementedError(
                f"downsample_pooling {downsample_pooling} is not ported")
        self.pool_params = dict(
            {"kernel_size": 4, "stride": 2, "padding": 1,
             "count_include_pad": False},
            **(downsample_pooling_params or {}))
        self.discriminators: List[MelGANDiscriminator] = []
        for i in range(scales):
            dis = MelGANDiscriminator(
                in_channels=in_channels, out_channels=out_channels,
                kernel_sizes=kernel_sizes, channels=channels,
                max_downsample_channels=max_downsample_channels, bias=bias,
                downsample_scales=downsample_scales,
                nonlinear_activation=nonlinear_activation,
                nonlinear_activation_params=nonlinear_activation_params,
                pad=pad, pad_params=pad_params,
                use_weight_norm=use_weight_norm, folded=folded,
                generator=generator)
            self.add_module(f"discriminators_{i}", dis)
            self.discriminators.append(dis)

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        outs = []
        for dis in self.discriminators:
            outs.append(dis(x))
            x = avg_pool1d(x, **self.pool_params)
        return outs
