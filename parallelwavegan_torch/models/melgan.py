"""MelGAN generator, channels-last (B, T, C).

Counterpart of ``MelGANGenerator`` in ``parallelwavegan_tpu/models/
melgan.py``: Conv7 -> per scale [activation, transposed conv (k = 2 s),
``stacks`` residual stacks with dilations k^j] -> activation, Conv7
(-> tanh). With ``out_channels`` > 1 it is a multi-band generator whose
subbands the caller merges by PQMF synthesis (``InferenceModel`` does).
``use_causal_conv`` swaps in the causal convs and upsamplers. Submodules
are named ``layer_<i>`` in order, as in the flax tree, so a converted tree
loads with ``strict=True``. The convs take N(0, 0.02) kernels and torch's
uniform biases, as the JAX module's.

``folded=True`` (the default, the serving form) holds every kernel with
weight norm applied; ``folded=False`` holds ``kernel_v``/``kernel_g``
where ``use_weight_norm`` asks for them. The discriminators are not
ported yet.
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
from parallelwavegan_torch.ops.conv import pad1d


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
