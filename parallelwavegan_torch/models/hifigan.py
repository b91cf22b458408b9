"""HiFi-GAN generator and discriminators, channels-last (B, T, C).

Counterpart of ``parallelwavegan_tpu/models/hifigan.py``. The generator:
Conv7 -> per scale [LeakyReLU, transposed conv (k = 2 s), the mean of the
multi-receptive-field residual blocks] -> LeakyReLU(0.01), Conv7, tanh;
with ``use_causal_conv`` the convs are ``CausalConv1d`` and the transposed
convs ``CausalConvTranspose1d`` (``input_conv.conv``,
``upsamples_<i>.deconv`` in the flax tree). Submodule names follow the flax
tree (``input_conv``, ``upsamples_<i>``, ``blocks_<i * n + j>``,
``output_conv``), so a converted tree loads with ``strict=True``.

The discriminators return feature maps with the logits last: a period
discriminator folds the wave into a (T / p, p) image under (k, 1) convs; a
scale discriminator is a tower of grouped strided convs; the multi-scale
one runs scale discriminators on average-pooled copies (with
``follow_official_norm`` the first spectral-normed, the others
weight-normed); the multi-scale multi-period one returns the scale lists
followed by the period lists. Names again follow flax
(``msd.discriminators_0.layer_3``, ``mpd.discriminators_2.convs_1``,
``output_conv``). Their convs take torch's default uniform inits.

``folded=True`` (the default, the serving form) holds every kernel with
weight norm applied; ``folded=False`` holds ``kernel_v``/``kernel_g``
where ``use_weight_norm`` asks for them. The serving path
(``ops/hifigan_infer.hifigan_fast_forward``) reads the folded kernels from
these modules.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from parallelwavegan_torch.layers.causal_conv import (
    CausalConv1d,
    CausalConvTranspose1d,
)
from parallelwavegan_torch.layers.common import (
    Conv1d,
    Conv2d,
    ConvTranspose1d,
    get_activation,
    normal_init,
    torch_conv_default_init,
    uniform_bias_init_for,
)
from parallelwavegan_torch.layers.residual_block import HiFiGANResidualBlock
from parallelwavegan_torch.ops.conv import avg_pool1d, pad1d


class HiFiGANGenerator(nn.Module):
    """Mel (B, T', in_channels) -> wave (B, T' * prod(scales), out)."""

    def __init__(
        self,
        in_channels: int = 80,
        out_channels: int = 1,
        channels: int = 512,
        kernel_size: int = 7,
        upsample_scales: Sequence[int] = (8, 8, 2, 2),
        upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
        resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
        resblock_dilations: Sequence[Sequence[int]] = (
            (1, 3, 5), (1, 3, 5), (1, 3, 5)),
        use_additional_convs: bool = True,
        bias: bool = True,
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: Optional[Dict[str, Any]] = None,
        use_causal_conv: bool = False,
        use_weight_norm: bool = True,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("kernel_size must be odd")
        if len(upsample_scales) != len(upsample_kernel_sizes):
            raise ValueError("upsample_scales and upsample_kernel_sizes "
                             "differ in length")
        if len(resblock_dilations) != len(resblock_kernel_sizes):
            raise ValueError("resblock_dilations and resblock_kernel_sizes "
                             "differ in length")
        weight_norm = use_weight_norm and not folded
        self.in_channels, self.out_channels = in_channels, out_channels
        self.channels, self.kernel_size = channels, kernel_size
        self.upsample_scales = tuple(upsample_scales)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilations = tuple(tuple(d) for d in resblock_dilations)
        self.use_additional_convs = use_additional_convs
        self.use_causal_conv = use_causal_conv
        self.nonlinear_activation_params = dict(
            {"negative_slope": 0.1}, **(nonlinear_activation_params or {}))
        self.act = get_activation(nonlinear_activation,
                                  self.nonlinear_activation_params)
        kinit = normal_init(0.01)
        conv_kw = dict(bias=bias, kernel_init=kinit,
                       use_weight_norm=weight_norm, generator=generator)
        pad = (kernel_size - 1) // 2

        def conv7(cin: int, cout: int) -> nn.Module:
            # the causal convs take torch's uniform bias, as the JAX module's
            if use_causal_conv:
                return CausalConv1d(cin, cout, kernel_size, **conv_kw)
            return Conv1d(cin, cout, kernel_size, padding=pad,
                          bias_init=uniform_bias_init_for(
                              (kernel_size, cin, cout)), **conv_kw)

        self.input_conv = conv7(in_channels, channels)
        self.upsamples: List[nn.Module] = []
        self.blocks: List[HiFiGANResidualBlock] = []
        num_blocks = len(self.resblock_kernel_sizes)
        for i, (s, k_up) in enumerate(zip(self.upsample_scales,
                                          self.upsample_kernel_sizes)):
            if k_up != 2 * s:
                raise ValueError("upsample kernel sizes must be twice the "
                                 "scales")
            out_ch = channels // (2 ** (i + 1))
            if use_causal_conv:
                up = CausalConvTranspose1d(channels // (2 ** i), out_ch, k_up,
                                           stride=s, **conv_kw)
            else:
                up = ConvTranspose1d(
                    channels // (2 ** i), out_ch, k_up, stride=s,
                    padding=s // 2 + s % 2, output_padding=s % 2, **conv_kw)
            self.add_module(f"upsamples_{i}", up)
            self.upsamples.append(up)
            for j, (k_res, dils) in enumerate(zip(
                    self.resblock_kernel_sizes, self.resblock_dilations)):
                block = HiFiGANResidualBlock(
                    kernel_size=k_res, channels=out_ch, dilations=dils,
                    bias=bias, use_additional_convs=use_additional_convs,
                    nonlinear_activation=nonlinear_activation,
                    nonlinear_activation_params=(
                        self.nonlinear_activation_params),
                    use_causal_conv=use_causal_conv,
                    use_weight_norm=weight_norm, kernel_init=kinit,
                    generator=generator,
                )
                self.add_module(f"blocks_{i * num_blocks + j}", block)
                self.blocks.append(block)
        self.output_conv = conv7(
            channels // (2 ** len(self.upsample_scales)), out_channels)

    @property
    def upsample_factor(self) -> int:
        return math.prod(self.upsample_scales)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        c = self.input_conv(c)
        num_blocks = len(self.resblock_kernel_sizes)
        for i, up in enumerate(self.upsamples):
            c = up(self.act(c))
            cs = 0.0
            for block in self.blocks[i * num_blocks:(i + 1) * num_blocks]:
                cs = cs + block(c)
            c = cs / num_blocks
        # the official implementation uses the default slope (0.01) here
        c = F.leaky_relu(c, 0.01)
        return torch.tanh(self.output_conv(c))


def _discriminator_activation(name: str, params: Optional[Dict[str, Any]]):
    return get_activation(name, dict({"negative_slope": 0.1}, **(params or {})))


class HiFiGANPeriodDiscriminator(nn.Module):
    """Wave (B, T, C) reshaped to a (T / p, p) image; a tower of (k, 1)
    convs strided over the T / p axis. Returns the feature maps, then the
    logits flattened to (B, -1)."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        period: int = 3,
        kernel_sizes: Sequence[int] = (5, 3),
        channels: int = 32,
        downsample_scales: Sequence[int] = (3, 3, 3, 3, 1),
        max_downsample_channels: int = 1024,
        bias: bool = True,
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: Optional[Dict[str, Any]] = None,
        use_weight_norm: bool = True,
        use_spectral_norm: bool = False,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if len(kernel_sizes) != 2 or any(k % 2 != 1 for k in kernel_sizes):
            raise ValueError("kernel_sizes must be two odd numbers")
        if use_weight_norm and use_spectral_norm:
            raise ValueError("Either use use_weight_norm or use_spectral_norm.")
        self.period = period
        self.act = _discriminator_activation(nonlinear_activation,
                                             nonlinear_activation_params)
        conv_kw = dict(bias=bias, use_weight_norm=use_weight_norm and not folded,
                       use_spectral_norm=use_spectral_norm,
                       generator=generator)
        self.convs: List[Conv2d] = []
        in_chs, out_chs = in_channels, channels
        for i, s in enumerate(downsample_scales):
            conv = Conv2d(in_chs, out_chs, (kernel_sizes[0], 1), stride=(s, 1),
                          padding=((kernel_sizes[0] - 1) // 2, 0), **conv_kw)
            self.add_module(f"convs_{i}", conv)
            self.convs.append(conv)
            in_chs = out_chs
            out_chs = min(out_chs * 4, max_downsample_channels)
        self.output_conv = Conv2d(
            in_chs, out_channels, (kernel_sizes[1] - 1, 1),
            padding=((kernel_sizes[1] - 1) // 2, 0), **conv_kw)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        B, T, C = x.shape
        if T % self.period != 0:
            n_pad = self.period - T % self.period
            x = pad1d(x, (0, n_pad), "reflect")
            T += n_pad
        x = x.reshape(B, T // self.period, self.period, C)
        outs = []
        for conv in self.convs:
            x = self.act(conv(x))
            outs.append(x)
        outs.append(self.output_conv(x).reshape(B, -1))
        return outs


class HiFiGANMultiPeriodDiscriminator(nn.Module):
    def __init__(
        self,
        periods: Sequence[int] = (2, 3, 5, 7, 11),
        discriminator_params: Optional[Dict[str, Any]] = None,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.discriminators: List[HiFiGANPeriodDiscriminator] = []
        for i, period in enumerate(periods):
            params = dict(discriminator_params or {}, period=period)
            dis = HiFiGANPeriodDiscriminator(**params, folded=folded,
                                             generator=generator)
            self.add_module(f"discriminators_{i}", dis)
            self.discriminators.append(dis)

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        return [dis(x) for dis in self.discriminators]


class HiFiGANScaleDiscriminator(nn.Module):
    """Conv15 -> grouped strided conv tower -> two output convs; returns
    every activation, then the logits (B, T', out_channels)."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        kernel_sizes: Sequence[int] = (15, 41, 5, 3),
        channels: int = 128,
        max_downsample_channels: int = 1024,
        max_groups: int = 16,
        bias: bool = True,
        downsample_scales: Sequence[int] = (2, 2, 4, 4, 1),
        nonlinear_activation: str = "LeakyReLU",
        nonlinear_activation_params: Optional[Dict[str, Any]] = None,
        use_weight_norm: bool = True,
        use_spectral_norm: bool = False,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if len(kernel_sizes) != 4 or any(k % 2 != 1 for k in kernel_sizes):
            raise ValueError("kernel_sizes must be four odd numbers")
        if use_weight_norm and use_spectral_norm:
            raise ValueError("Either use use_weight_norm or use_spectral_norm.")
        self.act = _discriminator_activation(nonlinear_activation,
                                             nonlinear_activation_params)
        conv_kw = dict(bias=bias, kernel_init=torch_conv_default_init,
                       bias_init=None,
                       use_weight_norm=use_weight_norm and not folded,
                       use_spectral_norm=use_spectral_norm,
                       generator=generator)
        self.layers: List[Conv1d] = []

        def add(conv: Conv1d) -> None:
            self.add_module(f"layer_{len(self.layers)}", conv)
            self.layers.append(conv)

        add(Conv1d(in_channels, channels, kernel_sizes[0],
                   padding=(kernel_sizes[0] - 1) // 2, **conv_kw))
        in_chs = out_chs = channels
        groups = 4
        for s in downsample_scales:
            add(Conv1d(in_chs, out_chs, kernel_sizes[1], stride=s,
                       padding=(kernel_sizes[1] - 1) // 2, groups=groups,
                       **conv_kw))
            in_chs = out_chs
            out_chs = min(in_chs * 2, max_downsample_channels)
            groups = min(groups * 4, max_groups)
        out_chs = min(in_chs * 2, max_downsample_channels)
        add(Conv1d(in_chs, out_chs, kernel_sizes[2],
                   padding=(kernel_sizes[2] - 1) // 2, **conv_kw))
        add(Conv1d(out_chs, out_channels, kernel_sizes[3],
                   padding=(kernel_sizes[3] - 1) // 2, **conv_kw))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for conv in self.layers[:-1]:
            x = self.act(conv(x))
            outs.append(x)
        outs.append(self.layers[-1](x))
        return outs


class HiFiGANMultiScaleDiscriminator(nn.Module):
    def __init__(
        self,
        scales: int = 3,
        downsample_pooling: str = "AvgPool1d",
        downsample_pooling_params: Optional[Dict[str, Any]] = None,
        discriminator_params: Optional[Dict[str, Any]] = None,
        follow_official_norm: bool = False,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if downsample_pooling != "AvgPool1d":
            raise NotImplementedError(
                f"downsample_pooling {downsample_pooling} is not ported")
        self.pool_params = dict(
            {"kernel_size": 4, "stride": 2, "padding": 2},
            **(downsample_pooling_params or {}))
        self.discriminators: List[HiFiGANScaleDiscriminator] = []
        for i in range(scales):
            params = dict(discriminator_params or {})
            if follow_official_norm:
                params["use_weight_norm"] = i != 0
                params["use_spectral_norm"] = i == 0
            dis = HiFiGANScaleDiscriminator(**params, folded=folded,
                                            generator=generator)
            self.add_module(f"discriminators_{i}", dis)
            self.discriminators.append(dis)

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        outs = []
        for dis in self.discriminators:
            outs.append(dis(x))
            x = avg_pool1d(x, count_include_pad=True, **self.pool_params)
        return outs


class HiFiGANMultiScaleMultiPeriodDiscriminator(nn.Module):
    """The scale discriminators' output lists followed by the period
    discriminators' (3 + 5 lists in HiFi-GAN v1)."""

    def __init__(
        self,
        scales: int = 3,
        scale_downsample_pooling: str = "AvgPool1d",
        scale_downsample_pooling_params: Optional[Dict[str, Any]] = None,
        scale_discriminator_params: Optional[Dict[str, Any]] = None,
        follow_official_norm: bool = True,
        periods: Sequence[int] = (2, 3, 5, 7, 11),
        period_discriminator_params: Optional[Dict[str, Any]] = None,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.msd = HiFiGANMultiScaleDiscriminator(
            scales=scales, downsample_pooling=scale_downsample_pooling,
            downsample_pooling_params=scale_downsample_pooling_params,
            discriminator_params=scale_discriminator_params,
            follow_official_norm=follow_official_norm, folded=folded,
            generator=generator)
        self.mpd = HiFiGANMultiPeriodDiscriminator(
            periods=periods, discriminator_params=period_discriminator_params,
            folded=folded, generator=generator)

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        return self.msd(x) + self.mpd(x)
