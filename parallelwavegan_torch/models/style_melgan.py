"""StyleMelGAN generator and random-window discriminator, channels-last.

Counterpart of ``parallelwavegan_tpu/models/style_melgan.py``. The
generator upsamples noise z (B, nf, in_channels) by transposed convs
(kernel 2 s, stride s, padding s // 2 + s % 2, output padding s % 2, each
followed by the activation), edge-pads the mel to the noise grid when it is
shorter, runs one ``TADEResBlock`` per upsample scale conditioned on it,
then a conv and tanh. One noise frame covers ``noise_upsample_factor`` mel
frames. Submodules carry the flax names (``noise_upsample_<i>``,
``blocks_<i>``, ``output_conv``), so a converted tree loads with
``strict=True``; the noise upsample and output convs take N(0, 0.02)
kernels, as the JAX module's.

The discriminator slices ``repeats`` x ``len(window_sizes)`` random windows
of the signal, one start per (repeat, window) in the order
``r * len(window_sizes) + idx``, shared across the batch and uniform in
[0, T - ws) (``draw_window_starts``); a window with more than one subband
goes through PQMF analysis with its own (taps, cutoff, beta), and each
window size has its MelGAN discriminator (``discriminators_<idx>``,
``in_channels`` = subbands, ``pad_params`` dropped). The JAX modules draw
noise and windows from flax RNG streams; here the caller passes z and
``window_starts``, or a ``torch.Generator`` to draw them from.

``folded=True`` (the default, the serving form) holds every kernel with
weight norm applied; ``folded=False`` holds ``kernel_v``/``kernel_g``
where ``use_weight_norm`` asks for them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from parallelwavegan_torch.layers.common import (
    Conv1d,
    ConvTranspose1d,
    get_activation,
    normal_init,
)
from parallelwavegan_torch.layers.tade import TADEResBlock
from parallelwavegan_torch.models.melgan import MelGANDiscriminator
from parallelwavegan_torch.ops.conv import pad1d
from parallelwavegan_torch.ops.pqmf import pqmf_analysis


class StyleMelGANGenerator(nn.Module):
    """(mel (B, T', aux_channels), z (B, nf, in_channels)) ->
    (B, nf * noise_upsample_factor * upsample_factor, out_channels)."""

    def __init__(
        self,
        in_channels: int = 128,
        aux_channels: int = 80,
        channels: int = 64,
        out_channels: int = 1,
        kernel_size: int = 9,
        dilation: int = 2,
        bias: bool = True,
        noise_upsample_scales: Sequence[int] = (11, 2, 2, 2),
        noise_upsample_activation: str = "LeakyReLU",
        noise_upsample_activation_params: Optional[Dict[str, Any]] = None,
        upsample_scales: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2, 1),
        upsample_mode: str = "nearest",
        gated_function: str = "softmax",
        use_weight_norm: bool = True,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if upsample_mode != "nearest":
            # the JAX module upsamples by nearest neighbour whatever the
            # config says; the port refuses what neither package computes
            raise NotImplementedError(
                f"upsample_mode {upsample_mode} is not ported (nearest only)")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.noise_upsample_scales = tuple(noise_upsample_scales)
        self.upsample_scales = tuple(upsample_scales)
        self.act = get_activation(
            noise_upsample_activation,
            dict(noise_upsample_activation_params or {"negative_slope": 0.2}))
        wn = use_weight_norm and not folded
        kinit = normal_init(0.02)
        self.noise_upsample: List[ConvTranspose1d] = []
        cin = in_channels
        for i, s in enumerate(self.noise_upsample_scales):
            layer = ConvTranspose1d(cin, channels, 2 * s, stride=s,
                                    padding=s // 2 + s % 2,
                                    output_padding=s % 2, bias=bias,
                                    kernel_init=kinit, use_weight_norm=wn,
                                    generator=generator)
            self.add_module(f"noise_upsample_{i}", layer)
            self.noise_upsample.append(layer)
            cin = channels
        self.blocks: List[TADEResBlock] = []
        for i, s in enumerate(self.upsample_scales):
            block = TADEResBlock(
                in_channels=channels,
                aux_channels=aux_channels if i == 0 else channels,
                kernel_size=kernel_size, dilation=dilation, bias=bias,
                upsample_factor=s, gated_function=gated_function,
                use_weight_norm=wn, generator=generator)
            self.add_module(f"blocks_{i}", block)
            self.blocks.append(block)
        self.output_conv = Conv1d(channels, out_channels, kernel_size,
                                  bias=bias, padding=(kernel_size - 1) // 2,
                                  kernel_init=kinit, bias_init=None,
                                  use_weight_norm=wn, generator=generator)

    @property
    def noise_upsample_factor(self) -> int:
        return math.prod(self.noise_upsample_scales)

    @property
    def upsample_factor(self) -> int:
        return math.prod(self.upsample_scales)

    def noise_frames(self, frames: int) -> int:
        """Noise frames that cover ``frames`` mel frames."""
        return (frames - 1) // self.noise_upsample_factor + 1

    def draw_noise(self, batch: int, frames: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """z (batch, noise_frames(frames), in_channels), N(0, 1) in f32 on
        the generator's device (torch's default source when None)."""
        device = generator.device if generator is not None else "cpu"
        return torch.randn((batch, self.noise_frames(frames),
                            self.in_channels), generator=generator,
                           device=device)

    def forward(self, c: torch.Tensor, z: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """c (B, T', aux) mel; z (B, nf, in_channels), drawn from
        ``generator`` when None."""
        if z is None:
            z = self.draw_noise(c.shape[0], c.shape[1], generator)
        x = z.to(device=c.device, dtype=c.dtype)
        for layer in self.noise_upsample:
            x = self.act(layer(x))
        if c.shape[1] < x.shape[1]:
            # edge-pad the conditioning to the noise grid; callers crop the
            # output to T' * upsample_factor
            c = pad1d(c, (0, x.shape[1] - c.shape[1]), "replicate")
        for block in self.blocks:
            x, c = block(x, c)
        return torch.tanh(self.output_conv(x))

    def inference(self, c: torch.Tensor, z: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """Mel (T', C) -> wave (T' * upsample_factor, out_channels): the mel
        edge-padded to the noise grid, the output cropped to its length."""
        T = c.shape[0]
        noise_t = self.noise_frames(T) * self.noise_upsample_factor
        c = pad1d(c[None], (0, noise_t - T), "replicate")
        return self(c, z, generator)[0, :T * self.upsample_factor]


class StyleMelGANDiscriminator(nn.Module):
    """(B, T, 1) -> the list of repeats x len(window_sizes) feature-map
    lists of the MelGAN discriminators, one per random window."""

    def __init__(
        self,
        repeats: int = 2,
        window_sizes: Sequence[int] = (512, 1024, 2048, 4096),
        pqmf_params: Sequence[Sequence[Any]] = (
            (1, None, None, None),
            (2, 62, 0.26700, 9.0),
            (4, 62, 0.14200, 9.0),
            (8, 62, 0.07949, 9.0),
        ),
        discriminator_params: Optional[Dict[str, Any]] = None,
        use_weight_norm: bool = True,
        *,
        folded: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if len(window_sizes) != len(pqmf_params):
            raise ValueError("one pqmf_params entry per window size")
        sizes = {ws // pq[0] for ws, pq in zip(window_sizes, pqmf_params)}
        if len(sizes) != 1:
            raise ValueError("every window must give the same subband length")
        self.repeats = repeats
        self.window_sizes = tuple(window_sizes)
        self.pqmf_params = [tuple(pq) for pq in pqmf_params]
        d_params = {
            "out_channels": 1, "kernel_sizes": (5, 3), "channels": 16,
            "max_downsample_channels": 512, "bias": True,
            "downsample_scales": (4, 4, 4, 1),
            "nonlinear_activation": "LeakyReLU",
            "nonlinear_activation_params": {"negative_slope": 0.2},
            "pad": "ReflectionPad1d",
        }
        d_params.update(discriminator_params or {})
        d_params.pop("pad_params", None)
        self.discriminators: List[MelGANDiscriminator] = []
        for idx, pq in enumerate(self.pqmf_params):
            dis = MelGANDiscriminator(in_channels=pq[0],
                                      use_weight_norm=use_weight_norm,
                                      folded=folded, generator=generator,
                                      **d_params)
            self.add_module(f"discriminators_{idx}", dis)
            self.discriminators.append(dis)

    def draw_window_starts(self, length: int,
                           generator: Optional[torch.Generator] = None
                           ) -> List[int]:
        """One start per (repeat, window) for a signal of ``length``
        samples, uniform in [0, length - ws) (0 where length == ws, as
        ``jax.random.randint`` gives), from ``generator`` (torch's default
        source when None)."""
        starts = []
        for _ in range(self.repeats):
            for ws in self.window_sizes:
                if length < ws:
                    raise ValueError(f"signal of {length} samples is shorter "
                                     f"than the {ws}-sample window")
                high = length - ws
                starts.append(0 if high == 0 else int(torch.randint(
                    0, high, (), generator=generator)))
        return starts

    def forward(self, x: torch.Tensor,
                window_starts: Optional[Sequence[int]] = None,
                generator: Optional[torch.Generator] = None
                ) -> List[List[torch.Tensor]]:
        if window_starts is None:
            window_starts = self.draw_window_starts(x.shape[1], generator)
        n = len(self.window_sizes)
        if len(window_starts) != self.repeats * n:
            raise ValueError(f"expected {self.repeats * n} window starts")
        outs = []
        for r in range(self.repeats):
            for idx, (ws, pq) in enumerate(zip(self.window_sizes,
                                               self.pqmf_params)):
                start = int(window_starts[r * n + idx])
                x_ = x[:, start:start + ws]
                if pq[0] > 1:
                    x_ = pqmf_analysis(x_, pq[0], pq[1], pq[2], pq[3])
                outs.append(self.discriminators[idx](x_))
        return outs
