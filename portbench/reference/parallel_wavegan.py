"""Parallel WaveGAN v1, plain PyTorch, channels-first, as published.

Yamamoto, Song and Kim, "Parallel WaveGAN" (ICASSP 2020), and the
``ParallelWaveGANGenerator`` / ``ParallelWaveGANDiscriminator`` of the
authors' public implementation: a mel upsampled by a context conv and
nearest stretches with (1, 2s + 1) smoothing convs, a non-causal WaveNet of
gated residual blocks on noise, the skip sum times sqrt(1 / layers), ReLU,
1x1, ReLU, 1x1; the discriminator is a stack of dilated convs with
LeakyReLU between.

Parameters come as a flat dict {name: tensor} in the checkpoint layout the
benchmark writes and reads: a conv kernel is (K, Cin, Cout); a smoothing
conv's is (1, 2s + 1, 1, 1); with weight norm a conv holds ``kernel_v`` and
``kernel_g``, where g has size 1 along the axes the norm runs over.
Nothing here imports the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# the generator takes noise z beside the mel
NOISE = True


def context_frames(gp: dict) -> int:
    """Mel frames the serving API pads on each side of an utterance."""
    return gp["aux_context_window"]


def kernel(p: Params, name: str) -> torch.Tensor:
    """The conv kernel ``name`` in the checkpoint layout, weight norm
    applied where the parameters hold v and g."""
    if f"{name}.kernel" in p:
        return p[f"{name}.kernel"]
    v, g = p[f"{name}.kernel_v"], p[f"{name}.kernel_g"]
    axes = tuple(d for d in range(v.dim()) if g.shape[d] == 1)
    norm = torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))
    return v * (g / torch.clamp(norm, min=1e-12))


def conv(x: torch.Tensor, p: Params, name: str, dilation: int = 1,
         padding: int = 0) -> torch.Tensor:
    """x (B, Cin, T) through the conv ``name``: (B, Cout, T')."""
    w = kernel(p, name).permute(2, 1, 0)
    return F.conv1d(x, w, p.get(f"{name}.bias"), padding=padding,
                    dilation=dilation)


def generator_shapes(gp: dict, weight_norm: bool) -> Dict[str, Tuple]:
    """Every parameter of the generator, name -> shape: the serving form
    (``weight_norm`` False: folded kernels) or the training form."""
    R, G, S = gp["residual_channels"], gp["gate_channels"], gp["skip_channels"]
    A, K, ctx = gp["aux_channels"], gp["kernel_size"], gp["aux_context_window"]
    out: Dict[str, Tuple] = {}

    def add(name: str, shape: Tuple, bias: bool, g_axes=None) -> None:
        if weight_norm:
            out[f"{name}.kernel_v"] = shape
            out[f"{name}.kernel_g"] = tuple(
                1 if d != len(shape) - 1 else n for d, n in enumerate(shape)
            ) if g_axes is None else g_axes
        else:
            out[f"{name}.kernel"] = shape
        if bias:
            out[f"{name}.bias"] = (shape[-1],)

    add("upsample_net.conv_in", (2 * ctx + 1, A, A), False)
    for i, s in enumerate(gp["upsample_params"]["upsample_scales"]):
        add(f"upsample_net.upsample.conv_{i}", (1, 2 * s + 1, 1, 1), False,
            (1, 1, 1, 1))
    add("first_conv", (1, gp["in_channels"], R), True)
    for i in range(gp["layers"]):
        add(f"conv_layers_{i}.conv", (K, R, G), True)
        add(f"conv_layers_{i}.conv1x1_aux", (1, A, G), False)
        add(f"conv_layers_{i}.conv1x1_skip", (1, G // 2, S), True)
        add(f"conv_layers_{i}.conv1x1_out", (1, G // 2, R), True)
    add("last_conv_0", (1, S, S), True)
    add("last_conv_1", (1, S, gp["out_channels"]), True)
    return out


def discriminator_shapes(dp: dict, weight_norm: bool) -> Dict[str, Tuple]:
    out: Dict[str, Tuple] = {}
    K, C = dp["kernel_size"], dp["conv_channels"]
    cin = dp["in_channels"]
    names = [(f"conv_{i}", (K, cin if i == 0 else C, C))
             for i in range(dp["layers"] - 1)]
    names.append(("last_conv", (K, C, dp["out_channels"])))
    for name, shape in names:
        if weight_norm:
            out[f"{name}.kernel_v"] = shape
            out[f"{name}.kernel_g"] = (1, 1, shape[-1])
        else:
            out[f"{name}.kernel"] = shape
        out[f"{name}.bias"] = (shape[-1],)
    return out


def upsample(p: Params, c: torch.Tensor, scales: Sequence[int]
             ) -> torch.Tensor:
    """c (B, A, T' + 2 ctx) -> (B, A, T' * prod(scales)): the context conv
    (no padding), then per scale a nearest stretch of the time axis and the
    (1, 2s + 1) smoothing conv over the (A, T) image, zero-padded."""
    c = conv(c, p, "upsample_net.conv_in")
    for i, s in enumerate(scales):
        w = kernel(p, f"upsample_net.upsample.conv_{i}").permute(3, 2, 0, 1)
        img = F.interpolate(c[:, None], scale_factor=(1, s), mode="nearest")
        c = F.conv2d(img, w, padding=(0, s))[:, 0]
    return c


def generator(p: Params, gp: dict, c: torch.Tensor, z: torch.Tensor
              ) -> torch.Tensor:
    """c (B, T' + 2 ctx, A) mel with its context frames, z (B, T, 1) noise
    -> (B, T, out_channels)."""
    c = upsample(p, c.transpose(1, 2),
                 gp["upsample_params"]["upsample_scales"])
    x = conv(z.transpose(1, 2), p, "first_conv")
    layers, lpc = gp["layers"], gp["layers"] // gp["stacks"]
    half = gp["gate_channels"] // 2
    skips = 0.0
    for i in range(layers):
        d = 2 ** (i % lpc)
        name = f"conv_layers_{i}"
        h = conv(x, p, f"{name}.conv", dilation=d,
                 padding=(gp["kernel_size"] - 1) // 2 * d)
        h = h + conv(c, p, f"{name}.conv1x1_aux")
        g = torch.tanh(h[:, :half]) * torch.sigmoid(h[:, half:])
        skips = skips + conv(g, p, f"{name}.conv1x1_skip")
        x = (conv(g, p, f"{name}.conv1x1_out") + x) * math.sqrt(0.5)
    x = F.relu(skips * math.sqrt(1.0 / layers))
    x = F.relu(conv(x, p, "last_conv_0"))
    return conv(x, p, "last_conv_1").transpose(1, 2)


def discriminator(p: Params, dp: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, 1) -> logits (B, T, out_channels): dilations 1, 1, 2, ...,
    layers - 2, LeakyReLU between."""
    slope = dp.get("nonlinear_activation_params", {}).get("negative_slope",
                                                          0.2)
    K = dp["kernel_size"]
    x = x.transpose(1, 2)
    for i in range(dp["layers"] - 1):
        d = 1 if i == 0 else i
        x = F.leaky_relu(conv(x, p, f"conv_{i}", dilation=d,
                              padding=(K - 1) // 2 * d), slope)
    return conv(x, p, "last_conv", padding=(K - 1) // 2).transpose(1, 2)
