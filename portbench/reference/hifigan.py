"""HiFi-GAN generator, plain PyTorch, channels-first, as published.

Kong, Kim and Bae, "HiFi-GAN" (NeurIPS 2020), V1, and the
``HiFiGANGenerator`` of the ParallelWaveGAN implementation: a kernel-7 conv
in, per scale LeakyReLU(0.1), a transposed conv of kernel 2s and the mean
of the multi-receptive-field residual blocks (per dilation: LeakyReLU,
dilated conv, LeakyReLU, conv, plus the identity), then LeakyReLU(0.01), a
kernel-7 conv out and tanh. Parameters as in ``parallel_wavegan.py``: the
checkpoint layout, weight norm applied here where v and g are stored, in
the precision of the tensors given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.parallel_wavegan import (  # noqa: F401
    Params,
    conv,
    kernel,
)


NOISE = False


def context_frames(gp: dict) -> int:
    return 0


def generator(p: Params, gp: dict, c: torch.Tensor, z=None) -> torch.Tensor:
    """c (B, T', in_channels) -> (B, T' * prod(scales), out_channels);
    HiFi-GAN takes no noise (``z`` is ignored)."""
    slope = gp.get("nonlinear_activation_params", {}).get("negative_slope",
                                                          0.1)
    pad = (gp["kernel_size"] - 1) // 2
    x = conv(c.transpose(1, 2), p, "input_conv", padding=pad)
    kernels, dilations = gp["resblock_kernel_sizes"], gp["resblock_dilations"]
    n = len(kernels)
    for i, s in enumerate(gp["upsample_scales"]):
        w = kernel(p, f"upsamples_{i}").permute(1, 2, 0)
        x = F.conv_transpose1d(F.leaky_relu(x, slope), w,
                               p[f"upsamples_{i}.bias"], stride=s,
                               padding=s // 2 + s % 2,
                               output_padding=s % 2)
        total = 0.0
        for j, (k, dils) in enumerate(zip(kernels, dilations)):
            name = f"blocks_{i * n + j}"
            h = x
            for m, d in enumerate(dils):
                t = conv(F.leaky_relu(h, slope), p, f"{name}.convs1_{m}",
                         dilation=d, padding=(k - 1) // 2 * d)
                t = conv(F.leaky_relu(t, slope), p, f"{name}.convs2_{m}",
                         padding=(k - 1) // 2)
                h = t + h
            total = total + h
        x = total / n
    x = F.leaky_relu(x, 0.01)
    return torch.tanh(conv(x, p, "output_conv", padding=pad)).transpose(1, 2)
