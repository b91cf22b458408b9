"""Fused Parallel WaveGAN forward: upsample (PyTorch) + WaveNet stack
(CUDA kernels).

Counterpart of ``parallelwavegan_tpu/ops/pallas/pwg_infer.py``. The
30-layer hot loop runs through ``wavenet_stack``: one call for serving, and
with ``trainable=True`` one ``wavenet_stack_train`` call (forward kernel
with saved inputs, backward kernel) per group of layers, grouped as the JAX
training path groups them. The upsample network, first 1x1 and output tail
stay plain PyTorch, as they stayed XLA in the JAX package. The 1x1s
multiply in f32 and round once, like the JAX path's
``preferred_element_type=float32`` dots. Weight norm is folded and the
stack's weights are fused inside the graph, so gradients reach
``kernel_v`` and ``kernel_g``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from parallelwavegan_torch.layers.common import Conv1d
from parallelwavegan_torch.ops.cuda.wavenet_stack import (
    fuse_wavenet_stack_params,
    wavenet_stack,
)
from parallelwavegan_torch.ops.cuda.wavenet_stack_train import (
    wavenet_stack_train,
)


def unsupported_fused_settings(gen) -> List[str]:
    """The settings of ``gen`` the fused path does not cover (empty if none).
    Channel widths are checked by the CUDA kernel's wrapper."""
    bad = []
    if gen.kernel_size != 3:
        bad.append(f"kernel_size={gen.kernel_size}")
    if gen.use_causal_conv:
        bad.append("use_causal_conv=True")
    if gen.dropout != 0.0:
        bad.append(f"dropout={gen.dropout}")
    if gen.aux_channels <= 0:
        bad.append(f"aux_channels={gen.aux_channels}")
    if gen.layers % gen.stacks:
        bad.append(f"layers={gen.layers} with stacks={gen.stacks}")
    return bad


def supports_fused_inference(gen) -> bool:
    """Kernel size 3, non-causal, no dropout, conditioned."""
    return not unsupported_fused_settings(gen)


def _conv1x1(conv: Conv1d, x: torch.Tensor) -> torch.Tensor:
    y = x.float() @ conv.folded_kernel()[0].float()
    if conv.bias is not None:
        y = y + conv.bias.float()
    return y.to(x.dtype)


def pwg_fused_forward(gen, z: torch.Tensor, c: torch.Tensor,
                      w: Optional[Dict[str, torch.Tensor]] = None,
                      trainable: bool = False) -> torch.Tensor:
    """Batched fused forward of a ParallelWaveGANGenerator:
    z (B, T, 1), c (B, T'+2*ctx, A) -> (B, T, out). ``w`` is
    ``fuse_wavenet_stack_params(gen.conv_layers)``, fused here if not given
    (callers that run many forwards fuse once).

    ``trainable=True`` is the training path: the stack runs in groups of
    ``min(layers // stacks, 10)`` layers through ``wavenet_stack_train``, so
    the whole function is differentiable in the generator's parameters.
    The grouping is the JAX training path's: the residual is rounded to
    ``x.dtype`` at each group's end, which matters in bfloat16. Under
    ``torch.no_grad`` the groups stay and nothing is saved for a backward.
    """
    bad = unsupported_fused_settings(gen)
    if bad:
        raise NotImplementedError(
            "the fused path does not support " + ", ".join(bad)
        )
    if gen.upsample_net is not None:
        c = gen.upsample_net(c)
    if c.shape[1] != z.shape[1]:
        raise ValueError(f"upsampled c {tuple(c.shape)} vs z "
                         f"{tuple(z.shape)}")
    x = _conv1x1(gen.first_conv, z)
    if w is None:
        w = fuse_wavenet_stack_params(gen.conv_layers)
    w = {k: v.to(x.dtype) for k, v in w.items()}
    x, c = x.contiguous(), c.to(x.dtype).contiguous()
    if trainable:
        dils = gen.dilations
        group = min(gen.layers // gen.stacks, 10)
        skip = None
        for g0 in range(0, gen.layers, group):
            wg = {k: v[g0:g0 + group] for k, v in w.items()}
            x, sk = wavenet_stack_train(x, c, wg, dils[g0:g0 + group])
            skip = sk if skip is None else skip + sk
    else:
        _, skip = wavenet_stack(x, c, w, gen.dilations)
    x = gen.act((skip * math.sqrt(1.0 / gen.layers)).to(x.dtype))
    x = gen.act(_conv1x1(gen.last_conv_0, x))
    return _conv1x1(gen.last_conv_1, x)
