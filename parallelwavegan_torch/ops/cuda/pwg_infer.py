"""Fused Parallel WaveGAN inference: upsample (PyTorch) + WaveNet stack
(CUDA kernel).

Counterpart of ``parallelwavegan_tpu/ops/pallas/pwg_infer.py`` (inference
only). The 30-layer hot loop runs as one ``wavenet_stack`` call; the
upsample network, first 1x1 and output tail stay plain PyTorch, as they
stayed XLA in the JAX package. The 1x1s multiply in f32 and round once,
like the JAX path's ``preferred_element_type=float32`` dots.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from parallelwavegan_torch.layers.common import Conv1d
from parallelwavegan_torch.ops.cuda.wavenet_stack import (
    fuse_wavenet_stack_params,
    wavenet_stack,
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
    y = x.float() @ conv.kernel[0].float()
    if conv.bias is not None:
        y = y + conv.bias.float()
    return y.to(x.dtype)


def pwg_fused_forward(gen, z: torch.Tensor, c: torch.Tensor,
                      w: Optional[Dict[str, torch.Tensor]] = None
                      ) -> torch.Tensor:
    """Batched fused forward of a ParallelWaveGANGenerator:
    z (B, T, 1), c (B, T'+2*ctx, A) -> (B, T, out). ``w`` is
    ``fuse_wavenet_stack_params(gen.conv_layers)``, fused here if not given
    (callers that run many forwards fuse once)."""
    bad = unsupported_fused_settings(gen)
    if bad:
        raise NotImplementedError(
            "the fused path does not support " + ", ".join(bad)
        )
    c = gen.upsample_net(c)
    if c.shape[1] != z.shape[1]:
        raise ValueError(f"upsampled c {tuple(c.shape)} vs z "
                         f"{tuple(z.shape)}")
    x = _conv1x1(gen.first_conv, z)
    if w is None:
        w = fuse_wavenet_stack_params(gen.conv_layers)
    _, skip = wavenet_stack(x.contiguous(), c.to(x.dtype).contiguous(), w,
                            gen.dilations)
    x = F.relu((skip * math.sqrt(1.0 / gen.layers)).to(x.dtype))
    x = F.relu(_conv1x1(gen.last_conv_0, x))
    return _conv1x1(gen.last_conv_1, x)
