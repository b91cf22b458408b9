"""PyTorch/CUDA port of parallelwavegan_tpu: channels-last (B, T, C)
modules with the JAX package's layout and names, and hand-written Hopper
kernels in csrc/ for its Pallas TPU kernels."""

import torch

# A workaround below the port (ROADMAP.md C-7, first_sqrt_probe.py): on a
# CPU with AVX-512 and AMX, the first float32 elementwise op (sqrt, tanh,
# x ** 0.5) that a process ran across its threads after an earlier parallel
# op returned values off by up to 3e-4 of themselves on the calling
# thread's share, in 2 to 6 % of fresh processes under load, in torch
# scripts that import nothing of the port too; one serial elementwise op
# first, here or later, prevents it.
torch.sqrt(torch.ones(1))
