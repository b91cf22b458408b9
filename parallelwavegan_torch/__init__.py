"""PyTorch/CUDA port of parallelwavegan_tpu: channels-last (B, T, C)
modules with the JAX package's layout and names, and hand-written Hopper
kernels in csrc/ for its Pallas TPU kernels."""
