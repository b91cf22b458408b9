"""Test config: run JAX on CPU with 8 virtual devices so multi-chip sharding
paths (mesh/pjit/shard_map) are exercised without TPU hardware.

Note: the TPU platform plugin in this image ignores the JAX_PLATFORMS env var,
so the backend is forced via jax.config before any backend initialization.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skipped "
        "without one",
    )
