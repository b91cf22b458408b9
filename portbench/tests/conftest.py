"""The repository's card marker, registered here too: the harness's tests
are collected apart from ``tests/``, whose conftest loads JAX."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skipped "
        "without one",
    )
