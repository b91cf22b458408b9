"""Shared pieces of the port's JAX-side tests (tests/test_torch_*.py)."""


def flax_generator_kwargs(**overrides):
    """The small PWG config of tests/test_pallas_kernels.py."""
    kw = dict(
        layers=12, stacks=2, residual_channels=16, gate_channels=32,
        skip_channels=16, aux_channels=20, aux_context_window=2,
        upsample_params={"upsample_scales": [2, 2]},
    )
    kw.update(overrides)
    return kw


PWG_V1_KWARGS = dict(
    layers=30, stacks=3, residual_channels=64, gate_channels=128,
    skip_channels=64, aux_channels=80, aux_context_window=2,
    upsample_params={"upsample_scales": [4, 4, 4, 4]},
)
