"""The port's WaveNet stack (plain version on the CPU) against the JAX
package's Pallas kernel (interpret mode) and its XLA reference. The CUDA
kernel against the plain version is in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelwavegan_tpu.ops.pallas.wavenet_stack import (
    wavenet_stack as jax_wavenet_stack,
    wavenet_stack_reference as jax_wavenet_stack_reference,
)
from parallelwavegan_torch.ops.cuda.wavenet_stack import (
    wavenet_stack,
    wavenet_stack_reference,
)

torch.set_num_threads(2)


def _stack_inputs(rng, B, T, L, R=64, G=128, A=80, S=64):
    w = {
        "w_tap": rng.standard_normal((L, 3, R, G)) * 0.1,
        "b_tap": rng.standard_normal((L, G)) * 0.1,
        "w_aux": rng.standard_normal((L, A, G)) * 0.1,
        "w_so": rng.standard_normal((L, R, S + R)) * 0.1,
        "b_so": rng.standard_normal((L, S + R)) * 0.1,
    }
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((B, T, R)).astype(np.float32)
    c = rng.standard_normal((B, T, A)).astype(np.float32)
    return x, c, w


def _torch(w):
    return {k: torch.from_numpy(v) for k, v in w.items()}


@pytest.mark.parametrize("T", [1000, 1024])
def test_stack_plain_matches_jax_kernel_and_reference(T):
    rng = np.random.default_rng(0)
    dils = (1, 2, 4, 1, 2, 4)
    x, c, w = _stack_inputs(rng, 2, T, len(dils))
    xo, sk = wavenet_stack(torch.from_numpy(x), torch.from_numpy(c), _torch(w),
                           dils)
    assert xo.dtype == torch.float32 and sk.dtype == torch.float32
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    # same tolerances as the JAX kernel's own test (f32, 6 layers)
    xo_k, sk_k = jax_wavenet_stack(jnp.asarray(x), jnp.asarray(c), jw, dils,
                                   chunk=256, interpret=True)
    np.testing.assert_allclose(xo.numpy(), np.asarray(xo_k), atol=2e-5)
    np.testing.assert_allclose(sk.numpy(), np.asarray(sk_k), atol=2e-4)
    xo_r, sk_r = jax_wavenet_stack_reference(jnp.asarray(x), jnp.asarray(c),
                                             jw, dils)
    np.testing.assert_allclose(xo.numpy(), np.asarray(xo_r), atol=2e-5)
    np.testing.assert_allclose(sk.numpy(), np.asarray(sk_r), atol=2e-4)


def test_stack_plain_dilation_beyond_sequence():
    """A dilation >= T reads only zero padding on both taps (the JAX
    reference's shifts do not cover d > T; its kernel's halo does)."""
    rng = np.random.default_rng(1)
    dils = (1, 64, 512)
    x, c, w = _stack_inputs(rng, 1, 40, len(dils))
    xo, sk = wavenet_stack_reference(torch.from_numpy(x), torch.from_numpy(c),
                                     _torch(w), dils)
    xo_r, sk_r = jax_wavenet_stack(
        jnp.asarray(x), jnp.asarray(c), {k: jnp.asarray(v) for k, v in w.items()},
        dils, chunk=128, interpret=True,
    )
    np.testing.assert_allclose(xo.numpy(), np.asarray(xo_r), atol=2e-5)
    np.testing.assert_allclose(sk.numpy(), np.asarray(sk_r), atol=2e-4)


def test_stack_plain_bf16_keeps_f32_residual_like_the_jax_kernel():
    """In bf16 the plain version follows the kernels (f32 residual within a
    call), which the JAX Pallas kernel shares; bf16 rounding points can
    differ by one ulp where the f32 sums differ in order, hence 3e-2."""
    rng = np.random.default_rng(2)
    dils = (1, 2, 4, 8)
    x, c, w = _stack_inputs(rng, 1, 300, len(dils))
    tb = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in w.items()}
    xo, sk = wavenet_stack(torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(c).to(torch.bfloat16), tb, dils)
    assert xo.dtype == torch.bfloat16 and sk.dtype == torch.float32
    jw = {k: jnp.asarray(v, jnp.bfloat16) for k, v in w.items()}
    xo_k, sk_k = jax_wavenet_stack(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16), jw, dils,
        chunk=128, interpret=True,
    )
    np.testing.assert_allclose(xo.float().numpy(),
                               np.asarray(xo_k, np.float32), atol=3e-2)
    np.testing.assert_allclose(sk.numpy(), np.asarray(sk_k), atol=3e-2)


def test_stack_wrapper_rejects_other_devices():
    x = torch.zeros((1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        wavenet_stack(x, x, {}, (1,))

