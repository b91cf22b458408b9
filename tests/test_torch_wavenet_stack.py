"""The port's WaveNet stack (plain version on the CPU) against the JAX
package's Pallas kernel (interpret mode) and its XLA reference, and the
wrapper's launch plan. The CUDA kernel against the plain version is in
test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelwavegan_tpu.ops.pallas.wavenet_stack import (
    wavenet_stack as jax_wavenet_stack,
    wavenet_stack_reference as jax_wavenet_stack_reference,
)
from parallelwavegan_torch.ops.cuda.wavenet_stack import (
    stack_launch_plan,
    tc_smem_bytes,
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



# the shapes the port's main paths give the stack: PWG v1 serving (one call
# of 30 layers at batch 32 x 512 frames x 256) and training (three calls of
# 10 layers at batch 6 x 25,600), and the B4 tool's baseline (10 layers)
_MAIN_PATH_CALLS = {
    "serving": (32, 131072, 80, 30),
    "training": (6, 25600, 80, 10),
    "tool_baseline": (32, 131072, 80, 10),
    "one_layer": (1, 77, 80, 1),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("call", sorted(_MAIN_PATH_CALLS))
def test_stack_launch_plan_fits_the_card(call, dtype):
    """One launch per layer (the exact count the wrapper adds to
    wavenet_stack.launches), 64-row tiles, and for bf16 persistent blocks
    whose weights and ring fit a block's shared memory."""
    B, T, A, L = _MAIN_PATH_CALLS[call]
    plan = stack_launch_plan(B, T, A, L, dtype, sms=132)
    assert plan["launches"] == L
    assert plan["tiles"] == B * -(-T // 64)
    if dtype == torch.float32:
        assert plan["body"] == "simt" and plan["blocks"] == plan["tiles"]
        return
    assert plan["body"] == "tensor_cores"
    assert plan["smem"] <= 232448
    assert 1 <= plan["blocks"] <= min(plan["tiles"], 132 * 2)
    # the largest launch is a later layer's, which stages the f32 residual
    want = tc_smem_bytes(A, torch.float32 if L > 1 else torch.bfloat16)
    assert plan["smem"] == want


def test_stack_tensor_core_smem_counts_weights_biases_and_ring():
    """86,016 B of resident weights (3R + 80 + R rows of 128 bf16), 1 KB of
    f32 biases, 8 KB of gate (64 rows of 64 bf16), two ring slots of three
    x windows and one c window."""
    weights, biases = (192 + 80 + 64) * 256 + 64 * 128, 256 * 4
    slot_f32 = 3 * 64 * 288 + 64 * 176
    slot_bf16 = 3 * 64 * 144 + 64 * 176
    assert tc_smem_bytes(80, torch.float32) == weights + biases + 2 * slot_f32
    assert tc_smem_bytes(80, torch.bfloat16) == weights + biases + 2 * slot_bf16
    # aux channels pad to the mma depth of 16
    assert tc_smem_bytes(84, torch.float32) == tc_smem_bytes(96, torch.float32)


def test_stack_launch_plan_rejects_what_does_not_fit():
    with pytest.raises(NotImplementedError, match="shared memory"):
        stack_launch_plan(1, 1000, 256, 2, torch.bfloat16)
    # f32 stages its weights in chunks: no such limit in the plan
    assert stack_launch_plan(1, 1000, 256, 2, torch.float32)["launches"] == 2
    # a small problem gets no more blocks than tiles
    assert stack_launch_plan(1, 100, 80, 3, torch.bfloat16)["blocks"] == 2


def test_ablation_tool_variants_still_apply_to_the_kernel_source():
    """Every text the ablation tool replaces is in csrc/wavenet_stack.cu
    exactly once, so each variant takes out what its name says."""
    from parallelwavegan_torch.ops.cuda.build import CSRC_DIR
    from parallelwavegan_torch.tools.wavenet_stack_ablation import VARIANTS

    source = (CSRC_DIR / "wavenet_stack.cu").read_text()
    assert VARIANTS["base"] == []
    for name, edits in VARIANTS.items():
        for old, new in edits:
            assert source.count(old) == 1, (name, old)
            assert old != new
