"""The port's WaveNet stack (plain version on the CPU) against the JAX
package's Pallas kernel (interpret mode) and its XLA reference; the
wrapper's launch plan; the split-TF32 products of the f32 body, emulated
through a 30-layer stack; the bounds chip_smoke.py reports. The CUDA kernel
against the plain version is in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from parallelwavegan_tpu.ops.pallas.wavenet_stack import (
    wavenet_stack as jax_wavenet_stack,
    wavenet_stack_reference as jax_wavenet_stack_reference,
)
from parallelwavegan_torch.ops.cuda.wavenet_stack import (
    stack_launch_plan,
    tc_smem_bytes,
    tf32_smem_bytes,
    wavenet_stack,
    wavenet_stack_reference,
)
from tests.torch_helpers import tf32_round, tf32x3_matmul

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
    wavenet_stack.launches) over 64-row tiles. f32 runs the split-TF32 body,
    one block per tile; bf16 runs persistent blocks whose weights and ring
    fit a block's shared memory."""
    B, T, A, L = _MAIN_PATH_CALLS[call]
    plan = stack_launch_plan(B, T, A, L, dtype, sms=132)
    assert plan["launches"] == L
    assert plan["tile_rows"] == 64
    assert plan["tiles"] == B * -(-T // 64)
    assert plan["smem"] <= 232448
    if dtype == torch.float32:
        assert plan["body"] == "tensor_cores_tf32x3"
        assert plan["blocks"] == plan["tiles"]
        assert plan["smem"] == tf32_smem_bytes()
        # two blocks of 8 warps share an SM
        assert 2 * (plan["smem"] + 1024) <= 233472
        return
    assert plan["body"] == "tensor_cores"
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


def test_stack_tf32_smem_counts_ring_centre_rows_and_gate():
    """Three ring slots, each 32 weight rows of 128 f32 (padded to 136) and
    64 rows of 32 activation columns (padded to 36), then the centre rows
    and the gate, 64 rows of 64 f32 each (padded to 68): 114,688 B at any
    A."""
    slot = 32 * 136 * 4 + 64 * 36 * 4
    assert tf32_smem_bytes() == 3 * slot + 2 * 64 * 68 * 4 == 114688
    for A in (16, 80, 256):
        assert stack_launch_plan(2, 1000, A, 3, torch.float32)["smem"] == \
            114688


def test_stack_launch_plan_rejects_what_does_not_fit():
    with pytest.raises(NotImplementedError, match="shared memory"):
        stack_launch_plan(1, 1000, 256, 2, torch.bfloat16)
    # f32 streams weights and c in chunks: no such limit in the plan
    assert stack_launch_plan(1, 1000, 256, 2, torch.float32)["launches"] == 2
    # a small problem gets no more blocks than tiles
    assert stack_launch_plan(1, 100, 80, 3, torch.bfloat16)["blocks"] == 2


def _shift_np(x, d):
    """s[t] = x[t - d] along axis 1, zero-filled."""
    out = np.zeros_like(x)
    T = x.shape[1]
    if d > 0 and d < T:
        out[:, d:] = x[:, :T - d]
    elif d < 0 and -d < T:
        out[:, :T + d] = x[:, -d:]
    return out


def _stack_np(x, c, w, dils, matmul, dtype):
    """The stack forward in ``dtype`` with every product taken by
    ``matmul`` (whose float64 sums are rounded to ``dtype``, as the f32
    accumulators hold them)."""
    R = x.shape[-1]
    S = w["w_so"].shape[-1] - R
    h, c, skip = x.astype(dtype), c.astype(dtype), 0
    for i, d in enumerate(dils):
        xcat = np.concatenate([_shift_np(h, d), h, _shift_np(h, -d), c], -1)
        wcat = np.concatenate([w["w_tap"][i].reshape(3 * R, -1),
                               w["w_aux"][i]])
        B, T, K = xcat.shape
        z = (matmul(xcat.reshape(-1, K), wcat).reshape(B, T, -1)
             + w["b_tap"][i]).astype(dtype)
        g = (np.tanh(z[..., :R]) / (1 + np.exp(-z[..., R:]))).astype(dtype)
        so = (matmul(g.reshape(-1, R), w["w_so"][i]).reshape(B, T, -1)
              + w["b_so"][i]).astype(dtype)
        skip = skip + so[..., :S]
        h = ((so[..., S:] + h) * dtype(np.sqrt(0.5))).astype(dtype)
    return h, skip


@pytest.mark.parametrize("products", ["tf32x3", "tf32"])
def test_split_tf32_keeps_a_30_layer_stack_at_f32_accuracy(products):
    """Why the f32 body multiplies in three TF32 terms: through PWG v1's 30
    layers at full width (weights 1 / sqrt(fan-in)), the split products of
    tf32x3_matmul keep x and skip within 1e-6 (1 + max) of float64, while
    one TF32 product per product (both operands rounded to TF32) leaves the
    card tests' f32 tolerance of 1e-4 (1 + max)."""
    rng = np.random.default_rng(0)
    L, R, G, S, A, T = 30, 64, 128, 64, 80, 400
    w = {"w_tap": rng.standard_normal((L, 3, R, G)) / np.sqrt(3 * R),
         "b_tap": rng.standard_normal((L, G)) * 0.1,
         "w_aux": rng.standard_normal((L, A, G)) / np.sqrt(A),
         "w_so": rng.standard_normal((L, R, S + R)) / np.sqrt(R),
         "b_so": rng.standard_normal((L, S + R)) * 0.1}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((1, T, R)).astype(np.float32)
    c = rng.standard_normal((1, T, A)).astype(np.float32)
    dils = [2 ** (i % 10) for i in range(L)]
    exact = _stack_np(x, c, w, dils, lambda a, b: a.astype(np.float64)
                      @ b.astype(np.float64), np.float64)
    matmul = tf32x3_matmul if products == "tf32x3" else (
        lambda a, b: tf32_round(a).astype(np.float64)
        @ tf32_round(b).astype(np.float64))
    got = _stack_np(x, c, w, dils, matmul, np.float32)
    errs = [np.abs(a - b).max() / (1 + np.abs(b).max())
            for a, b in zip(got, exact)]
    if products == "tf32x3":
        assert max(errs) <= 1e-6, errs
    else:
        assert min(errs) > 1e-4, errs


def test_stack_bound_and_byte_floor_follow_the_body():
    """PWG v1 serving (32 x 131,072, 30 layers): 1.08e13 FLOP take 65.6 ms
    on the split-TF32 body (495 / 3 TFLOP/s) and 10.9 ms on the bf16 tensor
    cores; one launch a layer moves 1,344 B a row in f32 (c in f32) and
    1,184 B in bf16. Training (6 x 25,600, 30 layers): 2.40 ms in f32."""
    f32, bf16 = torch.float32, torch.bfloat16
    ms, by = chip_smoke.stack_bound_ms(32, 131072, 30, f32,
                                       "tensor_cores_tf32x3")
    assert by == "operations" and abs(ms - 65.6) < 0.05, ms
    ms, by = chip_smoke.stack_bound_ms(6, 25600, 30, f32,
                                       "tensor_cores_tf32x3")
    assert by == "operations" and abs(ms - 2.40) < 0.005, ms
    ms, by = chip_smoke.stack_bound_ms(32, 131072, 30, bf16, "tensor_cores")
    assert by == "operations" and abs(ms - 10.94) < 0.01, ms
    floor = chip_smoke.layer_bytes_floor_ms(32, 131072, 30, f32)
    assert abs(floor - 1344 * 32 * 131072 * 30 / 3.35e9) < 1e-9
    assert abs(floor - 50.5) < 0.05, floor
    assert abs(chip_smoke.layer_bytes_floor_ms(32, 131072, 30, bf16)
               - 44.47) < 0.01


def test_ablation_tool_variants_still_apply_to_the_kernel_source():
    """Every text the ablation tool replaces, for either body, is in
    csrc/wavenet_stack.cu or the bf16 layer body it includes
    (csrc/wavenet_tc_layer.cuh) exactly once, so each variant takes out
    what its name says."""
    from parallelwavegan_torch.ops.cuda.build import CSRC_DIR
    from parallelwavegan_torch.tools.wavenet_stack_ablation import (
        BODY_VARIANTS,
        SOURCES,
        variant_sources,
    )

    sources = [(CSRC_DIR / f).read_text() for f in SOURCES]
    assert '#include "wavenet_tc_layer.cuh"' in sources[0]
    assert set(BODY_VARIANTS) == {torch.bfloat16, torch.float32}
    for dtype, variants in BODY_VARIANTS.items():
        assert variants["base"] == []
        for name, edits in variants.items():
            for old, new in edits:
                assert sum(s.count(old) for s in sources) == 1, (name, old)
                assert old != new
            edited = variant_sources(name, dtype)
            assert (sum(a != b for a, b in zip(edited.values(), sources))
                    == len({f for f, s in zip(SOURCES, sources)
                            for old, _ in edits if old in s}))
