"""The backward kernel's launch plan, the split-TF32 arithmetic of its f32
body, and the bound and byte floor chip_smoke.py reports for it. CPU only:
the kernel itself is held against its plain version on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import chip_smoke
from parallelwavegan_torch.ops.cuda.wavenet_stack_train import (
    backward_launch_plan,
    backward_smem_bytes,
)
from tests.torch_helpers import tf32_round, tf32x3_matmul

SMEM_LIMIT = 232448


@pytest.mark.parametrize("dtype,body", [
    (torch.float32, "tensor_cores_tf32x3"), (torch.bfloat16, "simt")])
def test_plan_picks_the_body_from_dtype(dtype, body):
    plan = backward_launch_plan(6, 25600, 80, 10, dtype)
    assert plan["body"] == body
    assert plan["launches"] == 10 and plan["launches_per_layer"] == 2
    assert plan["data_grid"] == (400, 6)
    assert plan["weight_grid"] == (plan["slabs"], 6)
    assert max(plan["data_smem"], plan["weight_smem"]) <= SMEM_LIMIT
    slabs, rows = plan["slabs"], plan["rows_per_slab"]
    assert rows % 32 == 0 and slabs * rows >= 6 * 25600 > (slabs - 1) * rows


def test_plan_sizes_the_tensor_core_launches():
    """Every block of the tensor-core weight launch resident at once (two a
    SM), one slab where the rows are few, and shared memory that does not
    grow with A (activations and weights stream in chunks)."""
    plan = backward_launch_plan(6, 25600, 80, 30, torch.float32, sms=132)
    assert plan["slabs"] * 6 <= 2 * 132 < (plan["slabs"] + 1) * 6
    assert plan["data_smem"] == 113664 and plan["weight_smem"] == 106496
    assert 2 * (plan["weight_smem"] + 1024) <= 233472
    assert backward_launch_plan(1, 77, 80, 1, torch.float32)["slabs"] == 1
    assert backward_smem_bytes(16, "tensor_cores_tf32x3") == \
        backward_smem_bytes(512, "tensor_cores_tf32x3")
    # the SIMT body's slabs are as before the tensor-core body came
    assert backward_launch_plan(6, 25600, 80, 30, torch.bfloat16)[
        "slabs"] == 64


def test_plan_refuses_what_the_kernel_cannot_launch():
    # the SIMT data launch stages 3R + A activation rows (padded to 16):
    # 544 fits, 548 not
    assert backward_launch_plan(1, 64, 544, 1, torch.bfloat16)[
        "data_smem"] == 229376
    with pytest.raises(NotImplementedError, match="shared memory"):
        backward_launch_plan(1, 64, 548, 1, torch.bfloat16)
    with pytest.raises(NotImplementedError, match="multiple of 4"):
        backward_launch_plan(1, 64, 82, 1, torch.float32)
    with pytest.raises(NotImplementedError):
        backward_launch_plan(1, 64, 80, 1, torch.float16)


def test_tf32_round_keeps_ten_mantissa_bits():
    x = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                  -(1.0 + 2.0 ** -11), 3.0e-3], np.float32)
    r = tf32_round(x)
    np.testing.assert_array_equal(
        r[:5], np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                         -(1.0 + 2.0 ** -10)], np.float32))
    assert (r.view(np.uint32) & 0x1FFF == 0).all()
    assert abs(r[5] - x[5]) <= 2.0 ** -11 * abs(x[5])


# (rows, contraction, columns, scale of the right-hand side): the data
# launch's gate recompute, dg and [taps | dc], and the weight launch's row
# contraction over one slab at the training shape
_PRODUCTS = [(64, 272, 128, 0.1), (64, 128, 64, 0.1), (64, 128, 272, 0.1),
             (272, 2400, 128, 1.0)]


@pytest.mark.parametrize("M,K,N,scale", _PRODUCTS)
def test_three_term_split_keeps_f32_accuracy(M, K, N, scale):
    """Three TF32 products stay within 1e-6 (1 + max) of the exact
    product, far inside the card tests' 1e-4; one TF32 product does not
    stay within 1e-4, which is why plain TF32 is ruled out."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) * scale).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    denom = 1 + np.abs(exact).max()
    split = np.abs(tf32x3_matmul(a, b) - exact).max() / denom
    one = np.abs(tf32_round(a).astype(np.float64)
                 @ tf32_round(b).astype(np.float64) - exact).max() / denom
    assert split <= 1e-6, split
    assert one > 1e-4, one


def test_backward_bound_follows_the_body():
    ms, by = chip_smoke.backward_bound_ms(6, 25600, 30, 80, torch.float32,
                                          "tensor_cores_tf32x3")
    assert by == "operations" and abs(ms - 6.75) < 0.01, ms
    simt_ms, by = chip_smoke.backward_bound_ms(6, 25600, 30, 80,
                                               torch.float32, "simt")
    assert by == "operations" and abs(simt_ms - 16.62) < 0.01, simt_ms


def test_two_launch_byte_floor():
    """The bytes the two-launch design moves per row and layer in f32 (data
    launch 3,072 + 12 A, weight launch 1,536 + 4 A) over 3.35 TB/s."""
    ms = chip_smoke.bwd_bytes_floor_ms(6, 25600, 30, 80, torch.float32)
    assert abs(ms - 8.10) < 0.01, ms
    assert chip_smoke.bwd_bytes_floor_ms(6, 25600, 30, 80,
                                         torch.bfloat16) < ms
