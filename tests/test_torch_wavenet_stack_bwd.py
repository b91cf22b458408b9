"""The backward kernel's launch plan, the split-TF32 arithmetic of its f32
body, and the bound and byte floor chip_smoke.py reports for each body. CPU
only:
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


@pytest.mark.parametrize("dtype,body,data_grid", [
    (torch.float32, "tensor_cores_tf32x3", (400, 6)),
    (torch.bfloat16, "tensor_cores_bf16", (132,))])
def test_plan_picks_the_body_from_dtype(dtype, body, data_grid):
    plan = backward_launch_plan(6, 25600, 80, 10, dtype)
    assert plan["body"] == body
    assert plan["launches"] == 10 and plan["launches_per_layer"] == 2
    assert plan["data_grid"] == data_grid and plan["tiles"] == 2400
    assert plan["weight_grid"] == (plan["slabs"], 6)
    assert max(plan["data_smem"], plan["weight_smem"]) <= SMEM_LIMIT
    slabs, rows = plan["slabs"], plan["rows_per_slab"]
    chunk = 32 if dtype == torch.float32 else 64
    assert rows % chunk == 0 and slabs * rows >= 6 * 25600 > (slabs - 1) * rows


def test_plan_sizes_the_tensor_core_launches():
    """Every block of both bodies' weight launch resident at once (two a
    SM), one slab where the rows are few; the f32 body's shared memory does
    not grow with A (activations and weights stream in chunks), the bf16
    data launch holds the layer's weights (one block an SM, on persistent
    blocks, never more than the tiles)."""
    plan = backward_launch_plan(6, 25600, 80, 30, torch.float32, sms=132)
    assert plan["slabs"] * 6 <= 2 * 132 < (plan["slabs"] + 1) * 6
    assert plan["data_smem"] == 113664 and plan["weight_smem"] == 106496
    assert 2 * (plan["weight_smem"] + 1024) <= 233472
    assert backward_launch_plan(1, 77, 80, 1, torch.float32)["slabs"] == 1
    assert backward_smem_bytes(16, "tensor_cores_tf32x3") == \
        backward_smem_bytes(512, "tensor_cores_tf32x3")
    bf = backward_launch_plan(6, 25600, 80, 30, torch.bfloat16, sms=132)
    assert bf["slabs"] == plan["slabs"] and bf["blocks"] == 132
    assert bf["data_smem"] == 212480 and bf["weight_smem"] == 106496
    assert 2 * (bf["data_smem"] + 1024) > 233472
    assert 2 * (bf["weight_smem"] + 1024) <= 233472
    small = backward_launch_plan(2, 40, 80, 1, torch.bfloat16, sms=132)
    assert small["blocks"] == small["tiles"] == 2 and small["slabs"] == 1
    # 512 bytes more for each aux channel of the padded width
    assert backward_smem_bytes(32, "tensor_cores_bf16")["data"] - \
        backward_smem_bytes(16, "tensor_cores_bf16")["data"] == 16 * 512


def test_plan_refuses_what_the_kernel_cannot_launch():
    # the bf16 data launch holds 3R + A padded to 16 weight rows and stages
    # c padded to 16: 112 fits, 116 not
    assert backward_launch_plan(1, 64, 112, 1, torch.bfloat16)[
        "data_smem"] == 228864
    with pytest.raises(NotImplementedError, match="shared memory"):
        backward_launch_plan(1, 64, 116, 1, torch.bfloat16)
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


@pytest.mark.parametrize("dtype,body,want", [
    (torch.float32, "tensor_cores_tf32x3", 6.75),
    (torch.bfloat16, "tensor_cores_bf16", 1.13)])
def test_backward_bound_follows_the_body(dtype, body, want):
    """Operations at the body's peak: 495 / 3 TFLOP/s for three TF32
    products, 989 TFLOP/s for one bf16 product."""
    ms, by = chip_smoke.backward_bound_ms(6, 25600, 30, 80, dtype, body)
    assert by == "operations" and abs(ms - want) < 0.01, ms


@pytest.mark.parametrize("dtype,want", [(torch.float32, 8.10),
                                        (torch.bfloat16, 6.25)])
def test_two_launch_byte_floor(dtype, want):
    """The bytes each body's two launches move per row and layer over
    3.35 TB/s. f32: data launch 3,072 + 12 A, weight launch 1,536 + 4 A.
    bf16: data launch 2,816 + 10 A (xs, c, dskip, dz, g and bf16(D
    sqrt(1/2)) in bf16; D, the tap rows and dc f32), weight launch
    768 + 2 A (xs, c, g, dz, dskip and bf16(D sqrt(1/2)), all bf16)."""
    ms = chip_smoke.bwd_bytes_floor_ms(6, 25600, 30, 80, dtype)
    assert abs(ms - want) < 0.01, ms
    rows = 6 * 25600 * 30
    per_row = ({torch.float32: (3072 + 12 * 80) + (1536 + 4 * 80),
                torch.bfloat16: (2816 + 10 * 80) + (768 + 2 * 80)}[dtype])
    assert abs(ms - per_row * rows / 3.35e12 * 1e3) < 1e-9


@pytest.mark.parametrize("variant", ["base", "in_place", "chunk_partials"])
def test_f32_sums_tool_variants_still_apply_to_the_kernel_source(variant):
    """Every text tools/backward_f32_sums.py replaces is in
    csrc/wavenet_stack_bwd.cu exactly once, and each variant sums what its
    name says: the source as it is (each k-step's products summed apart in
    all four product loops), every product in place with one running bias
    sum, or a zeroed partial per ring chunk."""
    from parallelwavegan_torch.ops.cuda.build import CSRC_DIR
    from parallelwavegan_torch.tools.backward_f32_sums import (
        VARIANTS,
        variant_source,
    )

    source = (CSRC_DIR / "wavenet_stack_bwd.cu").read_text()
    text = variant_source(variant)
    for old, new in VARIANTS[variant]:
        assert source.count(old) == 1 and old != new
    fresh = text.count("true>(")
    if variant == "base":
        assert text == source and fresh == 4
    elif variant == "in_place":
        assert fresh == 0 and "colsum += rhs" in text
    else:
        assert fresh == 0 and text.count("add_part<") == 4
        assert "colsum += part" in text
