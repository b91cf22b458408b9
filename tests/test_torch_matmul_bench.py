"""The matmul bench wrapper's tiling choices (pure Python, no card): row
tile, n-tile, ring stages and shared memory at every shape the port's
paths give it. The kernel against its plain version is in
test_torch_cuda.py; the plain version against numpy in
test_torch_hifigan_serving.py."""

import pytest
import torch

from parallelwavegan_torch.ops.cuda.matmul_bench import (
    MRF_SHAPES,
    matmul_bench,
    matmul_plan,
)

_SMEM_LIMIT = 232448


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16],
                         ids=["int8", "bf16"])
@pytest.mark.parametrize("M,K,N", MRF_SHAPES)
def test_plan_fits_a_block_at_the_mrf_shapes(M, K, N, dtype):
    plan = matmul_plan(M, K, N, dtype)
    assert plan["smem"] <= _SMEM_LIMIT
    assert 2 <= plan["stages"] <= 4
    assert plan["n_tile"] == N  # the MRF widths are powers of two
    assert plan["row_tile"] == (128 if N <= 32 else 64)
    assert plan["tiles"] * plan["row_tile"] >= M
    # one staged row: K padded to the 32-byte mma depth, plus 16 bytes, an
    # odd number of 16-byte chunks (ldmatrix reads free of bank conflicts)
    item = 1 if dtype == torch.int8 else 2
    assert plan["stride"] == -(-K * item // 32) * 32 + 16
    assert (plan["stride"] // 16) % 2 == 1
    # the most stages that fit: one more would not
    if plan["stages"] < 4:
        scratch = 0 if plan["alias"] else \
            plan["row_tile"] * (plan["n_tile"] + 8) * 4
        more = (plan["n_tile"] + (plan["stages"] + 1) * plan["row_tile"]) \
            * plan["stride"] + scratch
        assert more > _SMEM_LIMIT


@pytest.mark.parametrize("N,n_tile,row_tile", [
    (8, 8, 128), (16, 16, 128), (24, 32, 128), (40, 64, 64), (128, 128, 64),
])
def test_plan_rounds_n_up_and_picks_the_row_tile(N, n_tile, row_tile):
    plan = matmul_plan(77, 50, N, torch.bfloat16)
    assert (plan["n_tile"], plan["row_tile"]) == (n_tile, row_tile)
    # K = 50 pads to 64 bf16 (two mma steps of 16)
    assert plan["stride"] == 64 * 2 + 16
    assert plan["tiles"] == -(-77 // row_tile)


def test_plan_epilogue_reuses_the_a_rows_only_where_they_are_wide_enough():
    # int8 K = 96: rows of 112 bytes, narrower than 32 + 8 int32 results
    narrow = matmul_plan(131072, 96, 32, torch.int8)
    assert not narrow["alias"]
    assert narrow["smem"] == (32 + 4 * 128) * 112 + 128 * 40 * 4
    wide = matmul_plan(131072, 352, 32, torch.int8)
    assert wide["alias"]
    assert wide["smem"] == (32 + 4 * 128) * 368


def test_plan_rejects_what_the_kernel_lacks():
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        matmul_plan(64, 32, 12, torch.int8)
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        matmul_plan(64, 32, 136, torch.bfloat16)
    with pytest.raises(NotImplementedError, match="shared memory"):
        matmul_plan(64, 2048, 128, torch.bfloat16)
    # the CPU takes the plain version whatever the plan would say
    out = matmul_bench(torch.ones(3, 2048, dtype=torch.int8),
                       torch.ones(2048, 8, dtype=torch.int8))
    assert out.dtype == torch.int32 and int(out[0, 0]) == 2048
