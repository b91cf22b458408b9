"""The port's HiFi-GAN serving functions against the JAX package on the
CPU: the fast forward in its three modes, calibration, the int8 conv
chain, the MRF packs (exact) and the plain version of the fused MRF stage
against the Pallas kernel in interpret mode and its JAX reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelwavegan_tpu.models import HiFiGANGenerator as FlaxGenerator
from parallelwavegan_tpu.ops import hifigan_infer as jax_infer
from parallelwavegan_tpu.ops.pallas import mrf_stage as jax_mrf
from parallelwavegan_torch.models import HiFiGANGenerator
from parallelwavegan_torch.ops import hifigan_infer as infer
from parallelwavegan_torch.ops.cuda import mrf_stage as mrf
from parallelwavegan_torch.utils.params import convert_jax_params
from tests.test_torch_hifigan import SMALL, perturbed

torch.set_num_threads(2)

# the tolerance of tests/test_mrf_stage.py
TOL = dict(atol=2e-6, rtol=1e-5)


@pytest.fixture(scope="module")
def small():
    """(flax generator, variables, the port's generator with the same
    weights, c as numpy): the small generator of tests/test_mrf_stage.py
    with perturbed weights."""
    flax = FlaxGenerator(**SMALL)
    rng = np.random.default_rng(1)
    c = rng.standard_normal((2, 40, 12)).astype(np.float32)
    v = perturbed(flax.init({"params": jax.random.key(0)},
                            jnp.asarray(c[:, :8])))
    gen = HiFiGANGenerator(**SMALL)
    gen.load_state_dict(convert_jax_params(v["params"]), strict=True)
    return flax, v, gen.eval().requires_grad_(False), c


def test_fast_forward_exact_mode_is_the_module_forward(small):
    flax, v, gen, c = small
    ct = torch.from_numpy(c)
    y = infer.hifigan_fast_forward(gen, ct)
    assert torch.equal(y, gen(ct))
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jax_infer.hifigan_fast_forward(
            flax, v, jnp.asarray(c))), **TOL)


def test_calibration_matches_jax(small):
    flax, v, gen, c = small
    _, want = jax_infer.hifigan_fast_forward(flax, v, jnp.asarray(c),
                                             collect_stats=True)
    y, got = infer.hifigan_fast_forward(gen, torch.from_numpy(c),
                                        collect_stats=True)
    assert sorted(got) == sorted(want) and len(got) == 2 + 2 * 3 * 2 * 2
    assert y.shape == (2, 320, 1)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    np_stats = {k: np.asarray(s) for k, s in want.items()}
    a, b = infer.make_scales(np_stats), jax_infer.make_scales(np_stats)
    for key in b:
        np.testing.assert_array_equal(a[key], b[key])
    cal = infer.calibrate(gen, torch.from_numpy(c))
    ref = jax_infer.calibrate(flax, v, jnp.asarray(c))
    for key in ref:
        np.testing.assert_allclose(cal[key], ref[key], rtol=1e-5)


@pytest.mark.parametrize("schedule", ["all", "auto"])
def test_filter_scales_schedule_key_sets(schedule):
    kw = dict(SMALL, channels=512, upsample_scales=(2, 2, 2),
              upsample_kernel_sizes=(4, 4, 4))
    flax, gen = FlaxGenerator(**kw), HiFiGANGenerator(**kw)
    keys = [f"s{i}_up" for i in range(3)] + [
        f"s{i}_b{j}_l{li}_c{ci}" for i in range(3) for j in range(3)
        for li in range(2) for ci in (1, 2)]
    scales = {k: np.ones(4, np.float32) for k in keys}
    got = infer.filter_scales_schedule(scales, gen, schedule)
    want = jax_infer.filter_scales_schedule(scales, flax, schedule)
    assert sorted(got) == sorted(want)
    # stages 0 and 1 are 256 and 128 wide, stage 2 is 64 wide
    assert len(got) == (39 if schedule == "all" else 3 + 24)
    with pytest.raises(ValueError, match="schedule"):
        infer.filter_scales_schedule(scales, gen, "none")


def test_int8_products_are_exact():
    """The int8 conv and transposed conv against integer numpy sums."""
    rng = np.random.default_rng(2)
    xq = rng.integers(-127, 128, (2, 19, 8)).astype(np.int8)
    wq = rng.integers(-127, 128, (5, 8, 6)).astype(np.int8)
    for d in (1, 3):
        pad = 2 * d
        xp = np.pad(xq.astype(np.int64), ((0, 0), (pad, pad), (0, 0)))
        want = sum(xp[:, t * d: t * d + 19] @ wq[t].astype(np.int64)
                   for t in range(5))
        got = infer.int8_conv1d(torch.from_numpy(xq), torch.from_numpy(wq),
                                pad, d)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    for stride, k, p, op in ((4, 8, 2, 0), (3, 6, 3, 1), (5, 10, 3, 1),
                             (2, 5, 1, 0)):
        wq = rng.integers(-127, 128, (k, 8, 6)).astype(np.int8)
        full = np.zeros((2, 18 * stride + k + op, 6), np.int64)
        for t in range(19):
            full[:, t * stride: t * stride + k] += np.einsum(
                "bc,kco->bko", xq[:, t].astype(np.int64),
                wq.astype(np.int64))
        want = full[:, p: 18 * stride + k - p + op]
        got = infer.int8_conv_transpose1d(
            torch.from_numpy(xq), torch.from_numpy(wq), stride, p, op)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("keys", ["all", "mrf_only", "stage1_only"])
def test_int8_chain_matches_jax(small, keys):
    """Same scales through both int8 chains: the same waveform (identical
    quantisation decisions), f32."""
    flax, v, gen, c = small
    scales = jax_infer.calibrate(flax, v, jnp.asarray(c))
    if keys == "mrf_only":
        scales = {k: s for k, s in scales.items() if not k.endswith("_up")}
    elif keys == "stage1_only":
        scales = {k: s for k, s in scales.items() if k.startswith("s1_")}
    want = np.asarray(jax_infer.hifigan_fast_forward(
        flax, v, jnp.asarray(c), scales=scales))
    ct = torch.from_numpy(c)
    got = infer.hifigan_fast_forward(gen, ct, scales=scales)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # pre-quantised weights give the same bits
    again = infer.hifigan_fast_forward(
        gen, ct, scales=scales, qweights=infer.quantize_weights(gen, scales))
    assert torch.equal(got, again)
    exact = infer.hifigan_fast_forward(gen, ct)
    assert 0 < (got - exact).abs().max() < 0.05 * exact.abs().max()


def _rand_stage(rng, C, kernels, dils):
    weights = [[(rng.standard_normal((k, C, C)).astype(np.float32) * 0.2,
                 rng.standard_normal(C).astype(np.float32) * 0.05)
                for _ in range(len(dils) * 2)] for k in kernels]
    scales = [[np.abs(rng.standard_normal(C)).astype(np.float32) * 0.05 + 0.01
               for _ in range(len(dils) * 2)] for _ in kernels]
    return weights, scales


@pytest.mark.parametrize("quant", [False, True])
def test_build_stage_pack_equals_the_jax_pack(quant):
    """int8 weights bit for bit, f32 scale rows bit for bit (both are the
    same numpy arithmetic)."""
    rng = np.random.default_rng(3)
    kernels, dils = (3, 5, 7), (1, 2)
    weights, scales = _rand_stage(rng, 8, kernels, dils)
    want = jax_mrf.build_stage_pack(weights, scales, quant=quant,
                                    dtype=jnp.bfloat16)
    got = mrf.build_stage_pack(weights, scales, quant=quant,
                               dtype=torch.bfloat16)
    for b, k in enumerate(kernels):
        w = got[f"w{b}"]
        assert w.dtype == (torch.int8 if quant else torch.bfloat16)
        np.testing.assert_array_equal(
            w.float().numpy(),
            np.asarray(want[f"w{b}"].astype(jnp.float32)))
        np.testing.assert_array_equal(got[f"s{b}"].numpy(),
                                      np.asarray(want[f"s{b}"]))
        # the kernel's layout: transposed, zero-padded to a multiple of 32
        wt = got[f"wt{b}"]
        kpad = -(-k * 8 // 32) * 32
        assert tuple(wt.shape) == (2, 2, 8, kpad) and wt.dtype == w.dtype
        assert torch.equal(wt[..., : k * 8], w.transpose(2, 3))
        assert not wt[..., k * 8:].any()


@pytest.mark.parametrize("quant", [False, True])
def test_build_mrf_packs_equal_the_jax_packs(small, quant):
    flax, v, gen, c = small
    scales = jax_infer.calibrate(flax, v, jnp.asarray(c)) if quant else None
    want = jax_infer.build_mrf_packs(flax, v, scales, quant=quant,
                                     dtype=jnp.float32)
    got = infer.build_mrf_packs(gen, scales, quant=quant, dtype=torch.float32)
    assert sorted(got) == sorted(want) == [0, 1]
    for i in want:
        assert got[i]["chunk"] == want[i]["chunk"] == 1024
        assert got[i]["quant"] == want[i]["quant"] == quant
        for b in range(3):
            # the folded kernels of the two packages agree to an f32 ulp,
            # so a quantised weight may land on the neighbouring integer
            # where the value sat on a rounding border
            wa = got[i][f"w{b}"].float().numpy()
            wb = np.asarray(want[i][f"w{b}"].astype(jnp.float32))
            if quant:
                assert np.abs(wa - wb).max() <= 1
                assert (wa != wb).mean() < 1e-3
            else:
                np.testing.assert_allclose(wa, wb, rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(got[i][f"s{b}"].numpy(),
                                       np.asarray(want[i][f"s{b}"]),
                                       rtol=1e-6, atol=1e-9)
    only = infer.build_mrf_packs(gen, quant=False, dtype=torch.float32,
                                 stages=[1])
    assert list(only) == [1]
    with pytest.raises(ValueError, match="calibration scales"):
        infer.build_mrf_packs(gen, quant=True)


def test_supports_mrf_kernel():
    assert infer.supports_mrf_kernel(HiFiGANGenerator(**SMALL))
    uneven = HiFiGANGenerator(**dict(
        SMALL, resblock_dilations=((1, 3), (1, 3), (1, 5))))
    assert not infer.supports_mrf_kernel(uneven)
    plain = HiFiGANGenerator(**dict(SMALL, use_additional_convs=False))
    assert not infer.supports_mrf_kernel(plain)
    with pytest.raises(NotImplementedError, match="3 residual branches"):
        infer.build_mrf_packs(plain, quant=False)
    # a width the CUDA kernel lacks is refused when the pack is built
    odd = HiFiGANGenerator(**dict(SMALL, channels=48))
    with pytest.raises(NotImplementedError, match="channels 24"):
        infer.build_mrf_packs(odd, quant=False)
    assert mrf.unsupported_shape(512, (3, 7, 11), (1, 3, 5),
                                 torch.bfloat16) is not None
    for C in (8, 16, 32, 64, 128, 256):
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            assert mrf.unsupported_shape(C, (3, 7, 11), (1, 3, 5), dt) is None


V1 = ((3, 7, 11), (1, 3, 5))


@pytest.mark.parametrize("C,T", [(256, 4096), (128, 32768), (64, 65536),
                                 (32, 131072)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.int8])
def test_plan_fuses_the_conv_pair_at_the_v1_stages(C, T, dt):
    """HiFi-GAN v1's four stages at batch 32 x 512 frames in bf16 and int8:
    the fused-pair body, one launch a layer and the mean, a block's window,
    y1 and three-slot ring within 227 KB, every weight byte feeding at
    least 128 rows."""
    plan = mrf.mrf_stage_plan(32, T, C, *V1, dt)
    assert plan["body"] == "fused_pair" and plan["launches"] == 4
    assert plan["smem"] <= 232448 and plan["ring_stages"] >= 3
    rows = plan["tile"]["rows"]
    assert rows >= 128 and plan["tile"]["out_rows"] == [rows - 2, rows - 6,
                                                        rows - 10]
    assert plan["blocks"] == 32 * sum(-(-T // n)
                                      for n in plan["tile"]["out_rows"])
    assert plan["smem"] == mrf.fused_smem_bytes(C, V1[0], 5, dt)
    wm, wn = plan["tile"]["warps"]
    assert plan["threads"] == 32 * wm * wn == 256
    assert plan["tile"]["columns"] == C


@pytest.mark.parametrize("C,dt,kernels,dils", [
    (8, torch.bfloat16) + V1, (16, torch.int8) + V1,
    (8, torch.float32, (3, 5, 7), (1, 2)), (16, torch.bfloat16, (3, 5, 7),
                                            (1, 2)),
    (32, torch.float32) + V1, (256, torch.float32) + V1,
])
def test_plan_keeps_the_per_conv_body_for_f32_and_narrow_widths(
        C, dt, kernels, dils):
    """f32 packs (the parity mode) and C 8 and 16 keep the per-conv body:
    two launches a layer and the mean."""
    plan = mrf.mrf_stage_plan(2, 300, C, kernels, dils, dt)
    assert plan["body"] == "per_conv"
    assert plan["launches"] == 2 * len(dils) + 1
    assert plan["smem"] <= 232448


def test_plan_refuses_what_neither_body_takes():
    """Neither body takes C 512 or an even kernel size; a dilation too wide
    for the fused window falls to the per-conv body only where that fits."""
    for args in ((512,) + V1 + (torch.bfloat16,),
                 (64, (3, 4), (1,), torch.int8)):
        with pytest.raises(NotImplementedError, match="does not support"):
            mrf.mrf_stage_plan(1, 100, *args)
    wide = mrf.mrf_stage_plan(1, 100, 64, (3, 7, 11), (1, 260), torch.int8)
    assert wide["body"] == "per_conv"
    assert mrf.fused_smem_bytes(64, (3, 7, 11), 260, torch.int8) > 232448
    with pytest.raises(NotImplementedError, match="shared memory"):
        mrf.mrf_stage_plan(1, 100, 256, (3, 7, 11), (1, 40), torch.bfloat16)


def test_ablation_tool_variants_still_apply_to_the_kernel_source():
    """Every text the MRF ablation tool replaces is in csrc/mrf_stage.cu
    exactly once, so each variant takes out what its name says."""
    from parallelwavegan_torch.ops.cuda.build import CSRC_DIR
    from parallelwavegan_torch.tools.mrf_stage_ablation import VARIANTS

    source = (CSRC_DIR / "mrf_stage.cu").read_text()
    assert VARIANTS["base"] == []
    for name, edits in VARIANTS.items():
        for old, new in edits:
            assert source.count(old) == 1, (name, old)
            assert old != new


def test_mrf_chain_stage_is_the_residual_blocks(small):
    """The factored conv chain of one stage (the forward's own, timed as
    the library yardstick on the card) equals the mean of the stage's
    HiFiGANResidualBlock modules."""
    _, _, gen, c = small
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 50, 16)).astype(np.float32))
    got = infer.mrf_chain_stage(gen, 0, x, 0.1)
    blocks = gen.blocks[0:3]
    want = (blocks[0](x) + blocks[1](x) + blocks[2](x)) / 3
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ragged T, T below one chunk of the JAX kernel, T below the reach
@pytest.mark.parametrize("T", [300, 64, 20, 7])
@pytest.mark.parametrize("quant", [False, True])
def test_stage_plain_version_matches_jax_kernel_and_reference(quant, T):
    rng = np.random.default_rng(0)
    C, B = 8, 2
    kernels, dils = (3, 5, 7), (1, 2)
    weights, scales = _rand_stage(rng, C, kernels, dils)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    jpack = jax_mrf.build_stage_pack(weights, scales, quant=quant,
                                     dtype=jnp.float32)
    ref = jax_mrf.mrf_stage_reference(jnp.asarray(x), jpack, kernels=kernels,
                                      dils=dils, quant=quant)
    ker = jax_mrf.mrf_stage(jnp.asarray(x), jpack, kernels=kernels,
                            dils=dils, chunk=64, quant=quant, interpret=True)
    pack = mrf.build_stage_pack(weights, scales, quant=quant,
                                dtype=torch.float32)
    got = mrf.mrf_stage_reference(torch.from_numpy(x), pack, kernels=kernels,
                                  dils=dils, quant=quant)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ker), **TOL)
    # on a CPU tensor the wrapper takes the plain version, and counts nothing
    before = mrf.mrf_stage.launches
    via = mrf.mrf_stage(torch.from_numpy(x), pack, kernels=kernels, dils=dils,
                        chunk=64, quant=quant)
    assert torch.equal(via, got) and mrf.mrf_stage.launches == before


def test_stage_plain_version_v1_geometry():
    """Kernel sizes (3, 7, 11) and dilations (1, 3, 5) at C = 16."""
    rng = np.random.default_rng(4)
    kernels, dils = (3, 7, 11), (1, 3, 5)
    weights, scales = _rand_stage(rng, 16, kernels, dils)
    x = rng.standard_normal((1, 90, 16)).astype(np.float32)
    for quant in (False, True):
        jpack = jax_mrf.build_stage_pack(weights, scales, quant=quant,
                                         dtype=jnp.float32)
        ref = jax_mrf.mrf_stage_reference(jnp.asarray(x), jpack,
                                          quant=quant)
        pack = mrf.build_stage_pack(weights, scales, quant=quant,
                                    dtype=torch.float32)
        got = mrf.mrf_stage_reference(torch.from_numpy(x), pack, quant=quant)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


def test_stage_plain_version_bf16_follows_the_jax_reference():
    """bf16 x and bf16 packs: the port keeps the f32 residual stream and
    rounds the branch mean once, as the JAX mrf_stage_reference does (the
    Pallas kernel rounds the running mean after every branch). Against
    that reference, one bf16 ulp of the output's largest value."""
    rng = np.random.default_rng(5)
    kernels, dils = (3, 5, 7), (1, 2)
    weights, scales = _rand_stage(rng, 8, kernels, dils)
    x = rng.standard_normal((2, 100, 8)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for quant in (False, True):
        jpack = jax_mrf.build_stage_pack(weights, scales, quant=quant,
                                         dtype=jnp.bfloat16)
        ref = np.asarray(jax_mrf.mrf_stage_reference(
            xj, jpack, kernels=kernels, dils=dils,
            quant=quant).astype(jnp.float32))
        pack = mrf.build_stage_pack(weights, scales, quant=quant,
                                    dtype=torch.bfloat16)
        got = mrf.mrf_stage_reference(xt, pack, kernels=kernels, dils=dils,
                                      quant=quant)
        assert got.dtype == torch.bfloat16
        ulp = np.abs(ref).max() * 2.0 ** -7
        assert np.abs(got.float().numpy() - ref).max() <= ulp


def test_full_model_packs_match_jax(small):
    """The three full-model cases of tests/test_mrf_stage.py through the
    port: f32 packs == exact forward, int8 packs == the int8 chain on the
    MRF keys, a stage subset == exact; each also against the JAX package's
    kernel path in interpret mode."""
    flax, v, gen, c = small
    cj, ct = jnp.asarray(c), torch.from_numpy(c)
    exact = infer.hifigan_fast_forward(gen, ct).numpy()

    def jax_kernel_path(**kw):
        packs = jax_infer.build_mrf_packs(flax, v, **kw)
        for p in packs.values():
            p["chunk"] = 32
        return np.asarray(jax_infer.hifigan_fast_forward(
            flax, v, cj, mrf_packs=packs, mrf_interpret=True))

    packs = infer.build_mrf_packs(gen, quant=False, dtype=torch.float32)
    y = infer.hifigan_fast_forward(gen, ct, mrf_packs=packs).numpy()
    np.testing.assert_allclose(y, exact, **TOL)
    np.testing.assert_allclose(
        y, jax_kernel_path(quant=False, dtype=jnp.float32), **TOL)

    scales = jax_infer.calibrate(flax, v, cj)
    mrf_scales = {k: s for k, s in scales.items() if not k.endswith("_up")}
    y_q = infer.hifigan_fast_forward(gen, ct, scales=mrf_scales).numpy()
    packs = infer.build_mrf_packs(gen, scales, quant=True)
    y_k = infer.hifigan_fast_forward(gen, ct, mrf_packs=packs).numpy()
    np.testing.assert_allclose(y_k, y_q, **TOL)
    np.testing.assert_allclose(y_k, jax_kernel_path(scales=scales,
                                                    quant=True), **TOL)

    packs = infer.build_mrf_packs(gen, quant=False, dtype=torch.float32,
                                  stages=[1])
    y = infer.hifigan_fast_forward(gen, ct, mrf_packs=packs).numpy()
    np.testing.assert_allclose(y, exact, **TOL)


def test_int8_chain_in_bf16_against_the_kernel_semantics(small):
    """What bf16 does to the pair the f32 tests hold together: the conv
    chain divides by sx in bf16 and carries a bf16 residual, the fused
    stage multiplies by 1/sx in f32 on an f32 residual. They stay close
    (a few bf16 ulps of the output), not equal."""
    flax, v, gen, c = small
    scales = jax_infer.calibrate(flax, v, jnp.asarray(c))
    mrf_scales = {k: s for k, s in scales.items() if not k.endswith("_up")}
    gen16 = HiFiGANGenerator(**SMALL)
    gen16.load_state_dict(gen.state_dict())
    gen16 = gen16.to(torch.bfloat16).eval().requires_grad_(False)
    ct = torch.from_numpy(c).to(torch.bfloat16)
    y_q = infer.hifigan_fast_forward(gen16, ct, scales=mrf_scales).float()
    packs = infer.build_mrf_packs(gen16, scales, quant=True)
    y_k = infer.hifigan_fast_forward(gen16, ct, mrf_packs=packs).float()
    exact = infer.hifigan_fast_forward(gen, torch.from_numpy(c))
    err = (y_k - y_q).abs().max().item()
    assert err <= 0.1 * exact.abs().max().item()
    assert (y_k - exact).abs().max() <= 0.1 * exact.abs().max()
