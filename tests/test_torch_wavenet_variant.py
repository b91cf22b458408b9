"""The port's plain version of the experiment's WaveNet variant kernel and
its quantiser against the JAX tool (``tools/int8_wavenet_experiment.py``,
loaded by path, its Pallas kernel in interpret mode) on the same
numpy-seeded inputs."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelwavegan_torch.ops.cuda.wavenet_variant import (
    quantize_taps,
    variant_stack,
    variant_stack_reference,
)
from parallelwavegan_torch.tools import int8_wavenet_experiment as tool

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, G, A, S = 16, 32, 20, 16
DILATIONS = (1, 2, 4)


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX tool as a module, with its kernel in interpret mode (the
    flag is read at trace time, so it is set before the first call and
    stays set while this module's tests run)."""
    old = os.environ.get("EXP_INTERPRET")
    os.environ["EXP_INTERPRET"] = "1"
    spec = importlib.util.spec_from_file_location(
        "jax_int8_wavenet_experiment",
        os.path.join(REPO, "tools", "int8_wavenet_experiment.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    yield module
    if old is None:
        os.environ.pop("EXP_INTERPRET", None)
    else:
        os.environ["EXP_INTERPRET"] = old


def _inputs(B=2, T=300, seed=0, w_scale=0.15):
    rng = np.random.default_rng(seed)
    L = len(DILATIONS)
    f32 = np.float32
    w = {
        "w_tap": (rng.standard_normal((L, 3 * R, G)) * w_scale).astype(f32),
        "b_tap": (rng.standard_normal((L, G)) * 0.05).astype(f32),
        "w_aux": (rng.standard_normal((L, A, G)) * w_scale).astype(f32),
        "w_so": (rng.standard_normal((L, R, S + R)) * w_scale).astype(f32),
        "b_so": (rng.standard_normal((L, S + R)) * 0.05).astype(f32),
    }
    x = (rng.standard_normal((B, T, R)) * 0.3).astype(f32)
    c = (rng.standard_normal((B, T, A)) * 0.5).astype(f32)
    return w, x, c


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _jax_quantiser(w_tap, act_max):
    """Lines 295-309 of the JAX tool's main()."""
    L = w_tap.shape[0]
    gate_scale = np.concatenate([np.ones(R), np.full(G - R, 0.5)])
    w_tap_f = np.asarray(w_tap) * gate_scale
    w_scale = np.abs(w_tap_f).max(axis=(1, 2)) / 127.0
    w_tap_q = np.clip(np.round(w_tap_f / w_scale[:, None, None]),
                      -127, 127).astype(np.int8)
    act_scale = act_max / 127.0
    s_tap = np.stack([np.full(L, 1.0 / act_scale), w_scale * act_scale],
                     axis=1).astype(np.float32)
    return w_tap_q, s_tap


def test_quantize_taps_matches_the_jax_tool():
    w, _, _ = _inputs()
    for w_tap in (w["w_tap"], w["w_tap"].reshape(-1, 3, R, G)):
        got_q, got_s = quantize_taps(torch.from_numpy(w_tap), 2.345)
        want_q, want_s = _jax_quantiser(w["w_tap"], 2.345)
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_q.numpy(), want_q)
        np.testing.assert_array_equal(got_s.numpy(), want_s)


@pytest.mark.parametrize("gate,int8_taps,T", [
    ("tanh", False, 300), ("mul", False, 300), ("tanh", True, 300),
    ("tanh", True, 77), ("tanh", False, 3), ("mul", True, 130),
], ids=["tanh", "mul", "int8", "int8_ragged", "tanh_T_below_d", "mul_int8"])
def test_reference_matches_jax_variant_stack(jax_tool, gate, int8_taps, T):
    """Same bf16 inputs through the JAX wrapper (Pallas interpret mode,
    chunk 128, so T is ragged against the chunk and the halo) and the
    port's plain version. Both round at the same points; what differs is
    the order of the f32 sums and the two tanh implementations, which now
    and then move a bf16 rounding of g (or, with int8 taps, one
    quantisation step of the next layer's input) by one unit: 2e-2 of
    (1 + max |reference|), the tolerance the kernels are held to on the
    card, with the mean error held to a hundredth of that."""
    w, x, c = _inputs(T=T)
    s_tap = np.ones((len(DILATIONS), 2), np.float32)
    wj = {k: jnp.asarray(v) for k, v in w.items()}
    wt = {k: torch.from_numpy(v) for k, v in w.items()}
    if int8_taps:
        q, s = quantize_taps(wt["w_tap"], 4.0)
        wt["w_tap_q"], s_tap = q, s.numpy()
        wj["w_tap_q"] = jnp.asarray(q.numpy())
    xb, cb = _bf16(x), _bf16(c)
    want_x, want_skip = jax_tool.variant_stack(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16),
        jnp.asarray(cb.float().numpy(), jnp.bfloat16), wj,
        jnp.asarray(s_tap), DILATIONS, chunk=128, gate=gate,
        int8_taps=int8_taps)
    got_x, got_skip = variant_stack_reference(
        xb, cb, wt, torch.from_numpy(s_tap), DILATIONS, gate=gate,
        int8_taps=int8_taps)
    assert got_x.dtype == torch.bfloat16 and got_skip.dtype == torch.float32
    assert got_x.shape == (2, T, R) and got_skip.shape == (2, T, S)
    for what, got, want in (("x", got_x, want_x), ("skip", got_skip,
                                                   want_skip)):
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want)
        allowed = 2e-2 * (1 + np.abs(want).max())
        assert err.max() <= allowed, (what, err.max(), allowed)
        assert err.mean() <= 1e-2 * allowed, (what, err.mean())


def test_cpu_wrapper_takes_the_plain_version_and_checks_arguments():
    w, x, c = _inputs(T=50)
    wt = {k: torch.from_numpy(v) for k, v in w.items()}
    s_tap = torch.ones((len(DILATIONS), 2))
    before = variant_stack.launches
    got = variant_stack(_bf16(x), _bf16(c), wt, s_tap, DILATIONS)
    want = variant_stack_reference(_bf16(x), _bf16(c), wt, s_tap, DILATIONS)
    assert variant_stack.launches == before  # no kernel on the CPU
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="gate"):
        variant_stack(_bf16(x), _bf16(c), wt, s_tap, DILATIONS, gate="relu")
    # the tanh form of the gate is the sigmoid gate of the serving stack
    from parallelwavegan_torch.ops.cuda.wavenet_stack import (
        wavenet_stack_reference,
    )
    L = len(DILATIONS)
    w_prod = {k: v.to(torch.bfloat16) for k, v in wt.items()}
    w_prod["w_tap"] = w_prod["w_tap"].reshape(L, 3, R, G)
    base = wavenet_stack_reference(_bf16(x), _bf16(c), w_prod, DILATIONS)
    for a, b in zip(want, base):
        assert (a.float() - b.float()).abs().max() <= 2e-2 * (
            1 + b.float().abs().max())


def test_tool_inputs_follow_the_jax_tools_draws():
    """make_inputs draws what the JAX tool's main() draws from seed 0."""
    w, x, c = tool.make_inputs(batch=2, frames=1, layers=3)
    rng = np.random.default_rng(0)
    L = 3
    want_tap = (rng.standard_normal((L, 3, tool.R, tool.G)) * 0.08).astype(
        np.float32).reshape(L, 3 * tool.R, tool.G)
    np.testing.assert_array_equal(w["w_tap"], want_tap)
    rng.standard_normal((L, tool.G))
    rng.standard_normal((L, tool.A, tool.G))
    rng.standard_normal((L, tool.R, tool.S + tool.R))
    want_b_so = (rng.standard_normal((L, tool.S + tool.R)) * 0.01).astype(
        np.float32)
    np.testing.assert_array_equal(w["b_so"], want_b_so)
    want_x = (rng.standard_normal((2, 256, tool.R)) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(x, want_x)
    assert c.shape == (2, 256, tool.A) and c.dtype == np.float32
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            tool.main(["--batch", "1", "--frames", "1"])



# the kernel's widths (csrc/wavenet_common.cuh), which the layouts below use
KR, KG = 64, 128


@pytest.mark.parametrize("B,T,A,L", [(32, 131072, 80, 10), (1, 7, 80, 1),
                                     (3, 333, 36, 3), (2, 4133, 16, 2)],
                         ids=["tool", "below_a_tile", "ragged", "A16"])
@pytest.mark.parametrize("gate,int8_taps", [("tanh", False), ("mul", False),
                                            ("tanh", True), ("mul", True)],
                         ids=["bf16_tanh", "bf16_mul", "int8_taps",
                              "int8_mul"])
def test_variant_launch_plan(B, T, A, L, gate, int8_taps):
    """One launch a layer; bf16 taps on the serving stack's tensor-core
    body over as many persistent blocks as fit 132 SMs (one a tile at
    most), int8 taps on the SIMT body, one block a tile; the shared memory
    of the layer's largest instantiation."""
    from parallelwavegan_torch.ops.cuda.wavenet_stack import stack_launch_plan
    from parallelwavegan_torch.ops.cuda.wavenet_variant import (
        variant_launch_plan,
        variant_smem_bytes,
    )

    plan = variant_launch_plan(B, T, A, L, gate, int8_taps)
    tiles = B * -(-T // 64)
    assert plan["body"] == ("simt_int8_taps" if int8_taps
                            else "tensor_cores_bf16")
    assert plan["gate"] == gate and plan["launches"] == L
    assert plan["tiles"] == tiles and plan["tile_rows"] == 64
    assert plan["blocks"] == (tiles if int8_taps else min(tiles, 132))
    widest = torch.float32 if L > 1 else torch.bfloat16
    assert plan["smem"] == variant_smem_bytes(A, widest, int8_taps) <= 232448
    if not int8_taps:  # the serving stack's own body and footprint
        serving = stack_launch_plan(B, T, A, L, torch.bfloat16)
        assert (plan["smem"], plan["blocks"]) == (serving["smem"],
                                                  serving["blocks"])
    if (B, T, A, L) == (32, 131072, 80, 10):
        assert plan["smem"] == (57344 if int8_taps else 228352)


@pytest.mark.parametrize("int8_taps,A", [(False, 160), (True, 800)],
                         ids=["bf16", "int8"])
def test_variant_launch_plan_refuses_what_fits_no_body(int8_taps, A):
    from parallelwavegan_torch.ops.cuda.wavenet_variant import (
        variant_launch_plan,
    )

    with pytest.raises(NotImplementedError, match="shared memory"):
        variant_launch_plan(2, 100, A, 3, "tanh", int8_taps)
    with pytest.raises(ValueError, match="gate"):
        variant_launch_plan(2, 100, 80, 3, "relu", int8_taps)


def test_int8_operand_layout_unpacks_to_the_quantised_operands():
    """The int8 body's operands as the kernel reads them, emulated on the
    CPU: the wrapper's weight words (four consecutive contraction rows of
    one column a word) unpack to quantize_taps' matrix, and __dp4a over
    those words and the staged window words (four consecutive channels of
    one row a word, quantised as the kernel quantises them) gives the
    plain version's int32 tap sums xq . Wq."""
    from parallelwavegan_torch.ops.cuda.wavenet_variant import (
        int8_tap_layout,
        quantize_words,
    )

    rng = np.random.default_rng(3)
    w_tap = torch.from_numpy(
        (rng.standard_normal((2, 3 * KR, KG)) * 0.08).astype(np.float32))
    w_q, s_tap = quantize_taps(w_tap, 3.0)
    words = int8_tap_layout(w_q)
    assert words.shape == (2, 3 * KR // 4, KG, 4) and words.is_contiguous()
    unpacked = words.permute(0, 1, 3, 2).reshape(2, 3 * KR, KG)
    assert torch.equal(unpacked, w_q)
    xcat = torch.from_numpy(
        (rng.standard_normal((5, 3 * KR)) * 1.5).astype(np.float32))
    for layer in range(2):
        s = float(s_tap[layer, 0])
        a_words = quantize_words(xcat, s).numpy().view(np.int8).reshape(
            5, 3 * KR // 4, 4)
        w_words = words[layer].numpy()  # (k4, n, byte)
        dp4a = np.einsum("rki,kni->rn", a_words.astype(np.int64),
                         w_words.astype(np.int64))
        xq = torch.clamp(torch.round(xcat * torch.tensor(s)), -127, 127)
        want = (xq.double() @ w_q[layer].double()).numpy()
        np.testing.assert_array_equal(dp4a, want)


@pytest.mark.parametrize("scale", [127 / 4.0, 127 / 3.3, 1.0])
def test_quantiser_arithmetic_is_the_plain_quantiser(scale):
    """The int8 body's pinned quantiser, v s rounded to f32, rint (half to
    even), clipped to +-127, byte by byte low first, is the plain
    quantiser's clip(round_half_even(x s), +-127), on every half-integer
    border of x s, past +-127 and on random values, f32 and bf16 inputs
    alike."""
    from parallelwavegan_torch.ops.cuda.wavenet_variant import (
        quantize_words,
        quantize_words_reference,
    )

    rng = np.random.default_rng(4)
    borders = (np.arange(-1200, 1200) / 8).astype(np.float32) / np.float32(
        scale)
    values = np.concatenate([borders, rng.standard_normal(4000).astype(
        np.float32) * 5]).reshape(-1, 4)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(values).to(dtype)
        want = quantize_words_reference(x, scale)
        assert torch.equal(quantize_words(x, scale), want)  # CPU: plain
        v = x.float().numpy() * np.float32(scale)
        q = np.clip(np.rint(v), -127, 127).astype(np.int8).view(np.uint8)
        words = (q[:, 0].astype(np.uint32) | q[:, 1].astype(np.uint32) << 8
                 | q[:, 2].astype(np.uint32) << 16
                 | q[:, 3].astype(np.uint32) << 24)
        np.testing.assert_array_equal(words.view(np.int32),
                                      want.numpy().reshape(-1))
