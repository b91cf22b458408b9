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
