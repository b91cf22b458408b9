"""The port's trainable WaveNet stack on the CPU (plain version: autograd
through the plain forward; the backward kernel's explicit plain version)
against the JAX package: the Pallas backward kernel in interpret mode,
``jax.grad`` of the XLA reference, and the flax generator's gradients with
respect to kernel_v / kernel_g. The CUDA kernels against the plain version
are in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelwavegan_tpu.models import (
    ParallelWaveGANGenerator as FlaxGenerator,
)
from parallelwavegan_tpu.ops.pallas.pwg_infer import (
    pwg_fused_forward as jax_pwg_fused_forward,
)
from parallelwavegan_tpu.ops.pallas.wavenet_stack import (
    wavenet_stack_reference as jax_wavenet_stack_reference,
)
from parallelwavegan_tpu.ops.pallas.wavenet_stack_train import (
    wavenet_stack_train as jax_wavenet_stack_train,
)
from parallelwavegan_torch.models import ParallelWaveGANGenerator
from parallelwavegan_torch.ops.cuda.pwg_infer import pwg_fused_forward
from parallelwavegan_torch.ops.cuda.wavenet_stack import (
    wavenet_stack,
    wavenet_stack_reference,
)
from parallelwavegan_torch.ops.cuda.wavenet_stack_train import (
    wavenet_stack_backward,
    wavenet_stack_backward_reference,
    wavenet_stack_train,
    wavenet_stack_train_reference,
)
from parallelwavegan_torch.utils.params import (
    convert_jax_params,
    folded_state_dict,
)
from tests.torch_helpers import flax_generator_kwargs

torch.set_num_threads(2)

L, R, G, A, S = 4, 16, 32, 12, 16
DILS = (1, 2, 4, 1)


def _stack_case(seed, B=2, T=300):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    w = {
        "w_tap": rng.standard_normal((L, 3, R, G)) * 0.2,
        "b_tap": rng.standard_normal((L, G)) * 0.1,
        "w_aux": rng.standard_normal((L, A, G)) * 0.2,
        "w_so": rng.standard_normal((L, R, S + R)) * 0.2,
        "b_so": rng.standard_normal((L, S + R)) * 0.1,
    }
    w = {k: v.astype(f32) for k, v in w.items()}
    x = rng.standard_normal((B, T, R)).astype(f32)
    c = rng.standard_normal((B, T, A)).astype(f32)
    # random output weighting exercises both outputs' cotangents
    ux = rng.standard_normal((B, T, R)).astype(f32)
    us = rng.standard_normal((B, T, S)).astype(f32)
    return x, c, w, ux, us


def _torch_grads(fn, x, c, w, ux, us):
    xt = torch.from_numpy(x).requires_grad_()
    ct = torch.from_numpy(c).requires_grad_()
    wt = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    xo, sk = fn(xt, ct, wt, DILS)
    loss = (xo * torch.from_numpy(ux)).sum() + (sk * torch.from_numpy(us)).sum()
    grads = torch.autograd.grad(loss, [xt, ct] + [wt[k] for k in w])
    out = dict(zip(["dx", "dc"] + list(w), (g.numpy() for g in grads)))
    return loss.item(), out


def _jax_grads(fn, x, c, w, ux, us):
    def loss(x, c, w):
        xo, sk = fn(x, c, w)
        return jnp.sum(xo * ux) + jnp.sum(sk * us)

    v, (dx, dc, dw) = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(c), {k: jnp.asarray(a) for k, a in w.items()}
    )
    out = {"dx": dx, "dc": dc, **dw}
    return float(v), {k: np.asarray(a) for k, a in out.items()}


def _assert_grads_close(got, want, tol):
    """|a - b| <= tol * (1 + max |b|), for every gradient."""
    assert sorted(got) == sorted(want)
    for key, b in want.items():
        err = np.abs(got[key] - b).max()
        assert err <= tol * (1 + np.abs(b).max()), (key, err)


def test_plain_backward_matches_jax_grad_of_reference():
    """f32, same sums in another order: 1e-5 relative to the largest
    entry on dx, dc and every weight gradient."""
    case = _stack_case(1)
    v, got = _torch_grads(wavenet_stack_train, *case)
    v_ref, want = _jax_grads(
        lambda x, c, w: jax_wavenet_stack_reference(x, c, w, DILS), *case)
    np.testing.assert_allclose(v, v_ref, rtol=1e-5)
    _assert_grads_close(got, want, 1e-5)


def test_plain_backward_matches_pallas_backward_kernel():
    """Against the TPU backward kernel in interpret mode. The weight
    gradients there are sums of per-window partials (3 windows of 128 + 2
    halos of 128 rows), hence 2e-5 where the reference holds 1e-5."""
    case = _stack_case(2)
    v, got = _torch_grads(wavenet_stack_train_reference, *case)
    v_ker, want = _jax_grads(
        lambda x, c, w: jax_wavenet_stack_train(x, c, w, DILS, 128, True),
        *case)
    np.testing.assert_allclose(v, v_ker, rtol=1e-5)
    _assert_grads_close(got, want, 2e-5)


# one dilation above the CUDA data launch's 64-row halo, where each tap
# takes its own window
DILS_BWD = (1, 2, 130, 1)


def _explicit_grads(x, c, w, ux, us, dtype):
    """dx, dc and the weight gradients of sum(x_out ux) + sum(skip us)
    through the plain forward with saved inputs and the explicit plain
    backward, in ``dtype``; x_out's cotangent in the type of x_out, as
    autograd hands it over."""
    def t(a):
        return torch.from_numpy(a).to(dtype)

    wt = {k: t(v) for k, v in w.items()}
    _, _, xs = wavenet_stack(t(x), t(c), wt, DILS_BWD, save_inputs=True)
    dx, dc, dw = wavenet_stack_backward_reference(
        xs, t(c), wt, DILS_BWD, t(ux), torch.from_numpy(us))
    assert dx.dtype == dc.dtype == dtype
    assert all(v.dtype == dtype for v in dw.values())
    out = {"dx": dx, "dc": dc, **dw}
    return {k: v.float().numpy() for k, v in out.items()}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_explicit_backward_matches_pallas_backward_kernel(dtype, tol):
    """The backward kernel's explicit plain version against the TPU
    backward kernel in interpret mode, on the same numpy inputs (cast to
    bf16 for bf16). f32: 2e-5 as the autograd path holds; bf16: both round
    dso, dz and g where the TPU kernel does, and their forwards may round
    an input of a later layer the other way (one bf16 step), hence bf16's
    2e-2, relative to each gradient's largest entry."""
    x, c, w, ux, us = _stack_case(5)
    got = _explicit_grads(x, c, w, ux, us, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def loss(x, c, w):
        xo, sk = jax_wavenet_stack_train(x, c, w, DILS_BWD, 128, True)
        return jnp.sum(xo.astype(jnp.float32) * ux) + jnp.sum(sk * us)

    dx, dc, dw = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x, jdt), jnp.asarray(c, jdt),
        {k: jnp.asarray(v, jdt) for k, v in w.items()})
    want = {k: np.asarray(v, np.float32)
            for k, v in {"dx": dx, "dc": dc, **dw}.items()}
    _assert_grads_close(got, want, tol)


def test_explicit_backward_matches_autograd_through_plain_forward():
    """f32: the explicit plain backward is the plain forward's gradient, to
    1e-5 of each gradient's largest entry (the same sums in another
    order)."""
    x, c, w, ux, us = _stack_case(6)
    got = _explicit_grads(x, c, w, ux, us, torch.float32)
    xt = torch.from_numpy(x).requires_grad_()
    ct = torch.from_numpy(c).requires_grad_()
    wt = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    xo, sk = wavenet_stack_train_reference(xt, ct, wt, DILS_BWD)
    loss = ((xo * torch.from_numpy(ux)).sum()
            + (sk * torch.from_numpy(us)).sum())
    grads = torch.autograd.grad(loss, [xt, ct] + [wt[k] for k in w])
    want = dict(zip(["dx", "dc"] + list(w), (g.numpy() for g in grads)))
    _assert_grads_close(got, want, 1e-5)


def test_plain_forward_saves_the_inputs_each_tap_product_consumed():
    x, c, w, _, _ = _stack_case(3, B=1, T=90)
    wt = {k: torch.from_numpy(v) for k, v in w.items()}
    xo, sk, xs = wavenet_stack(torch.from_numpy(x), torch.from_numpy(c), wt,
                               DILS, save_inputs=True)
    assert tuple(xs.shape) == (L, 1, 90, R) and xs.dtype == torch.float32
    xo2, sk2 = wavenet_stack_reference(torch.from_numpy(x),
                                       torch.from_numpy(c), wt, DILS)
    assert torch.equal(xo, xo2) and torch.equal(sk, sk2)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    assert torch.equal(xs[0], torch.from_numpy(x))
    for i in range(1, L):
        x_i, _ = jax_wavenet_stack_reference(
            jnp.asarray(x), jnp.asarray(c),
            {k: v[:i] for k, v in jw.items()}, DILS[:i])
        np.testing.assert_allclose(xs[i].numpy(), np.asarray(x_i), atol=2e-5)
    # bf16: stored in the matmul dtype, as the tap product rounds them
    wb = {k: v.to(torch.bfloat16) for k, v in wt.items()}
    _, _, xs16 = wavenet_stack(torch.from_numpy(x).to(torch.bfloat16),
                               torch.from_numpy(c).to(torch.bfloat16), wb,
                               DILS, save_inputs=True)
    assert xs16.dtype == torch.bfloat16 and tuple(xs16.shape) == (L, 1, 90, R)


def _flax_and_port(kwargs, seed, B, frames):
    g = FlaxGenerator(**kwargs)
    rng = np.random.default_rng(seed)
    ctx = kwargs["aux_context_window"]
    c = rng.standard_normal((B, frames + 2 * ctx, kwargs["aux_channels"]))
    z = rng.standard_normal((B, frames * g.upsample_factor, 1))
    u = rng.standard_normal((B, frames * g.upsample_factor, 1))
    c, z, u = (a.astype(np.float32) for a in (c, z, u))
    v = g.init({"params": jax.random.key(seed)}, jnp.asarray(z[:1]),
               jnp.asarray(c[:1]))
    # perturb: weight-norm g starts at ||v|| and biases at zero
    v = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) * (1 + 0.3 * rng.standard_normal(
            a.shape)) + 0.05 * rng.standard_normal(a.shape), a.dtype), v)
    port = ParallelWaveGANGenerator(**kwargs, folded=False)
    port.load_state_dict(
        convert_jax_params(jax.tree.map(np.asarray, v["params"]), fold=False),
        strict=True)
    return g, v, port, c, z, u


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_layer"])
def test_trainable_forward_and_grads_match_flax(fused):
    """Forward and the gradients with respect to every kernel_v, kernel_g
    and bias against flax's, f32: 1e-4 on the output as the forward tests
    hold, 2e-5 relative to the largest entry on each gradient."""
    kwargs = flax_generator_kwargs(layers=6, stacks=2)
    g, v, port, c, z, u = _flax_and_port(kwargs, 0, B=2, frames=30)
    v_ref, g_ref = jax.value_and_grad(
        lambda v: jnp.sum(g.apply(v, jnp.asarray(z), jnp.asarray(c)) * u))(v)
    names = [n for n, _ in port.named_parameters()]
    assert any(n.endswith("kernel_v") for n in names)
    assert not any(n.endswith(".kernel") for n in names)
    y = port(torch.from_numpy(z), torch.from_numpy(c), fused=fused,
             trainable=fused)
    loss = (y * torch.from_numpy(u)).sum()
    grads = torch.autograd.grad(loss, list(port.parameters()),
                                allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(v_ref), rtol=1e-4)
    want = convert_jax_params(jax.tree.map(np.asarray, g_ref["params"]),
                              fold=False)
    assert sorted(want) == sorted(names)
    for name, grad in zip(names, grads):
        b = want[name].numpy()
        if grad is None:  # the last layer's residual 1x1 feeds nothing
            assert "conv1x1_out" in name and not b.any(), name
            continue
        err = np.abs(grad.numpy() - b).max()
        assert err <= 2e-5 * (1 + np.abs(b).max()), (name, err)


def test_trainable_forward_groups_layers_like_the_jax_training_path():
    """In bf16 the residual is rounded at each group's end, so the
    trainable path (groups of layers // stacks) and the serving path (one
    call) differ; the port's trainable path follows the JAX one (Pallas in
    interpret mode) to bf16 rounding flips (3e-2 as the bf16 stack test),
    and on the CPU it takes the same groups with or without autograd."""
    kwargs = flax_generator_kwargs(layers=6, stacks=2)
    g, v, port, c, z, _ = _flax_and_port(kwargs, 1, B=1, frames=24)
    bf16 = jnp.bfloat16
    v16 = jax.tree.map(lambda a: a.astype(bf16), v)
    y_ref = jax_pwg_fused_forward(g, v16, jnp.asarray(z, bf16),
                                  jnp.asarray(c, bf16), trainable=True,
                                  chunk=128, interpret=True)
    port16 = port.to(torch.bfloat16)
    zt = torch.from_numpy(z).to(torch.bfloat16)
    ct = torch.from_numpy(c).to(torch.bfloat16)
    y = pwg_fused_forward(port16, zt, ct, trainable=True)
    with torch.no_grad():
        y_no_grad = pwg_fused_forward(port16, zt, ct, trainable=True)
        y_serving = pwg_fused_forward(port16, zt, ct)
    assert y.dtype == torch.bfloat16 and y.requires_grad
    assert torch.equal(y.detach(), y_no_grad)
    assert not torch.equal(y_no_grad, y_serving)
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(y_ref, np.float32), atol=3e-2)


def test_folded_form_of_a_trainable_module_serves_the_same_function():
    kwargs = flax_generator_kwargs(layers=4, stacks=2)
    _, _, port, c, z, _ = _flax_and_port(kwargs, 2, B=1, frames=10)
    folded = ParallelWaveGANGenerator(**kwargs)
    state = folded_state_dict(port)
    assert sorted(state) == sorted(folded.state_dict())
    folded.load_state_dict(state, strict=True)
    assert folded_state_dict(folded).keys() == state.keys()
    with torch.no_grad():
        y = port(torch.from_numpy(z), torch.from_numpy(c))
        y_folded = folded(torch.from_numpy(z), torch.from_numpy(c))
    np.testing.assert_allclose(y_folded.numpy(), y.numpy(), atol=1e-6)


def test_trainable_wrappers_reject_other_devices():
    x = torch.zeros((1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        wavenet_stack_train(x, x, {k: x for k in (
            "w_tap", "b_tap", "w_aux", "w_so", "b_so")}, (1,))
    xs = torch.zeros((1, 1, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        wavenet_stack_backward(xs, xs[0], {}, (1,), xs[0], xs[0])
