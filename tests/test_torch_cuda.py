"""The port's CUDA kernels on the card, against their plain versions.

Imports neither JAX nor the JAX package, so it runs on a GPU machine
without them; there, run it without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py

Without a GPU every test here skips.
"""

import numpy as np
import pytest
import torch

from parallelwavegan_torch.engine.build import (
    example_batch,
    init_train_state,
)
from parallelwavegan_torch.engine.checkpoint import save_generator_checkpoint
from parallelwavegan_torch.engine.criterion import build_criterion
from parallelwavegan_torch.engine.step import build_steps
from parallelwavegan_torch.models import ParallelWaveGANGenerator
from parallelwavegan_torch.ops.cuda.wavenet_stack import (
    wavenet_stack,
    wavenet_stack_reference,
)
from parallelwavegan_torch.ops.cuda.wavenet_stack_train import (
    wavenet_stack_backward,
    wavenet_stack_train,
    wavenet_stack_train_reference,
)
from parallelwavegan_torch.utils.model_loader import load_model

# self-contained (no tests.* import): on the GPU machine another installed
# package may own the name "tests"
PWG_V1_KWARGS = dict(
    layers=30, stacks=3, residual_channels=64, gate_channels=128,
    skip_channels=64, aux_channels=80, aux_context_window=2,
    upsample_params={"upsample_scales": [4, 4, 4, 4]},
)

# kernel vs plain: |a - b| <= tol * (1 + max |b|); bf16 admits one-ulp
# rounding flips of x and g where the two sum in another order
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    """The first GPU; skips where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda", 0)


def _stack_inputs(rng, B, T, L, dtype, dev, R=64, G=128, A=80, S=64):
    def t(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev, dtype)

    w = {"w_tap": t(L, 3, R, G, scale=0.1), "b_tap": t(L, G, scale=0.1),
         "w_aux": t(L, A, G, scale=0.1), "w_so": t(L, R, S + R, scale=0.1),
         "b_so": t(L, S + R, scale=0.1)}
    return t(B, T, R), t(B, T, A), w


def _assert_close(a, b, dtype):
    a, b = a.float(), b.float()
    assert torch.isfinite(a).all()
    err = (a - b).abs().max().item()
    assert err <= TOL[dtype] * (1 + b.abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,L", [(2, 1000, 6), (3, 300, 30), (1, 77, 1),
                                   (2, 130, 2)])
def test_stack_kernel_matches_plain(cuda_device, dtype, B, T, L):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    dils = tuple(2 ** (i % 10) for i in range(L))
    x, c, w = _stack_inputs(rng, B, T, L, dtype, cuda_device)
    before = wavenet_stack.launches
    xo, sk = wavenet_stack(x, c, w, dils)
    torch.cuda.synchronize()
    assert wavenet_stack.launches == before + L
    assert xo.dtype == dtype and sk.dtype == torch.float32
    xo_p, sk_p = wavenet_stack_reference(x, c, w, dils)
    _assert_close(xo, xo_p, dtype)
    _assert_close(sk, sk_p, dtype)


@pytest.mark.cuda
def test_stack_kernel_rejects_what_it_was_not_built_for(cuda_device):
    rng = np.random.default_rng(1)
    x, c, w = _stack_inputs(rng, 1, 64, 2, torch.float32, cuda_device)
    with pytest.raises(NotImplementedError, match="channels"):
        wavenet_stack(x[..., :32].contiguous(), c, w, (1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        wavenet_stack(x, torch.cat([c, c], -1)[..., :80], w, (1, 2))
    with pytest.raises(TypeError, match="bfloat16"):
        wavenet_stack(x, c.to(torch.bfloat16), w, (1, 2))


@pytest.mark.cuda
def test_inference_model_on_card_uses_kernel(tmp_path, cuda_device):
    """PWG v1 widths: synthesize_batch goes through the stack kernel
    (30 launches) and matches the unfused generator in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = {"generator_type": "ParallelWaveGANGenerator",
              "generator_params": PWG_V1_KWARGS}
    path = str(tmp_path / "g.gckpt")
    save_generator_checkpoint(path, ParallelWaveGANGenerator(
        **PWG_V1_KWARGS, generator=torch.Generator().manual_seed(0)))
    model = load_model(path, config, device=cuda_device)
    assert model.stack_params is not None
    rng = np.random.default_rng(2)
    mels = [rng.standard_normal((n, 80)).astype(np.float32) for n in (9, 14)]
    fn, (c, z), _ = model.prepare_batch(mels, bucket_size=8)
    before = wavenet_stack.launches
    y = fn(c, z)
    assert wavenet_stack.launches == before + 30
    with torch.inference_mode():
        y_plain = model.generator(z, c)
    _assert_close(y, y_plain, torch.float32)
    waves = model.synthesize_batch(mels, bucket_size=8)
    assert [w.shape for w in waves] == [(9 * 256, 1), (14 * 256, 1)]


@pytest.mark.cuda
def test_inference_model_on_card_rejects_what_the_kernel_lacks(tmp_path,
                                                               cuda_device):
    """No plain fallback on the card: other widths or kernel sizes raise."""
    for override, match in (({"kernel_size": 5}, "kernel_size=5"),
                            ({"residual_channels": 32}, "channels")):
        kwargs = dict(PWG_V1_KWARGS, layers=3, **override)
        config = {"generator_type": "ParallelWaveGANGenerator",
                  "generator_params": kwargs}
        path = str(tmp_path / "g.gckpt")
        save_generator_checkpoint(path, ParallelWaveGANGenerator(
            **kwargs, generator=torch.Generator().manual_seed(0)))
        with pytest.raises(NotImplementedError, match=match):
            load_model(path, config, device=cuda_device)


def _stack_grads(fn, x, c, w, dils, ux, us):
    x = x.detach().requires_grad_()
    c = c.detach().requires_grad_()
    w = {k: v.detach().requires_grad_() for k, v in w.items()}
    xo, sk = fn(x, c, w, dils)
    loss = (xo.float() * ux).sum() + (sk * us).sum()
    names = list(w)
    grads = torch.autograd.grad(loss, [x, c] + [w[k] for k in names])
    return dict(zip(["dx", "dc"] + names, grads))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,L", [(2, 1000, 6), (3, 300, 10), (1, 77, 1),
                                   (2, 130, 2)])
def test_backward_kernel_matches_plain(cuda_device, dtype, B, T, L):
    """Saved inputs and every gradient (dx, dc, five weight gradients)
    against autograd through the plain forward. The weight gradients are
    sums over B*T rows in another order; relative to their largest entry
    they stay inside the elementwise tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    dils = tuple(2 ** (i % 10) for i in range(L))
    x, c, w = _stack_inputs(rng, B, T, L, dtype, cuda_device)
    xo, sk, xs = wavenet_stack(x, c, w, dils, save_inputs=True)
    xo_p, sk_p, xs_p = wavenet_stack_reference(x, c, w, dils,
                                               save_inputs=True)
    assert xs.dtype == dtype and tuple(xs.shape) == (L, B, T, 64)
    for a, b in ((xo, xo_p), (sk, sk_p), (xs, xs_p)):
        _assert_close(a, b, dtype)
    ux = torch.from_numpy(rng.standard_normal((B, T, 64)).astype(
        np.float32)).to(cuda_device)
    us = torch.from_numpy(rng.standard_normal((B, T, 64)).astype(
        np.float32)).to(cuda_device)
    fwd, bwd = wavenet_stack.launches, wavenet_stack_backward.launches
    got = _stack_grads(wavenet_stack_train, x, c, w, dils, ux, us)
    torch.cuda.synchronize()
    assert wavenet_stack.launches == fwd + L
    assert wavenet_stack_backward.launches == bwd + L
    want = _stack_grads(wavenet_stack_train_reference, x, c, w, dils, ux, us)
    for key in want:
        assert got[key].dtype == want[key].dtype == dtype, key
        _assert_close(got[key], want[key], dtype)


@pytest.mark.cuda
def test_backward_kernel_is_deterministic_and_skipped_without_grad(
        cuda_device):
    rng = np.random.default_rng(4)
    dils = (1, 2, 4, 8)
    x, c, w = _stack_inputs(rng, 2, 700, 4, torch.float32, cuda_device)
    ux, us = torch.ones_like(x), torch.ones((2, 700, 64), device=cuda_device)
    a = _stack_grads(wavenet_stack_train, x, c, w, dils, ux, us)
    b = _stack_grads(wavenet_stack_train, x, c, w, dils, ux, us)
    for key in a:
        assert torch.equal(a[key], b[key]), key  # no atomics
    bwd = wavenet_stack_backward.launches
    with torch.no_grad():
        xo, sk = wavenet_stack_train(x.requires_grad_(), c, w, dils)
    assert not xo.requires_grad and wavenet_stack_backward.launches == bwd
    with pytest.raises(ValueError, match="CUDA"):
        wavenet_stack_backward(x.cpu()[None], c.cpu(), w, (1,), x.cpu(),
                               x.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "mixed"])
def test_train_step_on_card_goes_through_both_kernels(cuda_device, mixed):
    """PWG v1 widths at 6 layers: a G+adv+D step launches the forward
    kernel once per layer with gradients and once for the recomputed
    prediction, the backward kernel once per layer, and its losses agree
    with the per-layer forward (fused_wavenet: false) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = {
        "hop_size": 256, "batch_max_steps": 2560, "mixed_precision": mixed,
        "generator_params": dict(PWG_V1_KWARGS, layers=6, stacks=3),
        "discriminator_params": {"layers": 4, "conv_channels": 16},
        "stft_loss_params": {"fft_sizes": [256, 512], "hop_sizes": [64, 128],
                             "win_lengths": [128, 256]},
        "generator_grad_norm": 10, "discriminator_grad_norm": 1,
    }
    batch = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in example_batch(config, batch_size=2).items()}
    losses = {}
    for fused in (True, False):
        cfg = dict(config, fused_wavenet=fused)
        state, gen, dis, opt_g, opt_d = init_train_state(cfg, seed=0,
                                                         device=cuda_device)
        factory, _ = build_steps(cfg, gen, dis, build_criterion(cfg), opt_g,
                                 opt_d)
        fwd, bwd = wavenet_stack.launches, wavenet_stack_backward.launches
        before = {k: v.detach().clone() for k, v in state.params_g.items()}
        _, losses[fused] = factory(True, True, True)(state, batch)
        torch.cuda.synchronize()
        assert wavenet_stack.launches - fwd == (12 if fused else 0)
        assert wavenet_stack_backward.launches - bwd == (6 if fused else 0)
        moved = sum(not torch.equal(p, before[k])
                    for k, p in state.params_g.items())
        # the last layer's residual 1x1 (v, g, bias) feeds nothing, and
        # first_conv's kernel_v has a zero gradient but for rounding
        assert moved >= len(before) - 4
    tol = 5e-2 if mixed else 1e-4
    for key, value in losses[True].items():
        assert torch.isfinite(value)
        np.testing.assert_allclose(value.item(), losses[False][key].item(),
                                   rtol=tol, err_msg=key)
