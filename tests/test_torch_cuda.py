"""The port's CUDA kernels on the card, against their plain versions.

Imports neither JAX nor the JAX package, so it runs on a GPU machine
without them; there, run it without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py

Without a GPU every test here skips.
"""

import copy
import hashlib

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
from parallelwavegan_torch.models import (
    HiFiGANGenerator,
    ParallelWaveGANGenerator,
)
from parallelwavegan_torch.ops.cuda.matmul_bench import (
    matmul_bench,
    matmul_bench_reference,
)
from parallelwavegan_torch.ops.cuda.mrf_stage import (
    build_stage_pack,
    mrf_stage,
    mrf_stage_plan,
    mrf_stage_reference,
)
from parallelwavegan_torch.ops.hifigan_infer import hifigan_fast_forward
from parallelwavegan_torch.ops.cuda.wavenet_stack import (
    wavenet_stack,
    wavenet_stack_reference,
)
from parallelwavegan_torch.ops.cuda.wavenet_variant import (
    _library as variant_library,
    quantize_taps,
    quantize_words,
    quantize_words_reference,
    variant_launch_plan,
    variant_smem_bytes,
    variant_stack,
    variant_stack_reference,
)
from parallelwavegan_torch.ops.cuda.wavenet_stack_train import (
    _library as backward_library,
    backward_launch_plan,
    backward_smem_bytes,
    wavenet_stack_backward,
    wavenet_stack_backward_reference,
    wavenet_stack_train,
    wavenet_stack_train_reference,
)
from parallelwavegan_torch.tools.float64_check import hold_to_float64
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


# the tensor-core bodies' edges: T not a multiple of the 64-row tile, T below
# one tile, d >= T, (512, 1), L = 1 and L = 2 (both ping-pong buffers
# unused / one used), B = 1, the halo'd window (d < 64) and the separate
# windows (d >= 64) in one stack
_TC_CASES = [
    (3, 1000, (1, 2, 4)), (1, 40, (1,)), (2, 50, (64, 2)), (1, 130, (512, 1)),
    (2, 64, (1,)), (2, 300, (1, 2)), (1, 4133, (1, 32, 63, 64, 65, 512)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("B,T,dils", _TC_CASES)
def test_stack_tensor_core_body_matches_plain(cuda_device, B, T, dils, dtype):
    """x, skip and the saved inputs against the plain version (bf16 on the
    tensor-core body, f32 on the split-TF32 body), then the backward kernel
    on those saved inputs against autograd through the plain forward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(8)
    x, c, w = _stack_inputs(rng, B, T, len(dils), dtype, cuda_device)
    before = wavenet_stack.launches
    got = wavenet_stack(x, c, w, dils, save_inputs=True)
    torch.cuda.synchronize()
    assert wavenet_stack.launches == before + len(dils)
    want = wavenet_stack_reference(x, c, w, dils, save_inputs=True)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        _assert_close(a, b, dtype)
    ux = torch.from_numpy(rng.standard_normal((B, T, 64)).astype(
        np.float32)).to(cuda_device)
    us = torch.from_numpy(rng.standard_normal((B, T, 64)).astype(
        np.float32)).to(cuda_device)
    grads = _stack_grads(wavenet_stack_train, x, c, w, dils, ux, us)
    torch.cuda.synchronize()
    plain = _stack_grads(wavenet_stack_train_reference, x, c, w, dils, ux, us)
    for key in plain:
        _assert_close(grads[key], plain[key], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("A", [16, 36, 80], ids=["A16", "A36", "A80"])
def test_stack_tensor_core_body_aux_widths(cuda_device, A, dtype):
    """c rows staged in 16-byte pieces (A a multiple of 8) or in 8-byte
    pieces (A = 36), aux channels padded to the mma depth of 16 (bf16); c
    in 4-channel pieces and a last chunk of the gate contraction cut short
    (f32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(9)
    x, c, w = _stack_inputs(rng, 2, 333, 3, dtype, cuda_device, A=A)
    got = wavenet_stack(x, c, w, (1, 64, 2))
    torch.cuda.synchronize()
    want = wavenet_stack_reference(x, c, w, (1, 64, 2))
    for a, b in zip(got, want):
        _assert_close(a, b, dtype)


@pytest.mark.cuda
def test_stack_f32_saves_each_layer_input_and_is_deterministic(cuda_device):
    """In f32, xs is bit-equal to each layer's input (the input itself,
    then the output of the layers before it), and two calls give bit-equal
    outputs."""
    rng = np.random.default_rng(10)
    dils = (1, 64, 2, 512)
    x, c, w = _stack_inputs(rng, 2, 1000, len(dils), torch.float32,
                            cuda_device)
    got = wavenet_stack(x, c, w, dils, save_inputs=True)
    again = wavenet_stack(x, c, w, dils, save_inputs=True)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    xs = got[2]
    assert torch.equal(xs[0], x)
    for n in range(1, len(dils)):
        head = {k: v[:n].contiguous() for k, v in w.items()}
        assert torch.equal(xs[n], wavenet_stack(x, c, head, dils[:n])[0]), n


@pytest.mark.cuda
def test_stack_launch_plan_matches_the_kernel(cuda_device):
    """The wrapper's shared-memory counts are the kernel's own, and fit."""
    from parallelwavegan_torch.ops.cuda.wavenet_stack import (
        _library,
        stack_launch_plan,
        tc_smem_bytes,
        tf32_smem_bytes,
    )

    lib = _library()
    for A in (16, 80, 96):
        for is_bf16, dtype in ((1, torch.bfloat16), (0, torch.float32)):
            assert lib.pwg_wavenet_stack_tc_smem(is_bf16, A) == \
                tc_smem_bytes(A, dtype)
    assert lib.pwg_wavenet_stack_tf32_smem() == tf32_smem_bytes()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = stack_launch_plan(32, 131072, 80, 30, torch.bfloat16, sms)
    assert plan["smem"] <= 232448 and plan["blocks"] == sms
    plan = stack_launch_plan(32, 131072, 80, 30, torch.float32, sms)
    assert plan["body"] == "tensor_cores_tf32x3"
    assert plan["smem"] == lib.pwg_wavenet_stack_tf32_smem() <= 232448


# sha256 of (x_out as its bf16 bits, skip) of the bf16 tensor-core body on
# _stack_inputs(np.random.default_rng(5), ...): the outputs of the body
# before it became the template of csrc/wavenet_tc_layer.cuh that the
# variant kernel shares (taken on an NVIDIA H100 80GB HBM3)
_TC_BODY_DIGESTS = {
    "first_middle_last":
        "41ece1dc2ff993d674e097b19dd43e499aa905f3eeb924e18e279c2f24ed18e2",
    "one_layer":
        "a5f310fff14fbc4f84a63f637e5f7d4f621e3651fdd1d372c4f870204f2aa590",
}


@pytest.mark.cuda
@pytest.mark.parametrize("case,B,T,dils", [
    ("first_middle_last", 2, 777, (1, 64, 3, 512)),
    ("one_layer", 1, 4133, (2,))], ids=["first_middle_last", "one_layer"])
def test_stack_tc_body_is_bit_equal_to_its_output_before_the_template(
        cuda_device, case, B, T, dils):
    """The serving kernel's instantiation of the shared layer body gives
    the same bits as the body did before it was shared."""
    x, c, w = _stack_inputs(np.random.default_rng(5), B, T, len(dils),
                            torch.bfloat16, cuda_device)
    xo, sk = wavenet_stack(x, c, w, dils)
    digest = hashlib.sha256(xo.view(torch.int16).cpu().numpy().tobytes()
                            + sk.cpu().numpy().tobytes()).hexdigest()
    assert digest == _TC_BODY_DIGESTS[case]


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
def test_inference_model_on_card_honours_fused_false(tmp_path, cuda_device):
    """inference_fused_wavenet: false serves gen(z, c) on the card too: no
    stack weights, no wavenet_stack launch, the fused forward's output."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kwargs = dict(PWG_V1_KWARGS, layers=6, stacks=2)
    config = {"generator_type": "ParallelWaveGANGenerator",
              "generator_params": kwargs}
    path = str(tmp_path / "g.gckpt")
    save_generator_checkpoint(path, ParallelWaveGANGenerator(
        **kwargs, generator=torch.Generator().manual_seed(0)))
    plain = load_model(path, dict(config, inference_fused_wavenet=False),
                       device=cuda_device)
    fused = load_model(path, config, device=cuda_device)
    assert plain.stack_params is None and fused.stack_params is not None
    mels = [np.random.default_rng(3).standard_normal((12, 80)).astype(
        np.float32)]
    fn, (c, z), _ = plain.prepare_batch(mels, bucket_size=4)
    before = wavenet_stack.launches
    y = fn(c, z)
    torch.cuda.synchronize()
    assert wavenet_stack.launches == before
    fn_f, _, _ = fused.prepare_batch(mels, bucket_size=4)
    y_f = fn_f(c, z)
    assert wavenet_stack.launches == before + 6
    _assert_close(y, y_f, torch.float32)


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


@pytest.mark.cuda
@pytest.mark.parametrize("override,match", [
    ({"use_causal_conv": True}, "use_causal_conv=True"),
    ({"dropout": 0.1}, "dropout=0.1"),
], ids=["causal", "dropout"])
def test_fused_paths_on_card_refuse_causal_and_dropout(tmp_path, cuda_device,
                                                       override, match):
    """Causal and dropout generators have no fused path: on the card
    ``InferenceModel`` and the train step refuse them, naming the setting
    that selects the per-layer path, and serve and train with it."""
    from parallelwavegan_torch.engine.step import (
        DROPOUT_STREAM,
        step_generator,
    )

    kwargs = dict(PWG_V1_KWARGS, layers=3, **override)
    config = {"generator_type": "ParallelWaveGANGenerator",
              "generator_params": kwargs, "hop_size": 256,
              "batch_max_steps": 2560,
              "discriminator_params": {"layers": 4, "conv_channels": 16},
              "stft_loss_params": {"fft_sizes": [256], "hop_sizes": [64],
                                   "win_lengths": [128]}}
    path = str(tmp_path / "g.gckpt")
    save_generator_checkpoint(path, ParallelWaveGANGenerator(
        **kwargs, generator=torch.Generator().manual_seed(0)))
    with pytest.raises(NotImplementedError,
                       match=f"{match}.*inference_fused_wavenet: false"):
        load_model(path, config, device=cuda_device)
    wave = load_model(path, dict(config, inference_fused_wavenet=False),
                      device=cuda_device).inference(
        np.zeros((7, 80), np.float32))
    assert wave.shape == (7 * 256, 1) and np.isfinite(wave).all()
    batch = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in example_batch(config, batch_size=2).items()}
    for fused in (True, False):
        cfg = dict(config, fused_wavenet=fused)
        state, gen, dis, opt_g, opt_d = init_train_state(cfg, seed=0,
                                                         device=cuda_device)
        if fused:
            with pytest.raises(NotImplementedError,
                               match=f"{match}.*fused_wavenet: false"):
                build_steps(cfg, gen, dis, build_criterion(cfg), opt_g,
                            opt_d)
            continue
        factory, _ = build_steps(cfg, gen, dis, build_criterion(cfg), opt_g,
                                 opt_d)
        _, metrics = factory(True, True, True)(
            state, batch, dropout_rng=step_generator(
                0, 0, DROPOUT_STREAM, cuda_device))
        assert all(torch.isfinite(v) for v in metrics.values())


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


# the f32 tensor-core body's edges: T one row either side of the 64-row
# tile, T below one tile, a dilation above T, B*T not a multiple of a slab's
# rows (999 rows in 3 slabs of 352), one slab, and the aux widths of B1's
# card tests (c in 4-channel pieces; A = 16 and 36 leave most of the second
# c tile and the last taps panel empty)
_TC_BWD_CASES = [
    (1, 63, (1, 2), 80), (2, 65, (1, 2), 80), (1, 40, (1,), 80),
    (1, 130, (512, 1), 80), (3, 333, (1, 64, 2), 80), (1, 77, (3,), 80),
    (2, 333, (1, 64, 2), 16), (2, 333, (1, 64, 2), 36),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,dils,A", _TC_BWD_CASES)
def test_backward_tensor_core_body_matches_plain(cuda_device, B, T, dils, A):
    """Every f32 gradient of the split-TF32 body against autograd through
    the plain forward, within f32's 1e-4 (1 + max |plain|)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    plan = backward_launch_plan(B, T, A, len(dils), torch.float32)
    assert plan["body"] == "tensor_cores_tf32x3"
    if (B, T) == (3, 333):
        assert plan["slabs"] == 3 and B * T % plan["rows_per_slab"]
    if (B, T) == (1, 77):
        assert plan["slabs"] == 1
    rng = np.random.default_rng(11)
    x, c, w = _stack_inputs(rng, B, T, len(dils), torch.float32, cuda_device,
                            A=A)
    ux = torch.from_numpy(rng.standard_normal((B, T, 64)).astype(
        np.float32)).to(cuda_device)
    us = torch.from_numpy(rng.standard_normal((B, T, 64)).astype(
        np.float32)).to(cuda_device)
    bwd = wavenet_stack_backward.launches
    got = _stack_grads(wavenet_stack_train, x, c, w, dils, ux, us)
    torch.cuda.synchronize()
    assert wavenet_stack_backward.launches == bwd + plan["launches"]
    want = _stack_grads(wavenet_stack_train_reference, x, c, w, dils, ux, us)
    for key in want:
        assert got[key].dtype == torch.float32, key
        _assert_close(got[key], want[key], torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,dils,A", _TC_BWD_CASES)
def test_backward_bf16_tensor_core_body_matches_plain(cuda_device, B, T,
                                                      dils, A):
    """The bf16 body on the same edges: every output against the explicit
    plain version on the same saved inputs (the same roundings, sums in
    another order) and, through autograd, against the plain forward's
    gradient (which rounds elsewhere), both within bf16's 2e-2 (1 + max
    |plain|)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bf = torch.bfloat16
    plan = backward_launch_plan(B, T, A, len(dils), bf)
    assert plan["body"] == "tensor_cores_bf16"
    assert plan["data_grid"] == (plan["blocks"],) and \
        plan["blocks"] <= plan["tiles"]
    if (B, T) == (3, 333):
        assert plan["slabs"] == 3 and B * T % plan["rows_per_slab"]
    if (B, T) == (1, 77):
        assert plan["slabs"] == 1
    rng = np.random.default_rng(12)
    x, c, w = _stack_inputs(rng, B, T, len(dils), bf, cuda_device, A=A)
    ux = torch.from_numpy(rng.standard_normal((B, T, 64)).astype(
        np.float32)).to(cuda_device)
    us = torch.from_numpy(rng.standard_normal((B, T, 64)).astype(
        np.float32)).to(cuda_device)
    _, _, xs = wavenet_stack(x, c, w, dils, save_inputs=True)
    bwd = wavenet_stack_backward.launches
    dx, dc, dw = wavenet_stack_backward(xs, c, w, dils, ux.to(bf), us)
    torch.cuda.synchronize()
    assert wavenet_stack_backward.launches == bwd + plan["launches"]
    pdx, pdc, pdw = wavenet_stack_backward_reference(xs, c, w, dils,
                                                     ux.to(bf), us)
    for key, a, b in [("dx", dx, pdx), ("dc", dc, pdc)] + [
            (k, dw[k], pdw[k]) for k in pdw]:
        assert a.dtype == b.dtype == bf, key
        _assert_close(a, b, bf)
    got = _stack_grads(wavenet_stack_train, x, c, w, dils, ux, us)
    torch.cuda.synchronize()
    want = _stack_grads(wavenet_stack_train_reference, x, c, w, dils, ux, us)
    for key in want:
        assert got[key].dtype == bf, key
        _assert_close(got[key], want[key], bf)


@pytest.mark.cuda
def test_backward_launch_plan_matches_the_kernel(cuda_device):
    """The plan mirrors the bf16 data launch's shared memory as the kernel
    lays it out, for the aux widths the card tests run and the widest the
    plan admits."""
    lib = backward_library()
    for A in (16, 36, 80, 112):
        assert lib.pwg_wavenet_stack_bwd_bf16_smem(A) == backward_smem_bytes(
            A, "tensor_cores_bf16")["data"], A


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,dils", [(2, 4133, tuple(2 ** i for i in range(10))),
                                      (1, 130, (512, 1))],
                         ids=["one_cycle", "d_past_T"])
def test_backward_f32_is_as_close_to_float64_as_its_plain_version(
        cuda_device, B, T, dils):
    """Every output of the f32 backward (dx, dc and the five weight
    gradients, through the kernels' forward and backward) lies at most
    2 x as far from the float64 gradient as the plain version's f32 sums,
    max |a - e| / (1 + max |e|)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(12)
    x, c, w = _stack_inputs(rng, B, T, len(dils), torch.float32, cuda_device)
    ux, us = (torch.from_numpy(rng.standard_normal((B, T, 64)).astype(
        np.float32)).to(cuda_device) for _ in range(2))
    got = _stack_grads(wavenet_stack_train, x, c, w, dils, ux, us)
    torch.cuda.synchronize()
    plain = _stack_grads(wavenet_stack_train_reference, x, c, w, dils, ux,
                         us)
    exact = _stack_grads(wavenet_stack_train_reference, x.double(),
                         c.double(), {k: v.double() for k, v in w.items()},
                         dils, ux.double(), us.double())
    assert len(exact) == 7
    for key in exact:
        hold_to_float64(key, got[key], plain[key], exact[key])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_is_deterministic_and_skipped_without_grad(
        cuda_device, dtype):
    rng = np.random.default_rng(4)
    dils = (1, 2, 4, 8)
    x, c, w = _stack_inputs(rng, 2, 700, 4, dtype, cuda_device)
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


@pytest.mark.cuda
def test_f32_train_step_backward_launches_follow_the_plan(cuda_device):
    """An f32 (G, adv, D) step at PWG v1 widths (6 layers in 3 stacks) runs
    the backward kernel on the tensor-core body, as many launches as the
    plan of each layer group says."""
    config = {
        "hop_size": 256, "batch_max_steps": 2560,
        "generator_params": dict(PWG_V1_KWARGS, layers=6, stacks=3),
        "discriminator_params": {"layers": 4, "conv_channels": 16},
        "stft_loss_params": {"fft_sizes": [256, 512], "hop_sizes": [64, 128],
                             "win_lengths": [128, 256]},
    }
    batch = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in example_batch(config, batch_size=2).items()}
    state, gen, dis, opt_g, opt_d = init_train_state(config, seed=0,
                                                     device=cuda_device)
    factory, _ = build_steps(config, gen, dis, build_criterion(config),
                             opt_g, opt_d)
    group = min(gen.layers // gen.stacks, 10)
    plans = [backward_launch_plan(2, 2560, 80, group, torch.float32)
             for _ in range(gen.layers // group)]
    assert {p["body"] for p in plans} == {"tensor_cores_tf32x3"}
    bwd = wavenet_stack_backward.launches
    factory(True, True, True)(state, batch)
    torch.cuda.synchronize()
    assert wavenet_stack_backward.launches - bwd == sum(
        p["launches"] for p in plans) == 6


@pytest.mark.cuda
def test_f32_train_step_profile_names_the_tf32_forward(cuda_device):
    """An f32 (G, adv, D) step at PWG v1 widths runs the forward on the
    split-TF32 body: the profiler sees wavenet_layer_tf32_kernel, and no
    other layer body of the forward."""
    from torch.profiler import ProfilerActivity, profile

    config = {
        "hop_size": 256, "batch_max_steps": 2560,
        "generator_params": dict(PWG_V1_KWARGS, layers=6, stacks=3),
        "discriminator_params": {"layers": 4, "conv_channels": 16},
        "stft_loss_params": {"fft_sizes": [256, 512], "hop_sizes": [64, 128],
                             "win_lengths": [128, 256]},
    }
    batch = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in example_batch(config, batch_size=2).items()}
    state, gen, dis, opt_g, opt_d = init_train_state(config, seed=0,
                                                     device=cuda_device)
    factory, _ = build_steps(config, gen, dis, build_criterion(config),
                             opt_g, opt_d)
    step = factory(True, True, True)
    step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any("wavenet_layer_tf32_kernel" in n for n in names), names
    assert not any("wavenet_layer_tc_kernel" in n for n in names)


def _rand_stage(rng, C, kernels, dils):
    weights = [[(rng.standard_normal((k, C, C)).astype(np.float32)
                 * (0.6 / np.sqrt(k * C)),
                 rng.standard_normal(C).astype(np.float32) * 0.05)
                for _ in range(len(dils) * 2)] for k in kernels]
    scales = [[np.abs(rng.standard_normal(C)).astype(np.float32) * 0.02 + 0.01
               for _ in range(len(dils) * 2)] for _ in kernels]
    return weights, scales


_V1 = ((3, 7, 11), (1, 3, 5))


def _tile_edges(C):
    """T one row either side of the fused body's second tile boundary of
    the k = 11 branch (the plan's tile: pure Python, the same on every
    machine)."""
    tt = mrf_stage_plan(1, 1, C, *_V1, torch.bfloat16)["tile"]["out_rows"]
    return [(C, 2 * tt[-1] + s, 1) + _V1 for s in (-1, 1)]


# (C, T, B, kernels, dils): the test widths of the JAX package and the four
# real ones; ragged T, T below one tile and below the reach of 60 rows, T
# one row either side of a tile boundary; the JAX test geometry at C 32
_MRF_CASES = [
    (8, 300, 2, (3, 5, 7), (1, 2)),
    (16, 20, 1, (3, 7, 11), (1, 3, 5)),
    (32, 1000, 2, (3, 7, 11), (1, 3, 5)),
    (64, 333, 2, (3, 7, 11), (1, 3, 5)),
    (128, 129, 1, (3, 7, 11), (1, 3, 5)),
    (256, 260, 1, (3, 7, 11), (1, 3, 5)),
    (32, 7, 3, (3, 7, 11), (1, 3, 5)),
    (32, 300, 2, (3, 5, 7), (1, 2)),
] + [case for C in (32, 64, 128, 256) for case in _tile_edges(C)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "int8_bf16x"])
@pytest.mark.parametrize("C,T,B,kernels,dils", _MRF_CASES)
def test_mrf_stage_kernel_matches_plain(cuda_device, mode, C, T, B, kernels,
                                        dils):
    """f32 and bf16 packs and int8 packs (x in f32 and in bf16) against the
    plain version. The int8 path pins its arithmetic (exact integer sums,
    two roundings in the epilogue), so f32 tolerance holds there too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    weights, scales = _rand_stage(rng, C, kernels, dils)
    quant = mode.startswith("int8")
    wdtype = torch.bfloat16 if mode == "bf16" else torch.float32
    xdtype = torch.bfloat16 if mode in ("bf16", "int8_bf16x") \
        else torch.float32
    pack = build_stage_pack(weights, scales, quant=quant, dtype=wdtype,
                            device=cuda_device)
    x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(
        np.float32)).to(cuda_device, xdtype)
    before = mrf_stage.launches
    out = mrf_stage(x, pack, kernels=kernels, dils=dils, quant=quant)
    torch.cuda.synchronize()
    plan = mrf_stage_plan(B, T, C, kernels, dils, pack["w0"].dtype)
    assert mrf_stage.launches == before + plan["launches"]
    assert out.dtype == xdtype and out.shape == x.shape
    ref = mrf_stage_reference(x, pack, kernels=kernels, dils=dils,
                              quant=quant)
    _assert_close(out, ref, xdtype if mode != "bf16" else torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_mrf_stage_launches_follow_the_plan(cuda_device, mode):
    """At every v1 width a call launches what its plan says: the fused
    conv pair (4 launches) for bf16 and int8 packs, the per-conv body (7)
    for f32 packs."""
    rng = np.random.default_rng(9)
    for C in (32, 64, 128, 256):
        weights, scales = _rand_stage(rng, C, *_V1)
        pack = build_stage_pack(
            weights, scales, quant=mode == "int8",
            dtype=torch.bfloat16 if mode == "bf16" else torch.float32,
            device=cuda_device)
        x = torch.zeros((2, 50, C), device=cuda_device)
        plan = mrf_stage_plan(2, 50, C, *_V1, pack["w0"].dtype)
        assert plan["launches"] == (7 if mode == "f32" else 4)
        before = mrf_stage.launches
        out = mrf_stage(x, pack, kernels=_V1[0], dils=_V1[1],
                        quant=mode == "int8")
        torch.cuda.synchronize()
        assert mrf_stage.launches - before == plan["launches"]
        assert torch.isfinite(out).all()


@pytest.mark.cuda
def test_mrf_stage_kernel_rejects_what_it_was_not_built_for(cuda_device):
    rng = np.random.default_rng(6)
    weights, scales = _rand_stage(rng, 24, (3, 5, 7), (1, 2))
    pack = build_stage_pack(weights, scales, quant=False,
                            dtype=torch.float32, device=cuda_device)
    x = torch.zeros((1, 40, 24), device=cuda_device)
    with pytest.raises(NotImplementedError, match="channels 24"):
        mrf_stage(x, pack, kernels=(3, 5, 7), dils=(1, 2), quant=False)
    weights, scales = _rand_stage(rng, 8, (3, 5, 7), (1, 2))
    pack = build_stage_pack(weights, scales, quant=False,
                            dtype=torch.float32, device=cuda_device)
    x = torch.zeros((1, 40, 8), device=cuda_device)
    with pytest.raises(TypeError, match="quant"):
        mrf_stage(x, pack, kernels=(3, 5, 7), dils=(1, 2), quant=True)
    with pytest.raises(ValueError, match="contiguous"):
        mrf_stage(torch.zeros((1, 8, 40), device=cuda_device).transpose(1, 2),
                  pack, kernels=(3, 5, 7), dils=(1, 2), quant=False)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("M,K,N", [(4096, 96, 32), (4096, 352, 32),
                                   (2048, 192, 64), (1024, 384, 128),
                                   (1024, 128, 128), (77, 50, 24),
                                   (1, 8, 8), (1000, 96, 8), (999, 40, 16),
                                   (4097, 72, 24), (333, 200, 128),
                                   (131072, 96, 32), (131072, 352, 32),
                                   (65536, 192, 64), (32768, 384, 128),
                                   (32768, 128, 128)])
def test_matmul_bench_kernel_matches_plain(cuda_device, mode, M, K, N):
    """int32 results bit-equal; bf16 -> f32 within f32 summation error.
    N of 8, 16 and 24; K off the mma depth (40, 72, 200; 50 is also off
    the 16-byte rows, staged synchronously); ragged M; the five MRF shapes
    at full size."""
    rng = np.random.default_rng(7)
    if mode == "int8":
        a = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    else:
        a = torch.from_numpy(rng.standard_normal((M, K)).astype(
            np.float32)).to(torch.bfloat16)
        b = torch.from_numpy(rng.standard_normal((K, N)).astype(
            np.float32)).to(torch.bfloat16)
    a, b = a.to(cuda_device), b.to(cuda_device)
    before = matmul_bench.launches
    out = matmul_bench(a, b)
    torch.cuda.synchronize()
    assert matmul_bench.launches == before + 1
    ref = matmul_bench_reference(a, b)
    if mode == "int8":
        assert out.dtype == torch.int32 and torch.equal(out, ref)
    else:
        assert out.dtype == torch.float32
        _assert_close(out, ref, torch.float32)
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        matmul_bench(a, b[:, :N - 1].contiguous())


_SMALL_HIFIGAN = dict(
    in_channels=12, channels=32, kernel_size=7, upsample_scales=(4, 2),
    upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3, 5, 7),
    resblock_dilations=((1, 3), (1, 3), (1, 3)),
)


@pytest.mark.cuda
def test_hifigan_inference_model_on_card(tmp_path, cuda_device):
    """A small HiFi-GAN through InferenceModel on the card: the exact
    forward against the CPU; use_mrf_kernel(quant=False) against the exact
    forward (the plan's launches a stage, and 0 for a stage left out);
    use_mrf_kernel(quant=True) against the int8 conv chain on the MRF keys
    with the same calibration."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = {"generator_type": "HiFiGANGenerator",
              "generator_params": _SMALL_HIFIGAN}
    gen = HiFiGANGenerator(**_SMALL_HIFIGAN,
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # a spread of magnitudes, as trained weights have
        for p in gen.parameters():
            p.mul_(8.0)
    path = str(tmp_path / "g.gckpt")
    save_generator_checkpoint(path, gen)
    rng = np.random.default_rng(8)
    mels = [rng.standard_normal((n, 12)).astype(np.float32) for n in (40, 23)]
    cpu = load_model(path, config, device="cpu")
    model = load_model(path, config, device=cuda_device)
    want = cpu.synthesize_batch(mels, bucket_size=8)
    exact = model.synthesize_batch(mels, bucket_size=8)
    for a, b in zip(exact, want):
        assert a.shape == b.shape
        _assert_close(torch.from_numpy(a), torch.from_numpy(b),
                      torch.float32)
    # the two stages (C 16 and 8) at a bucket of 40 frames
    plans = [mrf_stage_plan(2, 40 * 4 * 2 ** i, C, (3, 5, 7), (1, 3),
                            torch.float32) for i, C in enumerate((16, 8))]
    before = mrf_stage.launches
    model.use_mrf_kernel(quant=False)
    fused = model.synthesize_batch(mels, bucket_size=8)
    assert mrf_stage.launches == before + sum(p["launches"] for p in plans)
    for a, b in zip(fused, exact):
        _assert_close(torch.from_numpy(a), torch.from_numpy(b),
                      torch.float32)
    before = mrf_stage.launches
    model.use_mrf_kernel(quant=False, stages=[1])
    model.synthesize_batch(mels, bucket_size=8)
    assert mrf_stage.launches == before + plans[1]["launches"]
    model.use_mrf_kernel(quant=True, calib_mels=mels)
    fused_q = model.synthesize_batch(mels, bucket_size=8)
    chain = load_model(path, config, device=cuda_device)
    chain.quantize_int8(mels, schedule="all")
    chain._int8_scales = {k: v for k, v in chain._int8_scales.items()
                          if not k.endswith("_up")}
    chain_q = chain.synthesize_batch(mels, bucket_size=8)
    for a, b in zip(fused_q, chain_q):
        _assert_close(torch.from_numpy(a), torch.from_numpy(b),
                      torch.float32)
    c = torch.from_numpy(np.stack([mels[0]])).to(cuda_device)
    assert hifigan_fast_forward(model.generator, c).shape == (1, 320, 1)


def _variant_inputs(rng, B, T, L, dev):
    """Float32 weights at the experiment's scales, bf16 x and c."""
    def t(*shape, scale):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev)

    w = {"w_tap": t(L, 192, 128, scale=0.08), "b_tap": t(L, 128, scale=0.01),
         "w_aux": t(L, 80, 128, scale=0.08), "w_so": t(L, 64, 128, scale=0.08),
         "b_so": t(L, 128, scale=0.01)}
    return (w, t(B, T, 64, scale=0.3).to(torch.bfloat16),
            t(B, T, 80, scale=0.5).to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("gate,int8_taps", [("tanh", False), ("mul", False),
                                            ("tanh", True), ("mul", True)],
                         ids=["bf16_tanh", "bf16_mul", "int8_taps",
                              "int8_mul"])
@pytest.mark.parametrize("B,T,dils", [
    (2, 1000, (1, 2, 4)), (3, 333, (1, 8, 64)), (1, 7, (1, 2)),
    (1, 130, (512, 1)), (2, 2117, tuple(2 ** i for i in range(10))),
    (1, 4133, (1, 32, 63, 64, 65, 512))],
    ids=["even", "ragged", "below_a_tile", "d_past_T", "one_cycle",
         "halo_and_not"])
def test_variant_kernel_matches_plain(cuda_device, gate, int8_taps, B, T,
                                      dils):
    """The experiment's variant kernel against its plain version: 2e-2
    (1 + max |plain|) with bf16 taps, as for the serving stack; 2e-3 with
    int8 taps, whose quantiser is pinned and whose tap sums are exact (what
    is left is one bf16 step of one g, or one quantisation step of one
    later input, where f32 sums in another order cross a rounding border).
    The product gate is held on at most three layers, where it stays
    finite (ten layers of products overflow; they are only timed)."""
    if gate == "mul":
        dils = dils[:3]
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    w, x, c = _variant_inputs(rng, B, T, len(dils), cuda_device)
    s_tap = torch.ones((len(dils), 2), device=cuda_device)
    if int8_taps:
        x_plain, _ = variant_stack_reference(x, c, w, s_tap, dils)
        w_q, s_tap = quantize_taps(
            w["w_tap"], float(x_plain.float().abs().max()) * 1.05)
        w = dict(w, w_tap_q=w_q)
    before = variant_stack.launches
    xo, sk = variant_stack(x, c, w, s_tap, dils, gate=gate,
                           int8_taps=int8_taps)
    torch.cuda.synchronize()
    assert variant_stack.launches == before + variant_launch_plan(
        B, T, 80, len(dils), gate, int8_taps)["launches"] == before + len(dils)
    assert xo.dtype == torch.bfloat16 and sk.dtype == torch.float32
    xo_p, sk_p = variant_stack_reference(x, c, w, s_tap, dils, gate=gate,
                                         int8_taps=int8_taps)
    tol = 2e-3 if int8_taps else TOL[torch.bfloat16]
    for a, b in ((xo, xo_p), (sk, sk_p)):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all()
        err = (a - b).abs().max().item()
        assert err <= tol * (1 + b.abs().max().item()), err


@pytest.mark.cuda
def test_variant_kernel_rejects_what_it_was_not_built_for(cuda_device):
    rng = np.random.default_rng(1)
    w, x, c = _variant_inputs(rng, 1, 64, 2, cuda_device)
    s_tap = torch.ones((2, 2), device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        variant_stack(x.float(), c, w, s_tap, (1, 2))
    with pytest.raises(NotImplementedError, match="channels"):
        variant_stack(x[..., :32].contiguous(), c,
                      dict(w, w_tap=w["w_tap"][:, :96].contiguous()), s_tap,
                      (1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        variant_stack(x, torch.cat([c, c], -1)[..., :80], w, s_tap, (1, 2))
    with pytest.raises(ValueError, match="s_tap"):
        variant_stack(x, c, w, s_tap[:1], (1, 2))
    with pytest.raises(KeyError, match="w_tap_q"):
        variant_stack(x, c, w, s_tap, (1, 2), int8_taps=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_variant_quantiser_is_bit_equal_to_the_plain_one(cuda_device, dtype):
    """The int8 body's quantiser gives the plain quantiser's words bit for
    bit: on a residual-like state, on every half-integer border of x s and
    past +-127."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((3, 999, 64)).astype(
        np.float32) * 2).to(cuda_device, dtype)
    s = 127 / 4.3
    borders = (torch.arange(-600, 600, device=cuda_device) / 4 / s).to(
        dtype).reshape(-1, 4)
    for v in (x, borders):
        before = quantize_words.launches
        got = quantize_words(v, s)
        torch.cuda.synchronize()
        assert quantize_words.launches == before + 1
        assert torch.equal(got, quantize_words_reference(v, s))


@pytest.mark.cuda
def test_variant_launch_plan_matches_the_kernel(cuda_device):
    """The plan's shared memory is the kernel's own for both bodies and
    both x types; at the tool's shape the tensor-core body runs one
    persistent block an SM, the SIMT int8 body one block a tile."""
    lib = variant_library()
    for A in (16, 36, 80):
        for int8_taps in (False, True):
            for is_bf16, dtype in ((1, torch.bfloat16), (0, torch.float32)):
                assert lib.pwg_wavenet_variant_smem(is_bf16, int(int8_taps),
                                                    A) == \
                    variant_smem_bytes(A, dtype, int8_taps)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for int8_taps in (False, True):
        plan = variant_launch_plan(32, 131072, 80, 10, "tanh", int8_taps, sms)
        assert plan["smem"] <= 232448
        assert plan["blocks"] == (plan["tiles"] if int8_taps else sms)


# --- the MelGAN family, reference .pkl files and chunked synthesis ---------
_SMALL_MB_MELGAN = dict(in_channels=12, out_channels=4, channels=64,
                        upsample_scales=(4, 2), stacks=2)


@pytest.mark.cuda
def test_mb_melgan_on_card_matches_cpu(tmp_path, cuda_device):
    """A small multi-band MelGAN written as a reference .pkl by the port's
    exporter: InferenceModel on the card (cuDNN convs, PQMF synthesis)
    against the CPU, in f32 with TF32 off."""
    from parallelwavegan_torch.models import MelGANGenerator
    from parallelwavegan_torch.utils.params import nested
    from parallelwavegan_torch.utils.torch_export import (
        save_reference_checkpoint,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = MelGANGenerator(**_SMALL_MB_MELGAN,
                          generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # unit-gain kernels: a full-scale waveform
        for name, p in gen.named_parameters():
            if name.endswith("kernel"):
                p.mul_(1.0 / (0.02 * (p.shape[0] * p.shape[1]) ** 0.5))
    config = {"generator_type": "MelGANGenerator",
              "generator_params": _SMALL_MB_MELGAN}
    path = str(tmp_path / "checkpoint-1steps.pkl")
    save_reference_checkpoint(path, nested(gen.state_dict()), config)
    rng = np.random.default_rng(9)
    mels = [rng.standard_normal((n, 12)).astype(np.float32) for n in (40, 23)]
    want = load_model(path, config, device="cpu").synthesize_batch(
        mels, bucket_size=8)
    got = load_model(path, config, device=cuda_device).synthesize_batch(
        mels, bucket_size=8)
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.abs(b).max() > 0.1
        _assert_close(torch.from_numpy(a), torch.from_numpy(b),
                      torch.float32)


@pytest.mark.cuda
def test_chunked_synthesis_through_both_serving_kernels(tmp_path,
                                                        cuda_device):
    """inference_chunked on the card: a small HiFi-GAN on mrf_stage against
    its whole-utterance forward, with the plans' launches; PWG at v1 widths
    on wavenet_stack, each chunk the fused forward of its window on the
    noise a fresh generator of the same seed draws in window order."""
    from parallelwavegan_torch.utils.model_loader import chunk_windows

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(10)
    gen = HiFiGANGenerator(**_SMALL_HIFIGAN,
                           generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "hifigan.gckpt")
    save_generator_checkpoint(path, gen)
    model = load_model(path, {"generator_type": "HiFiGANGenerator",
                              "generator_params": _SMALL_HIFIGAN},
                       device=cuda_device)
    model.use_mrf_kernel(quant=False)
    mel = rng.standard_normal((300, 12)).astype(np.float32)
    whole = model.inference(mel)
    windows = chunk_windows(300, 64, 24)
    before = mrf_stage.launches
    chunked = model.inference_chunked(mel, 64, 24)
    want = sum(mrf_stage_plan(1, (hi - lo) * (4, 8)[i], C, (3, 5, 7),
                              (1, 3), torch.float32)["launches"]
               for lo, hi, _, _ in windows for i, C in enumerate((16, 8)))
    assert mrf_stage.launches - before == want
    _assert_close(torch.from_numpy(chunked), torch.from_numpy(whole),
                  torch.float32)

    pwg = ParallelWaveGANGenerator(**dict(PWG_V1_KWARGS, layers=6, stacks=3),
                                   generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "pwg.gckpt")
    save_generator_checkpoint(path, pwg)
    model = load_model(path, {"generator_type": "ParallelWaveGANGenerator",
                              "generator_params": dict(PWG_V1_KWARGS,
                                                       layers=6, stacks=3)},
                       device=cuda_device)
    mel = rng.standard_normal((200, 80)).astype(np.float32)
    before = wavenet_stack.launches
    got = model.inference_chunked(
        mel, 64, 16, generator=torch.Generator(cuda_device).manual_seed(3))
    windows = chunk_windows(200, 64, 16)
    assert wavenet_stack.launches - before == 6 * len(windows)
    fresh = torch.Generator(cuda_device).manual_seed(3)
    for lo, hi, a, b in windows:
        fn, (c, z), _ = model.prepare_batch([mel[lo:hi]], generator=fresh,
                                            bucket_size=1)
        y = fn(c, z)[0, (a - lo) * 256: (b - lo) * 256].cpu().numpy()
        np.testing.assert_array_equal(got[a * 256: b * 256], y)


@pytest.mark.cuda
def test_asset_pkl_serves_like_its_gckpt(tmp_path, cuda_device):
    """The shipped HiFi-GAN checkpoint exported to a reference .pkl (its
    kernels after the .gckpt's fold, under a config without weight norm)
    gives the .gckpt's waveforms bit for bit on the card."""
    import os

    from parallelwavegan_torch.utils.params import nested
    from parallelwavegan_torch.utils.torch_export import (
        save_reference_checkpoint,
    )

    assets = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets", "quality")
    ckpt = os.path.join(assets, "generator.gckpt")
    config = {"generator_type": "HiFiGANGenerator", "generator_params": dict(
        in_channels=80, channels=512, kernel_size=7,
        upsample_scales=[8, 8, 2, 2], upsample_kernel_sizes=[16, 16, 4, 4],
        resblock_kernel_sizes=[3, 7, 11],
        resblock_dilations=[[1, 3, 5]] * 3, use_weight_norm=True)}
    gckpt = load_model(ckpt, config, device=cuda_device)
    config["generator_params"]["use_weight_norm"] = False
    path = str(tmp_path / "checkpoint-60000steps.pkl")
    save_reference_checkpoint(path, nested(gckpt.generator.state_dict()),
                              config)
    pkl = load_model(path, config, device=cuda_device)
    mels = [np.load(os.path.join(assets, f"eval_utt{i}-feats.npy"))[:100]
            for i in (0, 1)]
    for a, b in zip(pkl.synthesize_batch(mels), gckpt.synthesize_batch(mels)):
        np.testing.assert_array_equal(a, b)


# small discriminators of the MelGAN family's training recipes
_CARD_DISCRIMINATORS = {
    "MelGANDiscriminator": dict(channels=4, downsample_scales=(4, 4),
                                max_downsample_channels=16),
    "MelGANMultiScaleDiscriminator": dict(
        scales=3, channels=4, downsample_scales=(4, 4),
        max_downsample_channels=16),
    "ResidualParallelWaveGANDiscriminator": dict(
        layers=4, stacks=2, residual_channels=8, gate_channels=16,
        skip_channels=8),
}


def _flat_outputs(outs):
    if isinstance(outs, (list, tuple)):
        return [t for o in outs for t in _flat_outputs(o)]
    return [outs]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_CARD_DISCRIMINATORS))
def test_melgan_family_discriminators_on_card_match_cpu(cuda_device, name):
    """Each discriminator in its training form on the card (cuDNN convs,
    TF32 off) against the same module on the CPU: every output and every
    parameter's gradient of a weighted sum of them, f32 tolerance."""
    from parallelwavegan_torch.models import get_model_class

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = get_model_class(name)(**_CARD_DISCRIMINATORS[name], folded=False,
                                generator=torch.Generator().manual_seed(0))
    card = get_model_class(name)(**_CARD_DISCRIMINATORS[name], folded=False)
    card.load_state_dict(cpu.state_dict())
    card.to(cuda_device)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 1021, 1)).astype(np.float32))
    results = []
    for module, xin in ((card, x.to(cuda_device)), (cpu, x)):
        outs = _flat_outputs(module(xin))
        weights = [torch.from_numpy(np.random.default_rng(i).standard_normal(
            tuple(t.shape)).astype(np.float32)).to(t.device)
            for i, t in enumerate(outs)]
        loss = sum((w * t).sum() for w, t in zip(weights, outs))
        grads = torch.autograd.grad(loss, list(module.parameters()),
                                    allow_unused=True)
        results.append((outs, [torch.zeros_like(p) if g is None else g
                               for g, p in zip(grads, module.parameters())]))
    (outs, grads), (want_outs, want_grads) = results
    for a, b in zip(outs + grads, want_outs + want_grads, strict=True):
        _assert_close(a.cpu(), b.detach(), torch.float32)


@pytest.mark.cuda
def test_mb_melgan_train_step_on_card_matches_cpu(cuda_device):
    """One (G, adv, D) step of a small multi-band MelGAN with the subband
    STFT loss and the multi-scale discriminator (no hand-written kernel on
    this path): the card (TF32 off) against the CPU from the same
    parameters and batch, the losses to 1e-4 relative and the updated
    parameters to 1e-6 absolute (Adam, lr 1e-4, eps 1e-3)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    adam = {"lr": 1e-4, "eps": 1e-3}
    config = {
        "hop_size": 64, "num_mels": 16, "batch_max_steps": 1024,
        "generator_type": "MelGANGenerator",
        "generator_params": {"in_channels": 16, "out_channels": 4,
                             "channels": 32, "upsample_scales": [4, 4],
                             "stacks": 2},
        "discriminator_type": "MelGANMultiScaleDiscriminator",
        "discriminator_params": _CARD_DISCRIMINATORS[
            "MelGANMultiScaleDiscriminator"],
        "stft_loss_params": {"fft_sizes": [128, 256], "hop_sizes": [16, 32],
                             "win_lengths": [64, 128]},
        "use_subband_stft_loss": True,
        "subband_stft_loss_params": {"fft_sizes": [64, 32],
                                     "hop_sizes": [8, 4],
                                     "win_lengths": [32, 16]},
        "lambda_adv": 2.5,
        "generator_optimizer_type": "Adam",
        "generator_optimizer_params": adam,
        "discriminator_optimizer_type": "Adam",
        "discriminator_optimizer_params": adam,
    }
    batch = example_batch(config, batch_size=2)
    t = np.arange(1024) / 16000
    batch["y"] = (0.3 * np.sin(2 * np.pi * np.array([[300.0], [520.0]]) * t)
                  ).astype(np.float32)[..., None]
    runs = []
    for device in (cuda_device, "cpu"):
        state, gen, dis, opt_g, opt_d = init_train_state(config, seed=0,
                                                         device=device)
        factory, _ = build_steps(config, gen, dis, build_criterion(config),
                                 opt_g, opt_d)
        _, metrics = factory(True, True, True)(
            state, {k: torch.from_numpy(v).to(device)
                    for k, v in batch.items()})
        runs.append((metrics, {**state.params_g, **state.params_d}))
    (metrics, params), (want_metrics, want_params) = runs
    assert "sub_log_stft_magnitude_loss" in metrics
    assert sorted(metrics) == sorted(want_metrics)
    for key, value in want_metrics.items():
        assert abs(metrics[key].item() - value.item()) <= 1e-4 * abs(
            value.item()), key
    for key, value in want_params.items():
        err = (params[key].detach().cpu() - value.detach()).abs().max()
        assert err.item() <= 1e-6, key


# --- StyleMelGAN (no hand-written kernel on its path) ----------------------
_SMALL_STYLE_G = dict(in_channels=16, aux_channels=12, channels=16,
                      noise_upsample_scales=(4, 2),
                      upsample_scales=(2, 2, 2, 2, 1))
_SMALL_STYLE_D = dict(repeats=2, window_sizes=(32, 64, 128, 256),
                      discriminator_params=dict(channels=4,
                                                max_downsample_channels=16,
                                                downsample_scales=(4, 1)))


def _five_kernel_launches():
    from parallelwavegan_torch.ops.cuda.wavenet_stack_train import (
        wavenet_stack_backward as bwd,
    )

    return (wavenet_stack.launches, bwd.launches, mrf_stage.launches,
            matmul_bench.launches, variant_stack.launches)


@pytest.mark.cuda
def test_style_melgan_on_card_matches_cpu(tmp_path, cuda_device):
    """A small StyleMelGAN written as a reference .pkl by the port's
    exporter: batched and chunked serving on the card (TF32 off) against
    the CPU on the noise of one CPU generator, f32 tolerance; no launch
    of the five kernels."""
    from parallelwavegan_torch.models import StyleMelGANGenerator
    from parallelwavegan_torch.utils.params import nested
    from parallelwavegan_torch.utils.torch_export import (
        save_reference_checkpoint,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = StyleMelGANGenerator(**_SMALL_STYLE_G,
                               generator=torch.Generator().manual_seed(0))
    config = {"generator_type": "StyleMelGANGenerator",
              "generator_params": _SMALL_STYLE_G, "hop_size": 16}
    path = str(tmp_path / "checkpoint-1steps.pkl")
    save_reference_checkpoint(path, nested(gen.state_dict()), config)
    rng = np.random.default_rng(10)
    mels = [rng.standard_normal((n, 12)).astype(np.float32) for n in (40, 23)]
    before = _five_kernel_launches()
    models = {d: load_model(path, config, device=d)
              for d in (cuda_device, "cpu")}
    noise = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    got, want = (m.synthesize_batch(mels, generator=noise())
                 for m in models.values())
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and np.abs(b).max() > 1e-3
        _assert_close(torch.from_numpy(a), torch.from_numpy(b),
                      torch.float32)
    long = rng.standard_normal((300, 12)).astype(np.float32)
    got, want = (m.inference_chunked(long, 24, 8, generator=noise())
                 for m in models.values())
    assert got.shape == (300 * 16, 1)
    _assert_close(torch.from_numpy(got), torch.from_numpy(want),
                  torch.float32)
    assert _five_kernel_launches() == before


@pytest.mark.cuda
def test_style_melgan_train_step_on_card_matches_cpu(cuda_device):
    """One (G, adv, D) step of a small StyleMelGAN from the same
    parameters, batch and random source on the card (TF32 off) and on the
    CPU: the losses to 1e-4 relative, the updated parameters to 1e-6
    absolute (Adam, lr 1e-4, eps 1e-3); no launch of the five kernels."""
    from parallelwavegan_torch.engine.step import step_generator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    adam = {"lr": 1e-4, "eps": 1e-3}
    config = {
        "hop_size": 16, "num_mels": 12, "batch_max_steps": 384,
        "generator_type": "StyleMelGANGenerator",
        "generator_params": _SMALL_STYLE_G,
        "discriminator_type": "StyleMelGANDiscriminator",
        "discriminator_params": _SMALL_STYLE_D,
        "stft_loss_params": {"fft_sizes": [64, 128], "hop_sizes": [8, 16],
                             "win_lengths": [32, 64]},
        "lambda_adv": 1.0,
        "generator_optimizer_type": "Adam",
        "generator_optimizer_params": adam,
        "discriminator_optimizer_type": "Adam",
        "discriminator_optimizer_params": adam,
    }
    batch = example_batch(config, batch_size=2)
    assert sorted(batch) == ["c", "y"]
    t = np.arange(384) / 8000
    batch["y"] = (0.3 * np.sin(2 * np.pi * np.array([[300.0], [520.0]]) * t)
                  ).astype(np.float32)[..., None]
    before = _five_kernel_launches()
    runs = []
    for device in (cuda_device, "cpu"):
        state, gen, dis, opt_g, opt_d = init_train_state(config, seed=0,
                                                         device=device)
        factory, _ = build_steps(config, gen, dis, build_criterion(config),
                                 opt_g, opt_d)
        _, metrics = factory(True, True, True)(
            state, {k: torch.from_numpy(v).to(device)
                    for k, v in batch.items()}, step_generator(0, 0))
        runs.append((metrics, {**state.params_g, **state.params_d}))
    assert _five_kernel_launches() == before
    (metrics, params), (want_metrics, want_params) = runs
    assert sorted(metrics) == sorted(want_metrics)
    assert "adversarial_loss" in metrics
    for key, value in want_metrics.items():
        assert abs(metrics[key].item() - value.item()) <= 1e-4 * abs(
            value.item()), key
    for key, value in want_params.items():
        err = (params[key].detach().cpu() - value.detach()).abs().max()
        assert err.item() <= 1e-6, key


_SMALL_VQ = {
    "num_embeds": 32, "embed_dim": 16, "num_global_embeds": 4,
    "global_embed_dim": 4,
    "encoder_conf": {"out_channels": 16, "downsample_scales": [4, 4],
                     "max_downsample_channels": 32, "channels": 8},
    "decoder_conf": {"in_channels": 20, "upsample_scales": [4, 4],
                     "channels": 32, "stacks": 2},
}


@pytest.mark.cuda
def test_vqvae_on_card_matches_cpu(cuda_device):
    """A small globally conditioned VQ-VAE (kernels at a per-entry std of
    1 / sqrt(K Cin), codebook rows latents of a seeded batch): the codes on
    the card (TF32 off) equal the CPU's but at near-ties (a float64 gap
    between a latent's two nearest distances below 1e-5 (||z||^2 + max
    ||e||^2)); forward, latents and the decode of the CPU's codes within
    1e-4 (1 + max); no launch of the five kernels."""
    from parallelwavegan_torch.layers.vq import code_gaps
    from parallelwavegan_torch.models import VQVAE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    gen = VQVAE(**_SMALL_VQ, generator=g)
    rng = np.random.default_rng(5)
    t = np.arange(4000) / 8000.0
    x = torch.from_numpy(np.stack([
        0.4 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(t.size)
        for f in (180.0, 310.0, 445.0)]).astype(np.float32)[..., None])
    spk = torch.tensor([0, 3, 1])
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("kernel") and name.startswith(("encoder",
                                                            "decoder")):
                p.mul_(1.0 / (0.02 * (p.shape[0] * p.shape[1]) ** 0.5))
        flat = gen.encoder(x)[-1].reshape(-1, 16)
        gen.codebook.embedding.copy_(flat[torch.randperm(len(flat),
                                                         generator=g)[:32]])
    card = VQVAE(**_SMALL_VQ).to(cuda_device).eval()
    card.load_state_dict(gen.state_dict())
    before = _five_kernel_launches()
    with torch.inference_mode():
        codes = gen.encode(x)
        got_codes = card.encode(x.to(cuda_device)).cpu()
        want = gen(x, None, spk)
        got = card(x.to(cuda_device), None, spk.to(cuda_device))
        wave = card.decode(codes.to(cuda_device), g=spk.to(cuda_device))
        want_wave = gen.decode(codes, g=spk)
        z64 = VQVAE(**_SMALL_VQ).double()
        z64.load_state_dict(gen.state_dict())
        z = z64.encoder(x.double())[-1].reshape(-1, 16)
    assert _five_kernel_launches() == before
    near_tie = code_gaps(z, gen.codebook.embedding) < 1e-5
    differ = (got_codes != codes).reshape(-1)
    assert not (differ & ~near_tie).any(), int(differ.sum())
    assert len(torch.unique(codes)) >= 8
    if not differ.any():
        for a, b in zip(got, want, strict=True):
            _assert_close(a.cpu(), b, torch.float32)
    _assert_close(got[1].cpu(), want[1], torch.float32)  # z_e
    assert wave.shape == (3, 4000, 1) and want_wave.abs().max() > 1e-2
    _assert_close(wave.cpu(), want_wave, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16384, 1), (2, 4096, 16)])
@pytest.mark.parametrize("layout", ["contiguous", "from (B, C, T)"])
def test_avg_pool1d_gradient_on_card_matches_float64(cuda_device, shape,
                                                     layout):
    """The multi-scale discriminator's pooling (kernel 4, stride 2, padding
    1, count_include_pad False): forward and input gradient on the card as
    close to float64 as the CPU's f32, at most 2 x + 1e-6 (of 1 + max).
    ``F.avg_pool1d``'s backward missed this by up to 100 % of the largest
    entry (PyTorch 2.11, CUDA 12.8)."""
    from parallelwavegan_torch.ops.conv import avg_pool1d

    g = torch.Generator().manual_seed(3)
    base = torch.randn(shape, generator=g)
    cot = torch.randn((shape[0], shape[1] // 2, shape[2]), generator=g)
    got = {}
    for route, (device, dtype) in (("k", (cuda_device, torch.float32)),
                                   ("p", ("cpu", torch.float32)),
                                   ("e", ("cpu", torch.float64))):
        x = base.to(device, dtype)
        if layout != "contiguous":
            x = x.transpose(1, 2).contiguous().transpose(1, 2)
        x.requires_grad_()
        y = avg_pool1d(x, 4, 2, 1, False)
        (dx,) = torch.autograd.grad(y, x, cot.to(device, dtype))
        got[route] = (y.detach().cpu().double(), dx.cpu().double())
    for i in (0, 1):
        e = got["e"][i]
        errs = [((got[r][i] - e).abs().max() / (1 + e.abs().max())).item()
                for r in "kp"]
        assert errs[0] <= 2 * errs[1] + 1e-6, (i, errs)


@pytest.mark.cuda
@pytest.mark.parametrize("max_len", [64, 300, 2048])
def test_length_regulator_on_card_matches_cpu(cuda_device, max_len):
    """The static-length regulator (an all-zero row, sums past max_len and
    short of it, the zero fill) equal on the card and the CPU, bit for
    bit, and its mask with it."""
    from parallelwavegan_torch.layers.duration import length_regulator

    g = torch.Generator().manual_seed(4)
    x = torch.randn((4, 115, 8), generator=g)
    ds = torch.randint(0, 7, (4, 115), generator=g)
    ds[1] = 0
    ds[2] = 40
    want, want_mask = length_regulator(x, ds, max_len)
    got, mask = length_regulator(x.to(cuda_device), ds.to(cuda_device),
                                 max_len)
    assert torch.equal(got.cpu(), want) and torch.equal(mask.cpu(), want_mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [1, 384, 512])
def test_embedding_backward_on_card_matches_float64(cuda_device, dim):
    """F.embedding's backward on the card (a scatter-add over the ids) with
    ids repeated thousands of times: the table's gradient as close to
    float64 as the CPU's f32, at most 2 x + 1e-6 (of 1 + max)."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(5)
    table = torch.randn((1025, dim), generator=g)
    ids = torch.randint(0, 40, (16, 2048), generator=g)
    ids[:, ::3] = 7  # one id a third of the time
    cot = torch.randn((16, 2048, dim), generator=g)
    got = {}
    for route, (device, dtype) in (("k", (cuda_device, torch.float32)),
                                   ("p", ("cpu", torch.float32)),
                                   ("e", ("cpu", torch.float64))):
        w = table.to(device, dtype).requires_grad_()
        y = F.embedding(ids.to(device), w)
        (dw,) = torch.autograd.grad(y, w, cot.to(device, dtype))
        got[route] = dw.cpu().double()
    e = got["e"]
    errs = [((got[r] - e).abs().max() / (1 + e.abs().max())).item()
            for r in "kp"]
    assert errs[0] <= 2 * errs[1] + 1e-6, errs
    assert (got["k"][40:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [30, 120])
def test_duration_predictor_on_card_is_as_close_to_float64_as_the_cpu(
        cuda_device, tokens):
    """The duration predictor (512 -> 384 -> 384, kernel 3, dropout on
    given masks) on the card: its log-durations and its input's gradient
    as close to float64 as the CPU's f32, at most 2 x + 1e-6, on six
    seeded inputs. Its convs are matrix products on both devices; cuDNN's
    f32 conv lay up to 5 x the CPU's distance there (ROADMAP C-5)."""
    from parallelwavegan_torch.layers.duration import DurationPredictor

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pred = DurationPredictor(512, 2, 384, 3, 0.5,
                             generator=torch.Generator().manual_seed(8))
    for seed in range(6):
        g = torch.Generator().manual_seed(100 + seed)
        x = torch.randn((1, tokens, 512), generator=g)
        masks = pred.draw_dropout_masks(1, tokens, g)
        cot = torch.randn((1, tokens), generator=g)
        got = {}
        for route, (device, dtype) in (("k", (cuda_device, torch.float32)),
                                       ("p", ("cpu", torch.float32)),
                                       ("e", ("cpu", torch.float64))):
            m = copy.deepcopy(pred).to(device, dtype)
            xr = x.to(device, dtype).requires_grad_()
            y = m(xr, False, [mk.to(device) for mk in masks])
            (dx,) = torch.autograd.grad(y, xr, cot.to(device, dtype))
            got[route] = (y.detach().cpu().double(), dx.cpu().double())
        for i, what in enumerate(("log-durations", "input gradient")):
            e = got["e"][i]
            k, p = ((got[r][i] - e).abs().max().item() for r in "kp")
            assert k <= 2 * p + 1e-6, (seed, what, k, p)


@pytest.mark.cuda
def test_duration_inference_near_ties_on_card_matches_cpu(cuda_device):
    """DurationPredictor.inference on the card against the CPU: log
    durations whose exp(d) - offset lie at k + 1/2 (up to the predictor's
    rounding) may round to either side; every other duration is the
    CPU's, and the flips stay within 1e-4 of a tie in float64."""
    from parallelwavegan_torch.layers.duration import DurationPredictor

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pred = DurationPredictor(64, 2, 384, 3, 0.5,
                             generator=torch.Generator().manual_seed(6))
    g = torch.Generator().manual_seed(7)
    x = torch.randn((8, 200, 64), generator=g)
    with torch.no_grad():
        log_d = pred(x)
        # move the output bias so that one position sits at a tie, k + 1/2
        shift = float(torch.log(torch.tensor(3.5 + 1.0)) - log_d[0, 0])
        pred.linear.bias += shift
        cpu = pred.inference(x)
        log_cpu = pred(x).double()
        card = pred.to(cuda_device).inference(x.to(cuda_device)).cpu()
    flips = torch.nonzero(card != cpu)
    v = torch.exp(log_cpu) - 1.0
    tie = (v - (torch.floor(v) + 0.5)).abs()
    assert all(tie[i, j] < 1e-4 for i, j in flips.tolist()), flips
    assert len(flips) <= 0.01 * cpu.numel()
    assert cpu.max() > 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 300, 66150])
def test_preprocess_log_mel_on_card_matches_the_cpu_route(cuda_device, n):
    """The preprocessing log-mel (float64 FFT, mel product and log) on the
    card against the CPU route on the same wave, digital silence included:
    within a few float32 roundings (4e-6 at |log10 mel| <= 10)."""
    from parallelwavegan_torch.ops.spectral import preprocess_log_mel

    rng = np.random.default_rng(n)
    x = (0.1 * rng.standard_normal(n)).astype(np.float32)
    x[: n // 3] = 0.0
    got = preprocess_log_mel(x, 22050, 1024, 256, None, "hann", 80, 80, 7600,
                             device=cuda_device)
    want = preprocess_log_mel(x, 22050, 1024, 256, None, "hann", 80, 80,
                              7600, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


def _raises_or(read):
    try:
        return read()
    except RuntimeError:
        return "raises"


def _tf32_settings():
    matmul = torch.backends.cuda.matmul
    return (_raises_or(torch.get_float32_matmul_precision),
            _raises_or(lambda: matmul.allow_tf32), matmul.fp32_precision,
            torch.backends.mkldnn.matmul.fp32_precision)


@pytest.mark.cuda
@pytest.mark.parametrize("switch", ["set_float32_matmul_precision high",
                                    "allow_tf32", "fp32_precision tf32"])
def test_spectral_products_on_card_are_full_f32_under_tf32(
        cuda_device, switch, monkeypatch):
    """ROADMAP.md C-7 on the card: with TF32 switched on by each of the
    process's three switches, the STFT magnitude, the log-mel, and the
    STFT loss and its gradient (the products' backward) run without an
    error and stay within their CPU tests' tolerances of the port's float64
    on the CPU: 2e-5 of the largest magnitude and 2e-5 absolute at 4 x
    16,384 samples (fft 1,024), the loss to 1e-5 relative and its gradient
    to 1e-4 of its largest entry at the CPU test's 3 x 700 (fft 128; at
    the larger shape the log magnitude's gradient leaves f32 on the CPU
    too). The magnitude with ``_full_f32`` made a no-op lies past its
    tolerance under the same switch (TF32 is on), and every setting reads
    as before after."""
    import contextlib

    from parallelwavegan_torch.losses import STFTLoss
    from parallelwavegan_torch.ops import spectral

    rng = np.random.default_rng(22)
    x = (0.3 * rng.standard_normal((4, 16384))).astype(np.float32)
    t = np.arange(700) / 8000.0
    y_small = np.stack([0.4 * np.sin(2 * np.pi * (200 + 150 * i) * t)
                        for i in range(3)])
    x_small = (y_small + 0.1 * rng.standard_normal((3, 700))).astype(
        np.float32)
    y_small = y_small.astype(np.float32)
    stft = dict(fft_size=1024, hop_size=256, win_length=1024,
                method="matmul")
    mel = dict(stft, num_mels=80, fmin=80, fmax=7600)
    x64 = torch.from_numpy(x).double()
    want_mag = spectral.stft_magnitude(x64, **stft)
    want_mel = spectral.log_mel_spectrogram(x64, 22050, **mel)
    xe = torch.from_numpy(x_small).double().requires_grad_()
    loss64 = sum(STFTLoss(128, 32, 64, "hann", "matmul")(
        xe, torch.from_numpy(y_small).double()))
    (want_grad,) = torch.autograd.grad(loss64, xe)

    matmul = torch.backends.cuda.matmul
    saved = _tf32_settings()
    backends = (matmul.fp32_precision,
                torch.backends.mkldnn.matmul.fp32_precision)
    try:
        if switch == "allow_tf32":
            matmul.allow_tf32 = True
        elif switch == "fp32_precision tf32":
            matmul.fp32_precision = "tf32"
        else:
            torch.set_float32_matmul_precision("high")
        before = _tf32_settings()
        xc = torch.from_numpy(x).to(cuda_device)
        mag = spectral.stft_magnitude(xc, **stft)
        log_mel = spectral.log_mel_spectrogram(xc, 22050, **mel)
        xk = torch.from_numpy(x_small).to(cuda_device).requires_grad_()
        loss = sum(STFTLoss(128, 32, 64, "hann", "matmul")(
            xk, torch.from_numpy(y_small).to(cuda_device)))
        (grad,) = torch.autograd.grad(loss, xk)
        after = _tf32_settings()
        with monkeypatch.context() as m:
            m.setattr(spectral, "_full_f32", contextlib.nullcontext)
            lowered = spectral.stft_magnitude(xc, **stft)
    finally:
        torch.set_float32_matmul_precision(
            saved[0] if saved[0] != "raises" else "highest")
        matmul.fp32_precision = backends[0]
        torch.backends.mkldnn.matmul.fp32_precision = backends[1]
    assert after == before
    assert _tf32_settings() == saved
    tol = 2e-5 * want_mag.max()
    assert (lowered.double().cpu() - want_mag).abs().max() > tol
    assert (mag.double().cpu() - want_mag).abs().max() <= tol
    assert (log_mel.double().cpu() - want_mel).abs().max() <= 2e-5
    assert abs(loss.item() - loss64.item()) <= 1e-5 * abs(loss64.item())
    grad_err = (grad.double().cpu() - want_grad).abs().max()
    assert grad_err <= 1e-4 * want_grad.abs().max()


def _card_as_close_to_float64_as_the_cpu(cuda_device, fn, shapes, layouts,
                                         seed=0, excess=()):
    """fn(*tensors) and the gradient of a seeded cotangent with respect to
    each tensor, on the card in f32 (k), on the CPU in f32 (p) and in
    float64 (e), the tensors drawn from ``seed`` at ``shapes`` and laid
    out as ``layouts`` says ("contiguous", or "from (B, C, T)": the port's
    (B, T, C) view of a channels-first tensor); every output held to the
    rule of ``test_avg_pool1d_gradient_on_card_matches_float64``, the
    card's error from float64 at most 2 x the CPU f32's + 1e-6 (of 1 +
    max). The outputs listed in ``excess`` (0 the result, i the gradient
    of tensor i - 1), whose rounding excess ROADMAP.md § C records from
    the op census, are held to the census's wrong-result limit instead:
    past that rule only within 1e-4 (of 1 + max). Returns the errors."""
    g = torch.Generator().manual_seed(seed)
    base = [torch.randn(s, generator=g) for s in shapes]
    got, cot = {}, None
    for route, (device, dtype) in (("k", (cuda_device, torch.float32)),
                                   ("p", ("cpu", torch.float32)),
                                   ("e", ("cpu", torch.float64))):
        xs = []
        for b, layout in zip(base, layouts):
            x = b.to(device, dtype)
            if layout != "contiguous":
                x = x.transpose(1, 2).contiguous().transpose(1, 2)
            xs.append(x.requires_grad_())
        y = fn(*xs)
        if cot is None:
            cot = torch.randn(y.shape, generator=g)
        grads = torch.autograd.grad(y, xs, cot.to(device, dtype))
        got[route] = [t.detach().cpu().double() for t in (y, *grads)]
    errs = []
    for i, e in enumerate(got["e"]):
        k, p = (((got[r][i] - e).abs().max() / (1 + e.abs().max())).item()
                for r in "kp")
        if i in excess:
            assert k <= max(2 * p + 1e-6, 1e-4), (i, k, p)
        else:
            assert k <= 2 * p + 1e-6, (i, k, p)
        errs.append((k, p))
    return errs


def _census_case(name):
    """(fn, shapes, layouts, excess) of one op kind of the op census at one
    recipe shape, through the port's own functions; ``excess`` names the
    outputs past the 2 x rule on an H100 (ROADMAP.md § C, C-11: cuDNN's
    f32 transposed conv's input gradient, 7.6 x the CPU's error)."""
    from parallelwavegan_torch.layers.common import instance_norm_1d
    from parallelwavegan_torch.ops import conv, pqmf
    from parallelwavegan_torch.ops.spectral import stft_magnitude
    from parallelwavegan_torch.utils.params import fold_weight_norm

    if name == "conv_transpose1d":  # HiFi-GAN v1's first upsample
        return ((lambda x, w, b: conv.conv_transpose1d(x, w, b, 8, 4)),
                [(2, 32, 512), (16, 512, 256), (256,)],
                ["from (B, C, T)", "contiguous", "contiguous"], (1,))
    if name == "grouped strided conv1d":  # the MelGAN discriminator's
        return ((lambda x, w, b: conv.conv1d(x, w, b, 20, stride=4,
                                             groups=16)),
                [(2, 4096, 64), (41, 4, 256), (256,)],
                ["from (B, C, T)", "contiguous", "contiguous"], ())
    if name == "period conv2d":  # the period discriminator's (5, 1)
        return ((lambda x, w, b: conv.conv2d(x, w, b, (3, 1), (2, 0))),
                [(2, 1366, 3, 32), (5, 1, 32, 128), (128,)],
                ["contiguous"] * 3, ())
    if name == "instance norm of nearest upsampling":  # StyleMelGAN's TADE
        return ((lambda x: instance_norm_1d(conv.upsample_nearest_time(x, 2))),
                [(2, 2048, 64)], ["from (B, C, T)"], ())
    if name == "reflect pad":  # the MelGAN generator's first pad
        return ((lambda x: conv.pad1d(x, (3, 3), "reflect")),
                [(2, 512, 80)], ["contiguous"], ())
    if name == "token table":  # the duration recipe's F.embedding
        ids = torch.randint(0, 1025, (2, 64),
                            generator=torch.Generator().manual_seed(5))
        ids[:, :8] = 7  # a token taken many times

        def lookup(table):
            return torch.nn.functional.embedding(ids.to(table.device), table)
        return lookup, [(1025, 512)], ["contiguous"], ()
    if name == "pqmf analysis":  # MB-MelGAN's subbands
        return ((lambda x: pqmf.pqmf_analysis(x)), [(2, 16384, 1)],
                ["contiguous"], ())
    if name == "weight norm":  # linalg.vector_norm of a kernel
        return ((lambda v, g: fold_weight_norm(v, g)),
                [(41, 4, 256), (1, 1, 256)], ["contiguous"] * 2, ())
    if name == "stft product":  # the STFT loss on the card: a matmul
        return ((lambda x: stft_magnitude(x, 1024, 120, 600,
                                          method="matmul")),
                [(2, 8192)], ["contiguous"], ())
    raise ValueError(name)


CENSUS_CASES = ["conv_transpose1d", "grouped strided conv1d",
                "period conv2d", "instance norm of nearest upsampling",
                "reflect pad", "token table", "pqmf analysis", "weight norm",
                "stft product"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CENSUS_CASES)
def test_census_op_on_card_is_as_close_to_float64_as_the_cpu(cuda_device,
                                                             name):
    """One op kind of the op census (tools/op_census.py) at a recipe's
    shape and the port's layout: forward and every gradient on the card
    as close to float64 as the CPU's f32, the avg_pool1d test's rule; an
    output whose rounding excess the census recorded within 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn, shapes, layouts, excess = _census_case(name)
    _card_as_close_to_float64_as_the_cpu(cuda_device, fn, shapes, layouts,
                                         excess=excess)


@pytest.mark.cuda
def test_op_census_replays_a_recipe_step_on_card(cuda_device):
    """The census's machinery on the card: a small MelGAN step recorded,
    every key replayed on the three routes and at its recorded shape, no
    key wrong."""
    from parallelwavegan_torch.tools import op_census

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = {
        "sampling_rate": 16000, "hop_size": 64, "num_mels": 16,
        "batch_max_steps": 4096, "batch_size": 4,
        "generator_type": "MelGANGenerator",
        "generator_params": {"in_channels": 16, "out_channels": 1,
                             "channels": 64, "upsample_scales": [4, 4, 4],
                             "stacks": 2},
        "discriminator_type": "MelGANMultiScaleDiscriminator",
        "discriminator_params": {"scales": 2, "channels": 16,
                                 "max_downsample_channels": 64,
                                 "downsample_scales": [4, 4]},
        "stft_loss_params": {"fft_sizes": [256], "hop_sizes": [64],
                             "win_lengths": [128]},
        "use_feat_match_loss": True,
    }
    result = op_census.run_census({"melgan": config}, cuda_device)
    op_census.report(result)
    kinds = result["kinds"]
    assert "mm" in kinds and "convolution_backward (1d, grouped, strided)" \
        in kinds
