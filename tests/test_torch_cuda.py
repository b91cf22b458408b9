"""The port's CUDA kernels on the card, against their plain versions.

Imports neither JAX nor the JAX package, so it runs on a GPU machine
without them; there, run it without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py

Without a GPU every test here skips.
"""

import numpy as np
import pytest
import torch

from parallelwavegan_torch.engine.checkpoint import save_generator_checkpoint
from parallelwavegan_torch.models import ParallelWaveGANGenerator
from parallelwavegan_torch.ops.cuda.wavenet_stack import (
    wavenet_stack,
    wavenet_stack_reference,
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
