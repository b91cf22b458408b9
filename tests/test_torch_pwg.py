"""The port's Parallel WaveGAN generator (unfused forward and the fused
serving path with the plain stack) against the flax generator, on the same
converted parameters, noise and mel (f32, CPU)."""

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
    fuse_wavenet_stack_params as jax_fuse,
)
from parallelwavegan_tpu.utils.params import fold_weight_norm as jax_fold
from parallelwavegan_torch.models import ParallelWaveGANGenerator, get_model_class
from parallelwavegan_torch.ops.cuda.pwg_infer import (
    pwg_fused_forward,
    supports_fused_inference,
)
from parallelwavegan_torch.ops.cuda.wavenet_stack import (
    check_kernel_channels,
    fuse_wavenet_stack_params,
)
from parallelwavegan_torch.utils.params import convert_jax_params
from tests.torch_helpers import PWG_V1_KWARGS, flax_generator_kwargs

torch.set_num_threads(2)


def _pair(kwargs, B, frames, seed):
    """Flax generator + params, the port's generator loaded from them, and
    numpy inputs (c pre-padded by the context window)."""
    g = FlaxGenerator(**kwargs)
    rng = np.random.default_rng(seed)
    ctx = kwargs["aux_context_window"]
    c = rng.standard_normal((B, frames + 2 * ctx, kwargs["aux_channels"]))
    z = rng.standard_normal((B, frames * g.upsample_factor, 1))
    c, z = c.astype(np.float32), z.astype(np.float32)
    v = g.init({"params": jax.random.key(seed)}, jnp.asarray(z[:1]),
               jnp.asarray(c[:1]))
    port = ParallelWaveGANGenerator(**kwargs)
    params = jax.tree.map(np.asarray, v["params"])
    port.load_state_dict(convert_jax_params(params), strict=True)
    return g, v, port, c, z


@pytest.mark.parametrize("kwargs,B,frames", [
    (flax_generator_kwargs(), 2, 40),
    (PWG_V1_KWARGS, 2, 6),
], ids=["small", "pwg_v1_width"])
def test_generator_matches_flax(kwargs, B, frames):
    g, v, port, c, z = _pair(kwargs, B, frames, seed=0)
    y_ref = np.asarray(g.apply(v, jnp.asarray(z), jnp.asarray(c)))
    zt, ct = torch.from_numpy(z), torch.from_numpy(c)
    with torch.inference_mode():
        y_plain = port(zt, ct).numpy()
        y_fused = pwg_fused_forward(port, zt, ct).numpy()
    assert y_plain.shape == y_ref.shape == (B, frames * g.upsample_factor, 1)
    # the JAX package's own fused-vs-flax tolerance
    np.testing.assert_allclose(y_plain, y_ref, atol=1e-4)
    np.testing.assert_allclose(y_fused, y_ref, atol=1e-4)


def test_fused_forward_matches_jax_fused_forward():
    g, v, port, c, z = _pair(flax_generator_kwargs(), 2, 24, seed=1)
    y_ref = jax_pwg_fused_forward(g, v, jnp.asarray(z), jnp.asarray(c),
                                  use_kernel=False)
    with torch.inference_mode():
        y = pwg_fused_forward(port, torch.from_numpy(z), torch.from_numpy(c))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4)


def test_fused_params_match_jax_layout():
    g, v, port, _, _ = _pair(flax_generator_kwargs(layers=4), 1, 4, seed=2)
    ref = jax_fuse(jax_fold(v["params"]), range(4))
    w = fuse_wavenet_stack_params(port.conv_layers)
    for key in ("w_tap", "b_tap", "w_aux", "w_so", "b_so"):
        np.testing.assert_allclose(w[key].detach().numpy(),
                                   np.asarray(ref[key]), rtol=1e-6,
                                   atol=1e-7, err_msg=key)


def test_generator_inference_pads_and_draws_noise():
    g, v, port, c, _ = _pair(flax_generator_kwargs(), 1, 10, seed=3)
    mel = torch.from_numpy(c[0, 2:-2])
    z = torch.randn((1, 10 * port.upsample_factor, 1),
                    generator=torch.Generator().manual_seed(0))
    mean, scale = torch.full((20,), 0.5), torch.full((20,), 2.0)
    with torch.inference_mode():
        y = port.inference(mel, z=z)
        y_default = port.inference(mel)
        y_norm = port.inference(mel * scale + mean, z=z,
                                normalize_before=True, mean=mean, scale=scale)
    y_ref = g.apply(v, jnp.asarray(z.numpy()),
                    jnp.pad(jnp.asarray(mel.numpy())[None],
                            ((0, 0), (2, 2), (0, 0)), mode="edge"))[0]
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4)
    assert torch.equal(y, y_default)  # default noise: a generator seeded 0
    np.testing.assert_allclose(y_norm.numpy(), y.numpy(), atol=1e-5)


def test_generator_init_is_seeded_and_registry_names_family():
    a = ParallelWaveGANGenerator(**flax_generator_kwargs(),
                                 generator=torch.Generator().manual_seed(1))
    b = ParallelWaveGANGenerator(**flax_generator_kwargs(),
                                 generator=torch.Generator().manual_seed(1))
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    assert supports_fused_inference(a)
    assert get_model_class("ParallelWaveGANGenerator") is ParallelWaveGANGenerator
    assert get_model_class("HiFiGANGenerator").__name__ == "HiFiGANGenerator"
    assert get_model_class("MelGANGenerator").__name__ == "MelGANGenerator"
    assert get_model_class("UHiFiGANGenerator").__name__ == \
        "UHiFiGANGenerator"
    assert get_model_class("DiscreteSymbolHiFiGANGenerator").__name__ == \
        "DiscreteSymbolHiFiGANGenerator"
    with pytest.raises(NotImplementedError, match="NoSuchGenerator"):
        get_model_class("NoSuchGenerator")


def test_fused_path_names_what_it_does_not_support():
    gen = ParallelWaveGANGenerator(**flax_generator_kwargs(kernel_size=5))
    assert not supports_fused_inference(gen)
    z = torch.zeros((1, 4 * gen.upsample_factor, 1))
    c = torch.zeros((1, 4 + 2 * gen.aux_context_window, gen.aux_channels))
    with pytest.raises(NotImplementedError, match="kernel_size=5"):
        pwg_fused_forward(gen, z, c)
    check_kernel_channels(64, 128, 64)
    with pytest.raises(NotImplementedError, match="channels"):
        check_kernel_channels(32, 64, 32)
