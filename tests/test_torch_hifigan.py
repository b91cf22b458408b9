"""HiFi-GAN modules of the port against the JAX package on the CPU: the
transposed conv, ConvTranspose1d (folded and trainable), the residual
block, the generator, and the flax-tree conversion with its weight-norm
fold in the stored dtype."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelwavegan_tpu.layers import ConvTranspose1d as FlaxConvTranspose1d
from parallelwavegan_tpu.layers import (
    HiFiGANResidualBlock as FlaxResidualBlock,
)
from parallelwavegan_tpu.models import HiFiGANGenerator as FlaxGenerator
from parallelwavegan_tpu.ops.conv import conv_transpose1d as jax_conv_t
from parallelwavegan_tpu.utils.params import (
    fold_weight_norm as jax_fold_weight_norm,
)
from parallelwavegan_torch.layers.common import (
    ConvTranspose1d,
    normal_init,
    uniform_bias_init_for,
)
from parallelwavegan_torch.layers.residual_block import HiFiGANResidualBlock
from parallelwavegan_torch.models import HiFiGANGenerator, get_model_class
from parallelwavegan_torch.ops.conv import conv_transpose1d
from parallelwavegan_torch.ops.hifigan_infer import hifigan_fast_forward
from parallelwavegan_torch.utils.params import (
    convert_jax_params,
    fold_weight_norm,
)

torch.set_num_threads(2)

SMALL = dict(
    in_channels=12, channels=32, kernel_size=7, upsample_scales=(4, 2),
    upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3, 5, 7),
    resblock_dilations=((1, 3), (1, 3), (1, 3)),
)


def perturbed(variables, seed=0):
    """Weight-norm g starts at ||v|| and every tree is tiny: move all."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: jnp.asarray(
            np.asarray(a) * (1 + 0.3 * rng.standard_normal(a.shape))
            + 0.02 * rng.standard_normal(a.shape), a.dtype), variables)


@pytest.mark.parametrize("stride,k,padding,output_padding", [
    (4, 8, 2, 0), (3, 6, 3, 1), (2, 4, 1, 0), (5, 10, 3, 1), (1, 3, 1, 0),
    (8, 16, 4, 0), (3, 7, 0, 2),
])
def test_conv_transpose1d_matches_jax(stride, k, padding, output_padding):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = np.asarray(jax_conv_t(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), stride, padding,
                                 output_padding))
    got = conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), stride, padding,
                           output_padding).numpy()
    assert got.shape == want.shape
    assert got.shape[1] == (11 - 1) * stride - 2 * padding + k + output_padding
    # f32 sums of 6 * ceil(k / stride) products in another order
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "trainable"])
def test_conv_transpose_module_matches_flax(fold):
    """Weight norm of a transposed conv is per input channel: kernel_g is
    (1, Cin, 1)."""
    flax = FlaxConvTranspose1d(5, 8, stride=4, padding=2,
                               use_weight_norm=True)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    v = perturbed(flax.init({"params": jax.random.key(0)}, jnp.asarray(x)))
    assert v["params"]["kernel_g"].shape == (1, 6, 1)
    want = np.asarray(flax.apply(v, jnp.asarray(x)))
    conv = ConvTranspose1d(6, 5, 8, stride=4, padding=2,
                           use_weight_norm=not fold)
    if not fold:
        assert tuple(conv.kernel_g.shape) == (1, 6, 1)
        # g starts at ||v|| over the kernel and output axes
        np.testing.assert_allclose(
            conv.kernel_g.detach().numpy()[0, :, 0],
            np.linalg.norm(conv.kernel_v.detach().numpy().transpose(1, 0, 2)
                           .reshape(6, -1), axis=1), rtol=1e-6)
    conv.load_state_dict(convert_jax_params(v["params"], fold=fold),
                         strict=True)
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fold_weight_norm_infers_axes_from_g():
    rng = np.random.default_rng(2)
    v = rng.standard_normal((8, 6, 5)).astype(np.float32)
    for g_shape, axes in (((1, 6, 1), (0, 2)), ((1, 1, 5), (0, 1))):
        g = rng.standard_normal(g_shape).astype(np.float32)
        want = v * g / np.sqrt((v * v).sum(axis=axes, keepdims=True))
        got = fold_weight_norm(torch.from_numpy(v), torch.from_numpy(g))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_hifigan_inits():
    gen = torch.Generator().manual_seed(0)
    w = normal_init(0.01)((11, 64, 64), gen)
    assert abs(w.std().item() - 0.01) < 5e-4 and abs(w.mean().item()) < 5e-4
    b = uniform_bias_init_for((3, 16, 8))((4096,), gen)
    bound = 1 / np.sqrt(48)
    assert b.abs().max().item() <= bound
    assert abs(b.std().item() - bound / np.sqrt(3)) < 5e-3


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "trainable"])
@pytest.mark.parametrize("additional", [True, False])
def test_residual_block_matches_flax(fold, additional):
    kw = dict(kernel_size=5, channels=8, dilations=(1, 3),
              use_additional_convs=additional)
    flax = FlaxResidualBlock(**kw)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 30, 8)).astype(np.float32)
    v = perturbed(flax.init({"params": jax.random.key(0)}, jnp.asarray(x)))
    want = np.asarray(flax.apply(v, jnp.asarray(x)))
    block = HiFiGANResidualBlock(**kw, use_weight_norm=not fold)
    block.load_state_dict(convert_jax_params(v["params"], fold=fold),
                          strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_residual_block_rejects_causal():
    """Causal blocks and generators build (tests/test_torch_settings.py
    holds them to flax); the fast forward, which serving's int8 and MRF
    modes run, rejects them, as the JAX package's int8 path does."""
    block = HiFiGANResidualBlock(channels=8, use_causal_conv=True)
    assert type(block.convs1[0]).__name__ == "CausalConv1d"
    gen = HiFiGANGenerator(in_channels=4, channels=16, upsample_scales=(2,),
                           upsample_kernel_sizes=(4,), use_causal_conv=True)
    with pytest.raises(NotImplementedError, match="non-causal"):
        hifigan_fast_forward(gen, torch.zeros((1, 5, 4)))


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "trainable"])
def test_generator_matches_flax(fold):
    """The small generator of tests/test_mrf_stage.py, f32, atol 1e-5."""
    flax = FlaxGenerator(**SMALL)
    rng = np.random.default_rng(4)
    c = rng.standard_normal((2, 40, 12)).astype(np.float32)
    v = perturbed(flax.init({"params": jax.random.key(0)},
                            jnp.asarray(c[:, :8])))
    want = np.asarray(flax.apply(v, jnp.asarray(c)))
    gen = get_model_class("HiFiGANGenerator")(**SMALL, folded=fold)
    state = convert_jax_params(v["params"], fold=fold)
    # conv, transposed conv, 6 blocks x 4 convs, each with a bias
    n_convs = 2 + 2 + 6 * 4
    assert len(state) == n_convs * (2 if fold else 3)
    gen.load_state_dict(state, strict=True)
    assert gen.upsample_factor == 8
    with torch.no_grad():
        got = gen(torch.from_numpy(c)).numpy()
    assert got.shape == want.shape == (2, 320, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fold_of_a_bf16_tree_matches_the_jax_fold():
    """A tree stored in bf16 folds in bf16 and is cast afterwards, as the
    JAX InferenceModel does. Reached: bit-equal folded kernels (both
    frameworks take the bf16 sum of squares in f32 and round once)."""
    flax = FlaxGenerator(**SMALL)
    v = perturbed(flax.init({"params": jax.random.key(0)},
                            jnp.zeros((1, 8, 12))), seed=5)
    tree = jax.tree.map(lambda a: a.astype(jnp.bfloat16), v["params"])
    want = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                        jax_fold_weight_norm(tree))
    got = convert_jax_params(jax.tree.map(np.asarray, tree))
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        key = ".".join(p.key for p in path)
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), leaf, err_msg=key)
        n += 1
    assert n == len(got) == 56
    # and it differs from folding in f32, which is what the repair is about
    f32 = convert_jax_params(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), tree))
    assert any(not torch.equal(f32[k], got[k]) for k in got)
