"""The MelGAN generator and its layers in the port against the JAX package
on the CPU: the replicate pad, the causal convs with each pad mode, the
residual stack (causal and not), the generator with one output and four
subbands (causal and not), folded and trainable, and chip_smoke's MelGAN
configurations against their yaml files."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from parallelwavegan_tpu.layers import CausalConv1d as FlaxCausalConv1d
from parallelwavegan_tpu.layers import (
    CausalConvTranspose1d as FlaxCausalConvTranspose1d,
)
from parallelwavegan_tpu.layers import ResidualStack as FlaxResidualStack
from parallelwavegan_tpu.layers.common import (
    pad_mode_from_torch as jax_pad_mode_from_torch,
)
from parallelwavegan_tpu.models import MelGANGenerator as FlaxMelGAN
from parallelwavegan_tpu.ops.conv import pad1d as jax_pad1d
from parallelwavegan_torch.layers.causal_conv import (
    CausalConv1d,
    CausalConvTranspose1d,
)
from parallelwavegan_torch.layers.common import pad_mode_from_torch
from parallelwavegan_torch.layers.residual_stack import ResidualStack
from parallelwavegan_torch.models import MelGANGenerator, get_model_class
from parallelwavegan_torch.ops.conv import pad1d
from parallelwavegan_torch.utils.params import convert_jax_params
from tests.torch_helpers import melgan_perturbed

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PADS = ["ConstantPad1d", "ReflectionPad1d", "ReplicationPad1d"]
FOLD = pytest.mark.parametrize("fold", [True, False],
                               ids=["folded", "trainable"])
SMALL = dict(in_channels=10, channels=32, kernel_size=7,
             upsample_scales=(4, 2), stacks=2)


def flax_run(module, x, seed=0):
    v = melgan_perturbed(module.init(jax.random.key(seed), jnp.asarray(x)), seed)
    return v, np.asarray(module.apply(v, jnp.asarray(x)))


def assert_close(got, want, tol=1e-5):
    """|got - want| <= tol (1 + max |want|), on outputs of order one."""
    assert 0.05 < np.abs(want).max() < 50
    err = np.abs(got - want).max()
    assert err <= tol * (1 + np.abs(want).max()), err


def port_run(module, v, x, fold):
    module.load_state_dict(convert_jax_params(v["params"], fold=fold),
                           strict=True)
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


def test_pad1d_replicate_and_pad_names_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 9, 3)).astype(np.float32)
    for mode in ("zeros", "reflect", "replicate"):
        for pad in ((3, 0), (1, 4), (2, 2)):
            np.testing.assert_array_equal(
                pad1d(torch.from_numpy(x), pad, mode).numpy(),
                np.asarray(jax_pad1d(jnp.asarray(x), pad, mode)))
    for name in PADS + ["ZeroPad1d"]:
        assert pad_mode_from_torch(name) == jax_pad_mode_from_torch(name)
    with pytest.raises(ValueError, match="CircularPad1d"):
        pad_mode_from_torch("CircularPad1d")


@FOLD
@pytest.mark.parametrize("pad", PADS)
def test_causal_conv1d_matches_flax(pad, fold):
    x = np.random.default_rng(1).standard_normal((2, 13, 6)).astype(
        np.float32)
    v, want = flax_run(FlaxCausalConv1d(5, 3, dilation=2, pad=pad,
                                        use_weight_norm=True), x)
    got = port_run(CausalConv1d(6, 5, 3, dilation=2, pad=pad,
                                use_weight_norm=not fold), v, x, fold)
    assert got.shape == want.shape == (2, 13, 5)
    assert_close(got, want)
    # causal: a change at frame 7 leaves frames 0-6 alone
    x2 = x.copy()
    x2[:, 7] += 1.0
    got2 = port_run(CausalConv1d(6, 5, 3, dilation=2, pad=pad,
                                 use_weight_norm=not fold), v, x2, fold)
    np.testing.assert_array_equal(got2[:, :7], got[:, :7])


@FOLD
@pytest.mark.parametrize("pad", PADS)
def test_causal_conv_transpose1d_matches_flax(pad, fold):
    x = np.random.default_rng(2).standard_normal((2, 9, 6)).astype(np.float32)
    v, want = flax_run(FlaxCausalConvTranspose1d(4, 8, stride=4, pad=pad,
                                                 use_weight_norm=True), x)
    got = port_run(CausalConvTranspose1d(6, 4, 8, stride=4, pad=pad,
                                         use_weight_norm=not fold), v, x,
                   fold)
    assert got.shape == want.shape == (2, 36, 4)
    assert_close(got, want)


@FOLD
@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
def test_residual_stack_matches_flax(causal, fold):
    x = np.random.default_rng(3).standard_normal((2, 21, 8)).astype(
        np.float32)
    kw = dict(kernel_size=3, channels=8, dilation=3, use_causal_conv=causal)
    v, want = flax_run(FlaxResidualStack(**kw), x)
    got = port_run(ResidualStack(**kw, use_weight_norm=not fold), v, x, fold)
    assert got.shape == want.shape
    assert_close(got, want)


@FOLD
@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
@pytest.mark.parametrize("out", [1, 4], ids=["fullband", "multiband"])
def test_melgan_generator_matches_flax(out, causal, fold):
    kw = dict(SMALL, out_channels=out, use_causal_conv=causal)
    c = np.random.default_rng(4).standard_normal((2, 15, 10)).astype(
        np.float32)
    flax_kw = {k: v for k, v in kw.items() if k != "in_channels"}
    v, want = flax_run(FlaxMelGAN(**flax_kw), c)
    gen = get_model_class("MelGANGenerator")(**kw, folded=fold)
    got = port_run(gen, v, c, fold)
    assert got.shape == want.shape == (2, 15 * 8, out)
    assert gen.upsample_factor == FlaxMelGAN(**flax_kw).upsample_factor == 8
    assert_close(got, want)
    names = {k.split(".")[0] for k in gen.state_dict()}
    assert names == {f"layer_{i}" for i in range(2 + 2 * (1 + 2))}


def test_melgan_generator_options_match_flax():
    """No final tanh, replicate pads, ReLU, no bias."""
    kw = dict(SMALL, use_final_nonlinear_activation=False,
              pad="ReplicationPad1d", nonlinear_activation="ReLU",
              nonlinear_activation_params={}, bias=False, stack_kernel_size=5)
    c = np.random.default_rng(5).standard_normal((1, 11, 10)).astype(
        np.float32)
    v, want = flax_run(
        FlaxMelGAN(**{k: a for k, a in kw.items() if k != "in_channels"}), c)
    got = port_run(MelGANGenerator(**kw), v, c, True)
    assert np.abs(want).max() > 1.0  # no tanh
    assert_close(got, want)


def test_melgan_generator_refuses_what_jax_asserts():
    """The JAX module asserts both (l.82-83) when it is applied."""
    for bad in (dict(channels=8, upsample_scales=(4, 4)),
                dict(channels=36, upsample_scales=(2, 2, 2))):
        c = jnp.zeros((1, 4, 10))
        with pytest.raises(AssertionError):
            FlaxMelGAN(**bad).init(jax.random.key(0), c)
        with pytest.raises(ValueError, match="channels"):
            MelGANGenerator(in_channels=10, **bad)


def _yaml(name):
    with open(os.path.join(REPO, "egs", "ljspeech", "voc1", "conf",
                           name)) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("name,smoke", [
    ("multi_band_melgan.v2.yaml", "MB_MELGAN_V2"),
    ("melgan.v1.yaml", "MELGAN_V1"),
])
def test_smoke_melgan_configs_are_the_yaml(name, smoke):
    """chip_smoke serves these two at full width: its dicts hold the yaml's
    generator (and PQMF) settings."""
    want, got = _yaml(name), getattr(chip_smoke, smoke)
    for key in ("sampling_rate", "hop_size", "num_mels", "generator_type",
                "generator_params"):
        assert got[key] == want[key], key
    assert got.get("pqmf_params") == want.get("pqmf_params")
    assert got.get("version") == want.get("version")
