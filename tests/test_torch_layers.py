"""The port's Conv1d, upsample networks and residual block against their
flax modules on the same converted parameters (f32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelwavegan_tpu.layers.common import (
    Conv1d as FlaxConv1d,
    kaiming_normal_relu_init as flax_kaiming,
)
from parallelwavegan_tpu.layers.residual_block import (
    WaveNetResidualBlock as FlaxBlock,
)
from parallelwavegan_tpu.layers.upsample import (
    ConvInUpsampleNetwork as FlaxConvInUpsample,
    UpsampleNetwork as FlaxUpsample,
)
from parallelwavegan_tpu.utils.params import fold_weight_norm as jax_fold
from parallelwavegan_torch.layers.common import Conv1d, get_activation
from parallelwavegan_torch.layers.residual_block import WaveNetResidualBlock
from parallelwavegan_torch.layers.upsample import (
    ConvInUpsampleNetwork,
    UpsampleNetwork,
)
from parallelwavegan_torch.utils.params import convert_jax_params

torch.set_num_threads(2)


def _load(module, variables):
    params = jax.tree.map(np.asarray, variables["params"])
    module.load_state_dict(convert_jax_params(params), strict=True)
    return module


def _perturb(variables, seed):
    """Random parameters (the inits are often constant or zero)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.3 + 0.1,
                              a.dtype),
        variables,
    )


def test_convert_jax_params_folds_weight_norm():
    rng = np.random.default_rng(0)
    tree = {"a": {"kernel_v": rng.standard_normal((3, 4, 5)).astype(np.float32),
                  "kernel_g": rng.random((1, 1, 5)).astype(np.float32) + 0.5,
                  "bias": rng.standard_normal(5).astype(np.float32)},
            "b": {"kernel": rng.standard_normal((1, 2, 3)).astype(np.float32)}}
    sd = convert_jax_params(tree)
    assert sorted(sd) == ["a.bias", "a.kernel", "b.kernel"]
    folded = jax_fold(tree)
    for key in sd:
        mod, leaf = key.split(".")
        np.testing.assert_allclose(sd[key].numpy(), folded[mod][leaf],
                                   rtol=1e-6)


@pytest.mark.parametrize("kernel_size,dilation,padding,bias",
                         [(1, 1, 0, True), (3, 4, 4, True), (5, 1, 0, False),
                          (3, 2, (4, 0), True)])
def test_conv1d_matches_flax(kernel_size, dilation, padding, bias):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 37, 6)).astype(np.float32)
    flax_conv = FlaxConv1d(8, kernel_size, dilation=dilation, padding=padding,
                           bias=bias, use_weight_norm=True,
                           kernel_init=flax_kaiming)
    v = _perturb(flax_conv.init(jax.random.key(0), jnp.asarray(x)), 2)
    y_ref = flax_conv.apply(v, jnp.asarray(x))
    conv = _load(Conv1d(6, 8, kernel_size, dilation=dilation, padding=padding,
                        bias=bias), v)
    y = conv(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=1e-5)


def test_conv1d_init_draws_from_generator():
    """Kaiming-normal (relu) kernel from the given generator, zero bias."""
    a = Conv1d(40, 80, 3, generator=torch.Generator().manual_seed(5))
    b = Conv1d(40, 80, 3, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.kernel, b.kernel) and not a.bias.any()
    assert abs(a.kernel.std().item() / np.sqrt(2 / 120) - 1) < 0.05


@pytest.mark.parametrize("scales,fk,act", [([4, 4], 1, None),
                                          ([2, 3], 3, "LeakyReLU")])
def test_upsample_network_matches_flax(scales, fk, act):
    rng = np.random.default_rng(3)
    c = rng.standard_normal((2, 9, 10)).astype(np.float32)
    act_params = {"negative_slope": 0.2} if act else None
    flax_up = FlaxUpsample(upsample_scales=tuple(scales),
                           freq_axis_kernel_size=fk,
                           nonlinear_activation=act,
                           nonlinear_activation_params=act_params)
    v = _perturb(flax_up.init(jax.random.key(0), jnp.asarray(c)), 4)
    y_ref = flax_up.apply(v, jnp.asarray(c))
    up = _load(UpsampleNetwork(scales, act, act_params,
                               freq_axis_kernel_size=fk), v)
    y = up(torch.from_numpy(c))
    assert y.shape == (2, 9 * int(np.prod(scales)), 10)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=1e-5)


def test_conv_in_upsample_network_matches_flax():
    rng = np.random.default_rng(5)
    c = rng.standard_normal((2, 12 + 4, 20)).astype(np.float32)
    flax_up = FlaxConvInUpsample(upsample_scales=(4, 4), aux_channels=20,
                                 aux_context_window=2)
    v = _perturb(flax_up.init(jax.random.key(0), jnp.asarray(c)), 6)
    y_ref = flax_up.apply(v, jnp.asarray(c))
    up = _load(ConvInUpsampleNetwork([4, 4], aux_channels=20,
                                     aux_context_window=2), v)
    np.testing.assert_allclose(up(torch.from_numpy(c)).detach().numpy(),
                               np.asarray(y_ref), atol=1e-5)


def test_residual_block_matches_flax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 50, 16)).astype(np.float32)
    c = rng.standard_normal((2, 50, 12)).astype(np.float32)
    kw = dict(residual_channels=16, gate_channels=32, skip_channels=8,
              aux_channels=12, dilation=4)
    flax_blk = FlaxBlock(**kw)
    v = _perturb(flax_blk.init(jax.random.key(0), jnp.asarray(x),
                               jnp.asarray(c)), 8)
    x_ref, s_ref = flax_blk.apply(v, jnp.asarray(x), jnp.asarray(c))
    blk = _load(WaveNetResidualBlock(**kw), v)
    xo, so = blk(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(xo.detach().numpy(), np.asarray(x_ref),
                               atol=1e-5)
    np.testing.assert_allclose(so.detach().numpy(), np.asarray(s_ref),
                               atol=1e-5)


def test_get_activation_covers_the_slice():
    x = torch.tensor([-2.0, 0.5])
    assert torch.equal(get_activation(None)(x), x)
    assert torch.equal(get_activation("ReLU")(x), torch.tensor([0.0, 0.5]))
    np.testing.assert_allclose(
        get_activation("LeakyReLU", {"negative_slope": 0.2})(x).numpy(),
        [-0.4, 0.5])
    with pytest.raises(NotImplementedError, match="ELU"):
        get_activation("ELU")
