"""The port's Conv1d, Conv2d, conv and pooling primitives, spectral norm,
upsample networks and residual block against their flax modules on the
same converted parameters (f32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelwavegan_tpu.layers.common import (
    Conv1d as FlaxConv1d,
    Conv2d as FlaxConv2d,
    kaiming_normal_relu_init as flax_kaiming,
)
from parallelwavegan_tpu.models.melgan import avg_pool1d as jax_avg_pool1d
from parallelwavegan_tpu.ops import conv as jax_conv_ops
from parallelwavegan_tpu.layers.residual_block import (
    WaveNetResidualBlock as FlaxBlock,
)
from parallelwavegan_tpu.layers.upsample import (
    ConvInUpsampleNetwork as FlaxConvInUpsample,
    UpsampleNetwork as FlaxUpsample,
)
from parallelwavegan_tpu.utils.params import fold_weight_norm as jax_fold
from parallelwavegan_torch.layers.common import (
    Conv1d,
    Conv2d,
    get_activation,
    torch_conv_default_init,
)
from parallelwavegan_torch.ops import conv as conv_ops
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


@pytest.mark.parametrize("kernel_size,padding,bias",
                         [(1, 0, True), (3, 1, True), (5, 2, False),
                          (3, 0, True)])
def test_conv1d_product_matches_flax(kernel_size, padding, bias):
    """``ops.conv.conv1d_product`` (the duration predictor's convs)
    against the flax conv on the same folded kernel, and its
    gradients against ``conv1d``'s."""
    from parallelwavegan_torch.ops.conv import conv1d, conv1d_product

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 29, 6)).astype(np.float32)
    flax_conv = FlaxConv1d(8, kernel_size, padding=padding, bias=bias,
                           use_weight_norm=False, kernel_init=flax_kaiming)
    v = _perturb(flax_conv.init(jax.random.key(0), jnp.asarray(x)), 3)
    y_ref = flax_conv.apply(v, jnp.asarray(x))
    kernel = torch.from_numpy(np.asarray(v["params"]["kernel"]))
    b = torch.from_numpy(np.asarray(v["params"]["bias"])) if bias else None
    xt = torch.from_numpy(x).requires_grad_()
    y = conv1d_product(xt, kernel, b, padding)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=1e-5)
    xc = torch.from_numpy(x).requires_grad_()
    cot = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    (g,) = torch.autograd.grad(y, xt, cot)
    (g_ref,) = torch.autograd.grad(conv1d(xc, kernel, b, padding), xc, cot)
    torch.testing.assert_close(g, g_ref, rtol=1e-5, atol=1e-5)


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
    np.testing.assert_allclose(
        get_activation("ELU", {"alpha": 0.5})(x).numpy(),
        [0.5 * np.expm1(-2.0), 0.5], rtol=1e-6)
    with pytest.raises(ValueError, match="unsupported activation"):
        get_activation("Hardswish")


@pytest.mark.parametrize("stride,groups,kernel_size,padding", [
    (2, 4, 41, 20), (4, 16, 41, 20), (1, 1, 15, 7), (3, 2, 5, 0)])
def test_strided_grouped_conv1d_matches_flax(stride, groups, kernel_size,
                                             padding):
    """The scale discriminator's convs: weight-normed, strided, grouped."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 131, 16)).astype(np.float32)
    flax_conv = FlaxConv1d(32, kernel_size, stride=stride, groups=groups,
                           padding=padding, use_weight_norm=True)
    v = _perturb(flax_conv.init(jax.random.key(0), jnp.asarray(x)), 6)
    y_ref = np.asarray(flax_conv.apply(v, jnp.asarray(x)))
    conv = Conv1d(16, 32, kernel_size, stride=stride, groups=groups,
                  padding=padding, use_weight_norm=True,
                  kernel_init=torch_conv_default_init, bias_init=None)
    assert conv.kernel_v.shape == (kernel_size, 16 // groups, 32)
    conv.load_state_dict(convert_jax_params(
        jax.tree.map(np.asarray, v["params"]), fold=False), strict=True)
    y = conv(torch.from_numpy(x)).detach().numpy()
    assert y.shape == y_ref.shape
    np.testing.assert_allclose(y, y_ref, atol=2e-5)


@pytest.mark.parametrize("kernel_size,stride,padding,weight_norm", [
    ((5, 1), (3, 1), (2, 0), True), ((2, 1), (1, 1), (1, 0), True),
    ((3, 3), (2, 1), (1, 1), False)])
def test_conv2d_matches_flax(kernel_size, stride, padding, weight_norm):
    """The period discriminator's (k, 1) convs on (B, T / p, p, C), with a
    4-d kernel_v and kernel_g of shape (1, 1, 1, Cout); forward and the
    gradients on every parameter."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 23, 3, 4)).astype(np.float32)
    flax_conv = FlaxConv2d(6, kernel_size, stride=stride, padding=padding,
                           use_weight_norm=weight_norm)
    v = _perturb(flax_conv.init(jax.random.key(0), jnp.asarray(x)), 8)
    y_ref, g_ref = jax.value_and_grad(
        lambda v: jnp.sum(flax_conv.apply(v, jnp.asarray(x)) ** 2))(v)
    conv = Conv2d(4, 6, kernel_size, stride=stride, padding=padding,
                  use_weight_norm=weight_norm)
    conv.load_state_dict(convert_jax_params(
        jax.tree.map(np.asarray, v["params"]), fold=False), strict=True)
    if weight_norm:
        assert conv.kernel_g.shape == (1, 1, 1, 6)
    y = conv(torch.from_numpy(x))
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(flax_conv.apply(v, jnp.asarray(x))),
        atol=2e-5)
    names = [n for n, _ in conv.named_parameters()]
    grads = torch.autograd.grad((y ** 2).sum(), list(conv.parameters()))
    want = convert_jax_params(jax.tree.map(np.asarray, g_ref["params"]),
                              fold=False)
    for name, grad in zip(names, grads):
        b = want[name].numpy()
        assert np.abs(grad.numpy() - b).max() <= 2e-5 * (1 + np.abs(b).max())
    # the folded form loads the folded tree
    folded = Conv2d(4, 6, kernel_size, stride=stride, padding=padding)
    folded.load_state_dict(convert_jax_params(
        jax.tree.map(np.asarray, v["params"])), strict=True)
    np.testing.assert_allclose(folded(torch.from_numpy(x)).detach().numpy(),
                               y.detach().numpy(), atol=1e-5)


def test_conv2d_init_is_torchs_uniform():
    conv = Conv2d(8, 16, (5, 1), generator=torch.Generator().manual_seed(1))
    bound = 1 / np.sqrt(5 * 8)
    assert conv.kernel.shape == (5, 1, 8, 16)
    assert conv.kernel.abs().max() <= bound and conv.bias.abs().max() <= bound
    assert conv.kernel.abs().max() > 0.9 * bound


@pytest.mark.parametrize("kernel_size,stride,padding,include", [
    (4, 2, 2, True), (4, 2, 1, False), (3, 1, 1, False), (4, 4, 0, True)])
def test_avg_pool1d_matches_jax(kernel_size, stride, padding, include):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 37, 3)).astype(np.float32)
    want = jax_avg_pool1d(jnp.asarray(x), kernel_size, stride, padding,
                          include)
    got = conv_ops.avg_pool1d(torch.from_numpy(x), kernel_size, stride,
                              padding, include)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("kernel_size,stride,padding,include", [
    (4, 2, 2, True), (4, 2, 1, False), (3, 1, 1, False), (4, 4, 0, True)])
def test_avg_pool1d_gradient_matches_jax(kernel_size, stride, padding,
                                         include):
    """The input gradient on a random cotangent, the input laid out as a
    transposed (B, C, T) tensor (as a discriminator hands it on)."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 37, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jax_avg_pool1d(v, kernel_size, stride,
                                              padding, include),
                     jnp.asarray(x))
    y = conv_ops.avg_pool1d(torch.from_numpy(x), kernel_size, stride,
                            padding, include)
    cot = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    (want,) = vjp(jnp.asarray(cot))
    leaf = torch.from_numpy(x.transpose(0, 2, 1).copy()).transpose(1, 2)
    leaf.requires_grad_()
    y = conv_ops.avg_pool1d(leaf, kernel_size, stride, padding, include)
    (got,) = torch.autograd.grad(y, leaf, torch.from_numpy(cot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("mode", ["zeros", "reflect", "replicate"])
def test_pad1d_modes_match_jax(mode):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 11, 3)).astype(np.float32)
    for pad in ((0, 4), (3, 2), (0, 0)):
        want = jax_conv_ops.pad1d(jnp.asarray(x), pad, mode)
        got = conv_ops.pad1d(torch.from_numpy(x), pad, mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="pad mode"):
        conv_ops.pad1d(torch.from_numpy(x), (1, 1), "circular")


@pytest.mark.parametrize("conv_type", ["conv1d", "conv2d"])
def test_spectral_norm_conv_matches_flax(conv_type):
    """Forward, the advanced u and the gradient of a spectral-normed conv
    against flax: one power iteration from the stored u, u stored only in
    training mode, and the kernel divided by a constant sigma. A spectral
    norm that differentiates through sigma (torch.nn.utils.spectral_norm)
    fails the gradient check: it is held to 2e-5 of the largest entry, and
    the term through sigma is of the gradient's own size."""
    rng = np.random.default_rng(11)
    if conv_type == "conv1d":
        x = rng.standard_normal((2, 50, 6)).astype(np.float32)
        flax_conv = FlaxConv1d(8, 5, padding=2, use_spectral_norm=True)
        conv = Conv1d(6, 8, 5, padding=2, use_spectral_norm=True,
                      kernel_init=torch_conv_default_init, bias_init=None,
                      generator=torch.Generator().manual_seed(0))
    else:
        x = rng.standard_normal((2, 20, 3, 6)).astype(np.float32)
        flax_conv = FlaxConv2d(8, (5, 1), stride=(3, 1), padding=(2, 0),
                               use_spectral_norm=True)
        conv = Conv2d(6, 8, (5, 1), stride=(3, 1), padding=(2, 0),
                      use_spectral_norm=True,
                      generator=torch.Generator().manual_seed(0))
    # the buffer starts at N(0, 1) / sqrt(Cout) from the generator
    assert conv.u.shape == (8,) and 0.05 < conv.u.std() < 1.0
    v = flax_conv.init(jax.random.key(0), jnp.asarray(x))
    v = {"params": _perturb({"params": v["params"]}, 12)["params"],
         "spectral": {"u": jnp.asarray(
             rng.standard_normal(8).astype(np.float32))}}
    conv.load_state_dict(convert_jax_params(
        jax.tree.map(np.asarray, v["params"]), fold=False,
        spectral=jax.tree.map(np.asarray, v["spectral"])), strict=True)
    assert sorted(conv.state_dict()) == ["bias", "kernel", "u"]
    xt = torch.from_numpy(x)

    # eval mode: u stays
    y_ref = flax_conv.apply(v, jnp.asarray(x), True)
    conv.eval()
    y = conv(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=2e-5)
    np.testing.assert_array_equal(conv.u.numpy(), np.asarray(
        v["spectral"]["u"]))

    # training mode: two passes, u advances twice; gradient of the second
    conv.train()
    for _ in range(2):
        def loss(params, v=v):
            out, updated = flax_conv.apply(
                {"params": params, "spectral": v["spectral"]},
                jnp.asarray(x), False, mutable=["spectral"])
            return jnp.sum(out ** 2), (out, updated)

        (_, (y_ref, updated)), g_ref = jax.value_and_grad(
            loss, has_aux=True)(v["params"])
        y = conv(xt)
        grads = torch.autograd.grad((y ** 2).sum(), [conv.kernel, conv.bias])
        v = {"params": v["params"], "spectral": updated["spectral"]}
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                                   atol=2e-5)
        np.testing.assert_allclose(conv.u.numpy(),
                                   np.asarray(v["spectral"]["u"]), atol=1e-6)
        for grad, name in zip(grads, ("kernel", "bias")):
            b = np.asarray(g_ref[name])
            err = np.abs(grad.numpy() - b).max()
            assert err <= 2e-5 * (1 + np.abs(b).max()), (name, err)
    assert not conv.u.requires_grad
    with pytest.raises(ValueError, match="use_weight_norm or"):
        Conv1d(6, 8, 5, use_weight_norm=True, use_spectral_norm=True)
