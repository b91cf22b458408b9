"""The settings the JAX package takes that no shipped recipe sets, in the
port against flax on the CPU: every activation of the registry, the
causal WaveNet block, upsample networks and HiFi-GAN block and generator,
WaveNet dropout (the generator's and the residual discriminator's) on the
port's keep masks handed to flax (``torch_helpers.FlaxMasks``), and
Parallel WaveGAN's ``upsample_net: UpsampleNetwork`` and
``upsample_net: MelGANGenerator``; forwards on converted perturbed
parameters, and one train step of each on the per-layer path against the
JAX step. The fused CUDA path keeps refusing causal and dropout
generators, naming the setting that turns it off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelwavegan_tpu.layers.common import (
    get_activation as jax_activation,
)
from parallelwavegan_tpu.layers.residual_block import (
    HiFiGANResidualBlock as FlaxHiFiGANBlock,
    WaveNetResidualBlock as FlaxWaveNetBlock,
)
from parallelwavegan_tpu.layers.upsample import (
    ConvInUpsampleNetwork as FlaxConvInUpsample,
    UpsampleNetwork as FlaxUpsample,
)
from parallelwavegan_tpu.models import get_model_class as jax_model_class
from parallelwavegan_torch.engine.step import DROPOUT_STREAM, step_generator
from parallelwavegan_torch.layers.common import get_activation
from parallelwavegan_torch.layers.residual_block import (
    HiFiGANResidualBlock,
    WaveNetResidualBlock,
)
from parallelwavegan_torch.layers.upsample import (
    ConvInUpsampleNetwork,
    UpsampleNetwork,
)
from parallelwavegan_torch.models import get_model_class
from parallelwavegan_torch.ops.cuda.pwg_infer import (
    unsupported_fused_settings,
)
from parallelwavegan_torch.ops.hifigan_infer import hifigan_fast_forward
from parallelwavegan_torch.utils.model_loader import InferenceModel
from parallelwavegan_torch.utils.params import convert_jax_params
from tests.torch_helpers import (
    FlaxMasks,
    as_jax,
    as_torch,
    assert_first_moment,
    assert_losses,
    assert_params,
    both_train_states,
    flax_generator_kwargs,
    melgan_perturbed,
    sine_batch,
    small_melgan_train_config,
)

torch.set_num_threads(2)

# forwards: max |port - flax| <= TOL (1 + max |flax|), f32 on the CPU
TOL = 1e-5


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * (1 + np.abs(want).max()), (what, err)


def _load(module, variables, fold=True):
    params = jax.tree.map(np.asarray, variables["params"])
    module.load_state_dict(convert_jax_params(params, fold=fold), strict=True)
    return module


def _perturbed(module, *inputs, seed=0):
    return jax.tree.map(np.asarray, melgan_perturbed(
        module.init({"params": jax.random.key(seed)},
                    *[jnp.asarray(a) for a in inputs]), seed))


@pytest.mark.parametrize("name,params", [
    ("ELU", {"alpha": 0.5}), ("ELU", None), ("GELU", None), ("Tanh", None),
    ("Sigmoid", None), ("Softmax", None), ("SiLU", None), ("Swish", None),
    ("LeakyReLU", {"negative_slope": 0.3}), ("ReLU", None), (None, None),
], ids=lambda v: str(v))
def test_activation_matches_jax(name, params):
    """Each name of the JAX registry to 1e-6 (1 + max) on (B, T, C) inputs:
    GELU is the tanh approximation (flax's default), Softmax runs over the
    channels (the last axis)."""
    x = np.random.default_rng(1).standard_normal((2, 7, 5)).astype(
        np.float32) * 3
    want = jax_activation(name, params)(jnp.asarray(x))
    got = get_activation(name, params)(torch.from_numpy(x))
    _close(got, want, 1e-6, name)


def test_unknown_activation_raises_as_in_jax():
    with pytest.raises(ValueError, match="unsupported activation: Mish"):
        jax_activation("Mish")
    with pytest.raises(ValueError, match="unsupported activation: Mish"):
        get_activation("Mish")


@pytest.mark.parametrize("kernel_size", [2, 3, 4])
def test_causal_wavenet_block_matches_flax(kernel_size):
    """Causal blocks (any kernel size, the conv padded on the left) with a
    condition, folded and in the training form; the output at t does not
    move when the input after t does."""
    kw = dict(kernel_size=kernel_size, residual_channels=8, gate_channels=16,
              skip_channels=6, aux_channels=5, dilation=3,
              use_causal_conv=True)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 23, 8)).astype(np.float32)
    c = rng.standard_normal((2, 23, 5)).astype(np.float32)
    flax = FlaxWaveNetBlock(**kw)
    v = _perturbed(flax, x, c)
    want = flax.apply(v, jnp.asarray(x), jnp.asarray(c))
    for fold in (True, False):
        block = _load(WaveNetResidualBlock(**kw, use_weight_norm=not fold),
                      v, fold)
        xo, s = block(torch.from_numpy(x), torch.from_numpy(c))
        _close(xo, want[0], what="x")
        _close(s, want[1], what="skip")
    x2 = x.copy()
    x2[:, 15:] += 1.0
    xo2, _ = block(torch.from_numpy(x2), torch.from_numpy(c))
    assert torch.equal(xo2[:, :15], xo[:, :15])


def test_wavenet_block_dropout_matches_flax(monkeypatch):
    """flax's Dropout on the port's keep mask (handed to flax through
    ``FlaxMasks``) at rate 0.3; without a mask the block is deterministic,
    as flax's with ``deterministic=True``."""
    kw = dict(residual_channels=8, gate_channels=16, skip_channels=6,
              aux_channels=5, dilation=2, dropout=0.3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 19, 8)).astype(np.float32)
    c = rng.standard_normal((2, 19, 5)).astype(np.float32)
    flax = FlaxWaveNetBlock(**kw)
    v = _perturbed(flax, x, c)
    block = _load(WaveNetResidualBlock(**kw), v)
    mask = torch.rand((2, 19, 8), generator=torch.Generator().manual_seed(
        4)) < 0.7
    stand_in = FlaxMasks([mask.numpy()])
    monkeypatch.setattr("flax.linen.stochastic.random", stand_in)
    want = flax.apply(v, jnp.asarray(x), jnp.asarray(c), False,
                      rngs={"dropout": jax.random.key(0)})
    assert not stand_in.masks
    got = block(torch.from_numpy(x), torch.from_numpy(c), mask)
    _close(got[0], want[0], what="x")
    _close(got[1], want[1], what="skip")
    plain = flax.apply(v, jnp.asarray(x), jnp.asarray(c))
    _close(block(torch.from_numpy(x), torch.from_numpy(c))[0], plain[0])


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
def test_upsample_networks_match_flax(causal):
    """``UpsampleNetwork`` (freq kernel 3, a Tanh after each stage) and
    ``ConvInUpsampleNetwork`` (context window 2), causal or not; the causal
    ones keep the output at t when the input after t's frame moves."""
    rng = np.random.default_rng(5)
    c = rng.standard_normal((2, 9, 10)).astype(np.float32)
    kw = dict(upsample_scales=(3, 2), freq_axis_kernel_size=3,
              nonlinear_activation="Tanh", use_causal_conv=causal)
    flax = FlaxUpsample(**kw)
    v = _perturbed(flax, c)
    up = _load(UpsampleNetwork(**{**kw, "upsample_scales": [3, 2]}), v)
    _close(up(torch.from_numpy(c)), flax.apply(v, jnp.asarray(c)),
           what="UpsampleNetwork")
    cc = rng.standard_normal((2, 12 + 4, 10)).astype(np.float32)
    flax_in = FlaxConvInUpsample(upsample_scales=(4, 2), aux_channels=10,
                                 aux_context_window=2, use_causal_conv=causal)
    v = _perturbed(flax_in, cc)
    up_in = _load(ConvInUpsampleNetwork([4, 2], aux_channels=10,
                                        aux_context_window=2,
                                        use_causal_conv=causal), v)
    got = up_in(torch.from_numpy(cc))
    _close(got, flax_in.apply(v, jnp.asarray(cc)), what="ConvIn")
    if causal:
        moved = up(torch.from_numpy(np.concatenate(
            [c[:, :5], c[:, 5:] + 1.0], axis=1)))
        assert torch.equal(moved[:, :5 * 6], up(torch.from_numpy(c))[:, :30])


def test_causal_hifigan_block_matches_flax():
    kw = dict(kernel_size=3, channels=8, dilations=(1, 3),
              use_causal_conv=True)
    x = np.random.default_rng(6).standard_normal((2, 21, 8)).astype(
        np.float32)
    flax = FlaxHiFiGANBlock(**kw)
    v = _perturbed(flax, x)
    for fold in (True, False):
        block = _load(HiFiGANResidualBlock(**kw, use_weight_norm=not fold), v,
                      fold)
        _close(block(torch.from_numpy(x)), flax.apply(v, jnp.asarray(x)))


# generator settings: name -> (generator_type, generator_params, input
# builder); each forward is held to flax on perturbed parameters
def _pwg(**kw):
    return dict(flax_generator_kwargs(
        layers=4, stacks=2, residual_channels=8, gate_channels=16,
        skip_channels=8, aux_channels=6, aux_context_window=2,
        upsample_params={"upsample_scales": [2, 3]}), **kw)


GENERATORS = {
    "pwg_causal": ("ParallelWaveGANGenerator", _pwg(use_causal_conv=True)),
    "pwg_causal_k2": ("ParallelWaveGANGenerator",
                      _pwg(use_causal_conv=True, kernel_size=2)),
    "pwg_upsample_network": ("ParallelWaveGANGenerator", _pwg(
        upsample_net="UpsampleNetwork", aux_context_window=0,
        upsample_params={"upsample_scales": [2, 3],
                         "freq_axis_kernel_size": 3,
                         "nonlinear_activation": "ELU",
                         "nonlinear_activation_params": {"alpha": 0.5}})),
    "pwg_melgan_upsample": ("ParallelWaveGANGenerator", _pwg(
        upsample_net="MelGANGenerator", aux_context_window=0,
        upsample_params={"upsample_scales": [2, 3], "in_channels": 6,
                         "out_channels": 6, "channels": 12, "stacks": 1,
                         "nonlinear_activation": "GELU"})),
    "pwg_no_upsample": ("ParallelWaveGANGenerator",
                        _pwg(upsample_conditional_features=False)),
    "hifigan_causal": ("HiFiGANGenerator", dict(
        in_channels=6, channels=16, upsample_scales=(2, 3),
        upsample_kernel_sizes=(4, 6), resblock_kernel_sizes=(3, 5),
        resblock_dilations=((1, 2), (1, 3)), use_causal_conv=True,
        nonlinear_activation="SiLU")),
}


def _generator_inputs(name, frames=11):
    gen_type, kw = GENERATORS[name]
    rng = np.random.default_rng(7)
    if gen_type == "HiFiGANGenerator":
        return (rng.standard_normal((2, frames, 6)).astype(np.float32),)
    ctx = kw["aux_context_window"]
    c_len = frames + 2 * ctx
    if kw.get("upsample_conditional_features") is False:
        c_len = frames * 6  # the condition comes at the sample rate
    c = rng.standard_normal((2, c_len, 6)).astype(np.float32)
    z = rng.standard_normal((2, frames * 6, 1)).astype(np.float32)
    return z, c


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_settings_match_flax(name):
    """The generator forward, folded and in the training form, to 1e-5
    (1 + max); a causal one's output before a frame does not see a change
    of that frame's input."""
    gen_type, kw = GENERATORS[name]
    inputs = _generator_inputs(name)
    flax = jax_model_class(gen_type)(**kw)
    v = _perturbed(flax, *inputs)
    want = flax.apply(v, *[jnp.asarray(a) for a in inputs])
    t_inputs = [torch.from_numpy(a) for a in inputs]
    for folded in (True, False):
        gen = _load(get_model_class(gen_type)(**kw, folded=folded), v, folded)
        got = gen(*t_inputs)
        _close(got, want, what=f"{name} folded={folded}")
    if kw.get("use_causal_conv"):
        # HiFi-GAN pads its causal transposed convs by replicating a frame
        # on the left; every output before frame 6's samples stays
        moved = [a.clone() for a in t_inputs]
        moved[-1][:, 6 + kw.get("aux_context_window", 0):] += 1.0
        assert torch.equal(gen(*moved)[:, :6 * 6], got[:, :6 * 6])


def test_causal_hifigan_serves_through_the_module_forward():
    """``InferenceModel`` serves a causal HiFi-GAN by its module forward (the
    fast forward refuses it, as the JAX int8 path does), equal to the JAX
    ``InferenceModel``'s."""
    from parallelwavegan_tpu.utils.model_loader import (
        InferenceModel as JaxInferenceModel,
    )

    gen_type, kw = GENERATORS["hifigan_causal"]
    config = {"generator_type": gen_type, "generator_params": kw,
              "num_mels": 6, "hop_size": 6, "sampling_rate": 600}
    (mel,) = _generator_inputs("hifigan_causal", frames=13)
    v = _perturbed(jax_model_class(gen_type)(**kw), mel)
    want = JaxInferenceModel(config, v).inference(mel[0])
    model = InferenceModel(config, v, device="cpu")
    _close(model.inference(mel[0]), want)
    with pytest.raises(NotImplementedError, match="non-causal"):
        hifigan_fast_forward(model.generator, torch.from_numpy(mel))
    with pytest.raises(ValueError, match="non-causal"):
        model.quantize_int8([mel[0]])


@pytest.mark.parametrize("setting,expected", [
    ({"use_causal_conv": True}, "use_causal_conv=True"),
    ({"dropout": 0.1}, "dropout=0.1"),
])
def test_fused_paths_refuse_causal_and_dropout(setting, expected):
    """The fused path lacks causal and dropout stacks: asked for it
    (``inference_fused_wavenet: true``, which on the CPU runs the stack's
    plain version), ``InferenceModel`` refuses them naming the setting that
    selects the per-layer path, and ``unsupported_fused_settings`` (which
    the train step reads on the card, naming ``fused_wavenet: false``)
    lists them; with the setting off the module forward serves."""
    kw = _pwg(**setting)
    gen = get_model_class("ParallelWaveGANGenerator")(**kw)
    assert unsupported_fused_settings(gen) == [expected]
    config = {"generator_type": "ParallelWaveGANGenerator",
              "generator_params": kw, "num_mels": 6, "hop_size": 6,
              "inference_fused_wavenet": True}
    variables = {"params": {k: v.detach().numpy()
                            for k, v in gen.state_dict().items()}}
    from parallelwavegan_torch.utils.params import nested

    variables = {"params": nested(variables["params"])}
    with pytest.raises(NotImplementedError,
                       match="inference_fused_wavenet: false"):
        InferenceModel(config, variables, device="cpu")
    config["inference_fused_wavenet"] = False
    wave = InferenceModel(config, variables, device="cpu").inference(
        np.zeros((5, 6), np.float32))
    assert wave.shape == (30, 1)


# one train step on the per-layer path, on small_melgan_train_config's
# pwg_v3 shape with these generator and discriminator settings
STEP_SETTINGS = {
    "dropout": (dict(dropout=0.2), "ResidualParallelWaveGANDiscriminator",
                dict(layers=4, stacks=2, residual_channels=8,
                     gate_channels=16, skip_channels=8,
                     nonlinear_activation="ELU",
                     nonlinear_activation_params={"alpha": 0.5})),
    "causal_upsample_network": (
        dict(use_causal_conv=True, upsample_net="UpsampleNetwork",
             aux_context_window=0,
             upsample_params={"upsample_scales": [4, 4, 4],
                              "nonlinear_activation": "Tanh"}),
        "ParallelWaveGANDiscriminator",
        dict(layers=4, conv_channels=8, nonlinear_activation="SiLU")),
    "melgan_upsample": (
        dict(upsample_net="MelGANGenerator", aux_context_window=0,
             upsample_params={"upsample_scales": [4, 4, 4],
                              "in_channels": 16, "out_channels": 16,
                              "channels": 64, "stacks": 1,
                              "nonlinear_activation": "GELU"}),
        "ParallelWaveGANDiscriminator",
        dict(layers=4, conv_channels=8, nonlinear_activation="Sigmoid")),
}


def _step_config(setting):
    gen_kw, d_type, d_kw = STEP_SETTINGS[setting]
    config = small_melgan_train_config("pwg_v3")
    gp = dict(config["generator_params"], kernel_size=3, **gen_kw)
    return dict(config, generator_params=gp, discriminator_type=d_type,
                discriminator_params=d_kw, use_feat_match_loss=False,
                fused_wavenet=False)


def _step_masks(t_state, batch):
    """The keep masks the port's step draws from its dropout stream, in
    order: the generator update's forward, then the discriminator update's
    recompute."""
    g = step_generator(0, 0, DROPOUT_STREAM)
    B, T = batch["z"].shape[:2]
    return [m for _ in range(2)
            for m in t_state.generator.draw_dropout_masks(B, T, g)]


@pytest.mark.parametrize("setting", sorted(STEP_SETTINGS))
def test_train_step_with_setting_matches_jax(setting, monkeypatch):
    """One G+adv+D step on the same perturbed parameters, batch and (for
    dropout) keep masks: the losses to 1e-5 relative, the updated
    parameters to 1e-6 absolute, the gradients through the optimizers'
    first moments (``assert_first_moment``'s default rule)."""
    config = _step_config(setting)
    state, (factory, _), t_state, (t_factory, _) = both_train_states(config)
    batch = sine_batch(config)
    stand_in = None
    if setting == "dropout":
        stand_in = FlaxMasks([m.numpy() for m in _step_masks(t_state,
                                                             batch)])
        monkeypatch.setattr("flax.linen.stochastic.random", stand_in)
    new_state, ref = factory(True, True, True)(state, as_jax(batch),
                                               jax.random.key(0))
    if stand_in is not None:
        assert not stand_in.masks  # every mask taken, in order
    _, metrics = t_factory(True, True, True)(
        t_state, as_torch(batch),
        dropout_rng=step_generator(0, 0, DROPOUT_STREAM))
    names = ["spectral_convergence_loss", "log_stft_magnitude_loss",
             "adversarial_loss", "generator_loss", "real_loss", "fake_loss",
             "discriminator_loss"]
    assert_losses(metrics, ref, names, rtol=1e-5)
    assert_params(t_state.generator, new_state.params_g, 1e-6, "G")
    assert_params(t_state.discriminator, new_state.params_d, 1e-6, "D")
    assert_first_moment(t_state.opt_g, new_state.opt_g, "G")
    assert_first_moment(t_state.opt_d, new_state.opt_d, "D")


def test_dropout_step_needs_its_dropout_source():
    config = _step_config("dropout")
    _, _, t_state, (t_factory, _) = both_train_states(config)
    with pytest.raises(ValueError, match="DROPOUT_STREAM"):
        t_factory(True, True, True)(t_state, as_torch(sine_batch(config)))


def test_residual_discriminator_dropout_trains_where_the_jax_step_cannot(
        monkeypatch):
    """The residual discriminator's dropout: its forward on the port's keep
    masks equals flax's on the same masks; the JAX step passes the
    discriminator no "dropout" random stream, so its discriminator update
    fails (flax's ``InvalidRngError``), where the port's step draws the
    masks (one pass over real and fake, after the generator's) and
    trains."""
    import flax

    config = _step_config("dropout")
    config["discriminator_params"] = dict(config["discriminator_params"],
                                          dropout=0.2)
    state, (factory, _), t_state, (t_factory, _) = both_train_states(config)
    batch = sine_batch(config)
    with pytest.raises(flax.errors.InvalidRngError, match="dropout"):
        factory(False, False, True)(state, as_jax(batch), jax.random.key(0))
    dis = t_state.discriminator
    x = batch["y"]
    masks = dis.draw_dropout_masks(*x.shape[:2], torch.Generator()
                                   .manual_seed(3))
    assert len(masks) == 4
    stand_in = FlaxMasks([m.numpy() for m in masks])
    monkeypatch.setattr("flax.linen.stochastic.random", stand_in)
    d_type = config["discriminator_type"]
    want = jax_model_class(d_type)(**config["discriminator_params"]).apply(
        {"params": state.params_d}, jnp.asarray(x), False,
        rngs={"dropout": jax.random.key(0)})
    assert not stand_in.masks
    with torch.no_grad():
        _close(dis(torch.from_numpy(x), masks), want)
        _close(dis(torch.from_numpy(x)), jax_model_class(d_type)(
            **config["discriminator_params"]).apply(
                {"params": state.params_d}, jnp.asarray(x)))
    before = {k: v.detach().clone() for k, v in t_state.params_d.items()}
    _, metrics = t_factory(True, True, True)(
        t_state, as_torch(batch),
        dropout_rng=step_generator(0, 0, DROPOUT_STREAM))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert any(not torch.equal(before[k], v)
               for k, v in t_state.params_d.items())
