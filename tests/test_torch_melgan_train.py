"""Training of the MelGAN family in the port against the JAX package on the
CPU: the MelGAN and residual Parallel WaveGAN discriminators (folded and
trainable, and loaded from a reference ``.pkl``), one train step and four
steps with eval for the three recipe shapes of
``tests/torch_helpers.small_melgan_train_config`` (multi-band MelGAN with
the subband STFT loss, MelGAN against the Parallel WaveGAN discriminator,
the Parallel WaveGAN generator against the multi-scale MelGAN
discriminator), the mixed-precision multi-band step, ``.ckpt`` both ways,
the generator dispatch and the fusion default of the JAX step (fault C-2),
and the PQMF prototype a trained multi-band checkpoint serves with."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelwavegan_tpu.engine import checkpoint as jax_ckpt
from parallelwavegan_tpu.engine.build import (
    init_train_state as jax_init_train_state,
)
from parallelwavegan_tpu.engine.criterion import (
    build_criterion as jax_build_criterion,
)
from parallelwavegan_tpu.engine.step import (
    build_steps as jax_build_steps,
    make_generator_forward as jax_make_generator_forward,
)
from parallelwavegan_tpu.models import get_model_class as jax_model_class
from parallelwavegan_tpu.utils import torch_export as jax_export
from parallelwavegan_tpu.utils.model_loader import (
    InferenceModel as JaxInferenceModel,
)
from parallelwavegan_torch.bin.train import VERSION
from parallelwavegan_torch.engine import checkpoint as ckpt
from parallelwavegan_torch.engine.build import init_train_state
from parallelwavegan_torch.engine.criterion import build_criterion
from parallelwavegan_torch.engine.step import (
    build_steps,
    fuse_real_fake_default,
    make_generator_forward,
)
from parallelwavegan_torch.models import get_model_class
from parallelwavegan_torch.utils.model_loader import pqmf_for
from parallelwavegan_torch.utils.params import convert_jax_params
from tests.test_torch_reference_pkl import (
    _melgan_msd_name,
    _rpwg_d_name,
    reference_state_dict,
)
from tests.torch_helpers import (
    as_jax,
    as_torch,
    assert_first_moment,
    assert_losses,
    assert_params,
    both_train_states,
    melgan_perturbed,
    sine_batch,
    small_melgan_train_config,
)

torch.set_num_threads(2)

MELGAN_D = dict(channels=4, downsample_scales=(4, 4),
                max_downsample_channels=16)
DISCRIMINATORS = {
    "melgan": ("MelGANDiscriminator", dict(MELGAN_D)),
    "melgan_msd": ("MelGANMultiScaleDiscriminator",
                   dict(MELGAN_D, scales=3)),
    "residual_pwg": ("ResidualParallelWaveGANDiscriminator",
                     dict(layers=4, stacks=2, residual_channels=8,
                          gate_channels=16, skip_channels=8)),
}
CONFIGS = ("mb_melgan", "melgan_v1", "pwg_v3")
FLAGS = {"g_only": (True, False, False), "g_adv_d": (True, True, True),
         "d_only": (False, False, True)}
G_NAMES = ["spectral_convergence_loss", "log_stft_magnitude_loss",
           "generator_loss"]
SUB_NAMES = ["sub_spectral_convergence_loss", "sub_log_stft_magnitude_loss"]
D_NAMES = ["real_loss", "fake_loss", "discriminator_loss"]


def _leaves(outs):
    if not isinstance(outs, (list, tuple)):
        return [outs]
    return [t for o in outs for t in _leaves(o)]


def _flax_discriminator(which, T=509):
    """(name, kwargs, flax module, perturbed variables, input) of one of
    DISCRIMINATORS; T is odd so that the pooling and the strided convs
    meet ragged lengths."""
    name, kw = DISCRIMINATORS[which]
    x = np.random.default_rng(5).standard_normal((2, T, 1)).astype(
        np.float32)
    module = jax_model_class(name)(**kw)
    v = melgan_perturbed(module.init({"params": jax.random.key(0)},
                                     jnp.asarray(x)))
    return name, kw, module, jax.tree.map(np.asarray, v), x


def _assert_outputs(got, want, rtol, what):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, what
        err = np.abs(g.detach().numpy() - w).max()
        assert err <= rtol * (1 + np.abs(w).max()), (what, err)


@pytest.mark.parametrize("folded", [True, False], ids=["folded", "trainable"])
@pytest.mark.parametrize("which", sorted(DISCRIMINATORS))
def test_discriminators_match_flax(which, folded):
    """Every feature map and the logits to 1e-5 (1 + max) on perturbed
    parameters, in the serving form (weight norm folded) and in the
    training form (kernel_v / kernel_g); in the training form also the
    gradients of a weighted sum of every output on every parameter, each
    to 1e-5 of (1 + its largest entry)."""
    name, kw, module, v, x = _flax_discriminator(which)
    port = get_model_class(name)(**kw, folded=folded,
                                 generator=torch.Generator().manual_seed(0))
    port.load_state_dict(convert_jax_params(v["params"], fold=folded),
                         strict=True)
    ref = module.apply(v, jnp.asarray(x))
    xt = torch.from_numpy(x)
    _assert_outputs(port(xt), ref, 1e-5, which)
    if which == "melgan_msd":
        assert len(ref) == 3 and all(len(o) == 5 for o in ref)
    if folded:
        return
    rng = np.random.default_rng(6)
    weights = [rng.standard_normal(np.shape(t)).astype(np.float32)
               for t in _leaves(ref)]

    def loss_fn(params):
        outs = module.apply({"params": params}, jnp.asarray(x))
        return sum(jnp.sum(w * t) for w, t in zip(weights, _leaves(outs)))

    want = convert_jax_params(jax.tree.map(
        np.asarray, jax.grad(loss_fn)(v["params"])), fold=False)
    loss = sum((torch.from_numpy(w) * t).sum()
               for w, t in zip(weights, _leaves(port(xt))))
    names = [k for k, _ in port.named_parameters()]
    # the residual discriminator's last residual 1x1 feeds nothing
    grads = torch.autograd.grad(loss, list(port.parameters()),
                                allow_unused=True)
    assert sorted(names) == sorted(want)
    for key, g, p in zip(names, grads, port.parameters()):
        g = torch.zeros_like(p) if g is None else g
        b = want[key].numpy()
        err = np.abs(g.numpy() - b).max()
        assert err <= 1e-5 * (1 + np.abs(b).max()), (key, err)


@pytest.mark.parametrize("which", sorted(DISCRIMINATORS))
def test_discriminator_from_a_reference_pkl(tmp_path, which):
    """A reference .pkl holding a generator (the JAX exporter's) and the
    discriminator beside it (the reference's names): the port's importer
    gives a tree that loads into the port's module, folded and trainable,
    and the module computes the flax module's outputs to 1e-5 (1 + max)."""
    name, kw, module, v, x = _flax_discriminator(which)
    if which == "melgan":
        names = lambda path: _melgan_msd_name(  # noqa: E731
            len(kw["downsample_scales"]) + 2)(
                "discriminators_0/" + path).split(".", 2)[2]
    elif which == "melgan_msd":
        names = _melgan_msd_name(len(kw["downsample_scales"]) + 2)
    else:
        names = _rpwg_d_name
    gen_kw = dict(in_channels=10, channels=32, upsample_scales=(4, 2),
                  stacks=1)
    gen = jax_model_class("MelGANGenerator")(
        **{k: a for k, a in gen_kw.items() if k != "in_channels"})
    gen_v = gen.init(jax.random.key(1), jnp.zeros((1, 6, 10)))
    config = {"generator_type": "MelGANGenerator",
              "generator_params": dict(gen_kw, use_weight_norm=True),
              "discriminator_type": name, "discriminator_params": kw}
    path = str(tmp_path / "checkpoint-3steps.pkl")
    jax_export.save_reference_checkpoint(path, gen_v["params"], config,
                                         steps=3)
    pkl = torch.load(path, weights_only=True)
    pkl["model"]["discriminator"] = reference_state_dict(v, names)
    torch.save(pkl, path)
    tree = ckpt.load_reference_checkpoint(path, config)["discriminator"]
    ref = module.apply(v, jnp.asarray(x))
    for folded in (True, False):
        port = get_model_class(name)(**kw, folded=folded)
        port.load_state_dict(convert_jax_params(tree["params"], fold=folded),
                             strict=True)
        _assert_outputs(port(torch.from_numpy(x)), ref, 1e-5, which)


def _names(config, flags):
    train_g, use_adv, train_d = flags
    names = []
    if train_g:
        names += G_NAMES
        if config.get("use_subband_stft_loss"):
            names += SUB_NAMES
    if use_adv:
        names += ["adversarial_loss"]
        if config.get("use_feat_match_loss"):
            names += ["feature_matching_loss"]
    if train_d:
        names += D_NAMES
    return names


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("kind", CONFIGS)
def test_train_step_matches_jax(kind, flags):
    """One step on the same parameters and batch: losses (the subband and
    feature-matching terms included) to 1e-5 relative; the gradients
    through the optimizers' first moments; the updated parameters to 1e-6
    absolute (rates 1e-4 and 5e-5: this holds the update's size)."""
    config = small_melgan_train_config(kind)
    state, (factory, _), t_state, (t_factory, _) = both_train_states(config)
    batch = sine_batch(config)
    new_state, ref = factory(*FLAGS[flags])(state, as_jax(batch),
                                            jax.random.key(0))
    _, metrics = t_factory(*FLAGS[flags])(t_state, as_torch(batch))
    assert_losses(metrics, ref, _names(config, FLAGS[flags]), rtol=1e-5)
    assert t_state.steps == int(new_state.steps) == 1
    assert_params(t_state.generator, new_state.params_g, 1e-6, "G")
    assert_params(t_state.discriminator, new_state.params_d, 1e-6, "D")
    train_g, _, train_d = FLAGS[flags]
    if train_g:
        assert_first_moment(t_state.opt_g, new_state.opt_g, "G")
    if train_d:
        assert_first_moment(t_state.opt_d, new_state.opt_d, "D")


@pytest.mark.parametrize("kind", CONFIGS)
def test_four_steps_and_eval_step_match_jax(kind):
    """Four G+adv+D steps, then eval_step with and without the adversarial
    terms: losses to 1e-4 relative as the updates compound, parameters to
    2e-6."""
    config = small_melgan_train_config(kind)
    state, (factory, eval_step), t_state, (t_factory, t_eval) = \
        both_train_states(config)
    step, t_step = factory(True, True, True), t_factory(True, True, True)
    names = _names(config, (True, True, True))
    for i in range(4):
        batch = sine_batch(config, seed=10 + i)
        state, ref = step(state, as_jax(batch), jax.random.key(0))
        _, metrics = t_step(t_state, as_torch(batch))
        assert_losses(metrics, ref, names, rtol=1e-4)
    assert_params(t_state.generator, state.params_g, 2e-6, "G")
    assert_params(t_state.discriminator, state.params_d, 2e-6, "D")
    batch = sine_batch(config, seed=20)
    for use_adv in (True, False):
        ref = eval_step(state, as_jax(batch), jax.random.key(0), use_adv)
        metrics = t_eval(t_state, as_torch(batch), use_adv)
        assert_losses(metrics, ref, _names(config, (True, use_adv, use_adv)),
                      rtol=1e-4)


def _first_moments(node):
    """The Adam first moments in an optimizer's state_dict, flattened."""
    if isinstance(node, dict):
        if "mu" in node:
            return [t for t in jax.tree.leaves(node["mu"])]
        return [t for v in node.values() for t in _first_moments(v)]
    if isinstance(node, (list, tuple)):
        return [t for v in node for t in _first_moments(v)]
    return []


def test_mb_melgan_mixed_precision_step():
    """bf16 networks, f32 PQMF and losses: the losses agree with the JAX
    mixed-precision step to bf16 accuracy (5e-2 relative), the master
    parameters and the optimizer state stay float32, a gradient reaches
    every parameter (no first moment is zero) and the parameters move
    (all but those whose update lr g / (|g| + eps) lies below their f32
    rounding: the generator's first kernel_g gets gradients near 1e-7)."""
    config = small_melgan_train_config("mb_melgan", mixed_precision=True)
    state, (factory, _), t_state, (t_factory, _) = both_train_states(config)
    batch = sine_batch(config)
    params = {**t_state.params_g, **t_state.params_d}
    before = {k: v.detach().clone() for k, v in params.items()}
    _, ref = factory(True, True, True)(state, as_jax(batch),
                                       jax.random.key(0))
    _, metrics = t_factory(True, True, True)(t_state, as_torch(batch))
    assert_losses(metrics, ref, _names(config, (True, True, True)),
                  rtol=5e-2)
    assert all(m.dtype == torch.float32 for m in metrics.values())
    moved = 0
    for key, p in params.items():
        assert p.dtype == torch.float32 and torch.isfinite(p).all(), key
        moved += int(not torch.equal(p, before[key]))
    assert moved >= len(params) - 2, moved
    for opt, group in ((t_state.opt_g, t_state.params_g),
                       (t_state.opt_d, t_state.params_d)):
        mus = _first_moments(opt.state_dict())
        assert len(mus) == len(group)
        assert all(m.dtype == torch.float32 and m.abs().max() > 0
                   for m in mus)
    for leaf in jax.tree.leaves(t_state.opt_g.state_dict()):
        assert leaf.dtype in (torch.float32, torch.int32)


@pytest.mark.parametrize("kind", ["mb_melgan", "melgan_v1"])
def test_ckpt_exchange_both_ways(tmp_path, kind):
    """A MelGAN generator with either discriminator: a .ckpt of either
    package restores into the other (parameters, optimizer states, the
    step), and both continue on the same trajectory (parameters to 2e-6
    after one more step)."""
    config = small_melgan_train_config(kind)
    state, (factory, _), t_state, (t_factory, _) = both_train_states(config)
    step, t_step = factory(True, True, True), t_factory(True, True, True)
    batches = [sine_batch(config, seed=40 + i) for i in range(2)]
    state, _ = step(state, as_jax(batches[0]), jax.random.key(0))
    t_step(t_state, as_torch(batches[0]))

    jax_path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(jax_path, state)
    resumed, gen, dis, opt_g, opt_d = init_train_state(config, seed=4,
                                                       device="cpu")
    ckpt.load_checkpoint(jax_path, resumed)
    assert resumed.steps == 1 and resumed.opt_g.count == 1
    assert_params(resumed.generator, state.params_g, 0, "G")
    assert_params(resumed.discriminator, state.params_d, 0, "D")
    r_step = build_steps(config, gen, dis, build_criterion(config), opt_g,
                         opt_d)[0](True, True, True)

    port_path = str(tmp_path / "port.ckpt")
    ckpt.save_checkpoint(port_path, t_state)
    template = jax_init_train_state(config, jax.random.key(7))[0]
    j_resumed = jax_ckpt.load_checkpoint(port_path, template)
    assert int(j_resumed.steps) == 1
    assert_params(t_state.generator, j_resumed.params_g, 0, "G")

    jb = as_jax(batches[1])
    state, ref = step(state, jb, jax.random.key(0))
    j_resumed, _ = step(j_resumed, jb, jax.random.key(0))
    _, m = r_step(resumed, as_torch(batches[1]))
    t_step(t_state, as_torch(batches[1]))
    assert_losses(m, ref, _names(config, (True, True, True)), rtol=1e-4)
    assert_params(resumed.generator, state.params_g, 2e-6, "G")
    assert_params(resumed.discriminator, state.params_d, 2e-6, "D")
    assert_params(t_state.generator, j_resumed.params_g, 2e-6, "G")
    assert_params(t_state.discriminator, j_resumed.params_d, 2e-6, "D")


class _Recorder(torch.nn.Module):
    """A generator that returns its inputs, to see what the step passes."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))

    def forward(self, *args, **kwargs):
        self.args = args
        return args[0] * self.w


class _JaxRecorder:
    def apply(self, variables, *args, **kwargs):
        self.args = args
        return args[0]


@pytest.mark.parametrize("use_noise_input", [True, False])
@pytest.mark.parametrize("gen_type", ["MelGANGenerator", "HiFiGANGenerator",
                                      "ParallelWaveGANGenerator"])
def test_generator_dispatch_follows_jax(gen_type, use_noise_input):
    """C-2: Parallel WaveGAN, and any generator with use_noise_input, takes
    (z, c); the others c alone, in both packages."""
    config = {"generator_type": gen_type, "use_noise_input": use_noise_input,
              "fused_wavenet": False}
    batch = {"z": np.full((1, 8, 1), 2.0, np.float32),
             "c": np.full((1, 2, 3), 3.0, np.float32)}
    port, ref = _Recorder(), _JaxRecorder()
    make_generator_forward(config, port)(dict(port.named_parameters()),
                                         as_torch(batch))
    jax_make_generator_forward(config, ref)({}, as_jax(batch),
                                            jax.random.key(0), True)
    want = (["z", "c"] if use_noise_input
            or gen_type == "ParallelWaveGANGenerator" else ["c"])
    for args in (port.args, ref.args[:len(want)]):
        assert [float(np.asarray(a).max()) for a in args] == [
            float(batch[k].max()) for k in want]
    assert len(port.args) == len(want)


def _jax_fuse_default(dis_type):
    """The JAX step's fuse_rf for a config without the key, read from the
    closure of its discriminator loss."""
    config = dict(small_melgan_train_config("melgan_v1"),
                  discriminator_type=dis_type)
    gen = jax_model_class("MelGANGenerator")(
        **{k: v for k, v in config["generator_params"].items()
           if k != "in_channels"})
    factory, _ = jax_build_steps(config, gen, None, {}, None, None)

    def cell(fn, name):
        return dict(zip(fn.__code__.co_freevars,
                        fn.__closure__))[name].cell_contents

    return cell(cell(factory.__wrapped__, "dis_losses"), "fuse_rf")


@pytest.mark.parametrize("dis_type", [
    "ParallelWaveGANDiscriminator", "MelGANMultiScaleDiscriminator",
    "HiFiGANMultiScaleMultiPeriodDiscriminator", "StyleMelGANDiscriminator"])
def test_fuse_real_fake_default_follows_jax(dis_type):
    """C-2: one real|fake pass by default but for the multi-scale
    multi-period discriminator and StyleMelGAN's, as in the JAX step."""
    assert fuse_real_fake_default(dis_type) == _jax_fuse_default(dis_type)
    assert fuse_real_fake_default(dis_type) == (dis_type in (
        "ParallelWaveGANDiscriminator", "MelGANMultiScaleDiscriminator"))


@pytest.mark.parametrize("gen_type", [
    "DiscreteSymbolStyleMelGANGenerator", "DiscreteSymbolF0Generator",
    "DiscreteSymbolHiFiGANGenerator", "DiscreteSymbolDurationGenerator"])
def test_unported_generator_families_raise_naming_the_family(gen_type):
    """The discrete-symbol families, once refused, take what the JAX step
    gives them: a duration generator (c, ds), the F0 generator (c, f0),
    the token StyleMelGAN c and its noise (the port's z from the batch,
    drawn by the step; None in the JAX step, which draws it inside), the
    token HiFi-GAN c alone."""
    config = {"generator_type": gen_type}
    batch = {"c": np.full((1, 2, 1), 3.0, np.float32),
             "ds": np.full((1, 2), 5, np.int32),
             "f0": np.full((1, 2, 1), 7.0, np.float32),
             "z": np.full((1, 1, 4), 2.0, np.float32)}
    pair = "Duration" in gen_type

    class Port(_Recorder):
        def forward(self, *args, **kwargs):
            y = super().forward(*args, **kwargs)
            return (y, args[1]) if pair else y

    class Jax(_JaxRecorder):
        def apply(self, variables, *args, **kwargs):
            y = super().apply(variables, *args, **kwargs)
            return (y, args[1]) if pair else y

    port, ref = Port(), Jax()
    make_generator_forward(config, port)(dict(port.named_parameters()),
                                         as_torch(batch))
    jax_make_generator_forward(config, ref)({}, as_jax(batch),
                                            jax.random.key(0), True)
    want = {"DiscreteSymbolDurationGenerator": ["c", "ds"],
            "DiscreteSymbolF0Generator": ["c", "f0"],
            "DiscreteSymbolStyleMelGANGenerator": ["c", "z"],
            "DiscreteSymbolHiFiGANGenerator": ["c"]}[gen_type]
    assert [float(np.asarray(a).max()) for a in port.args] == [
        float(batch[k].max()) for k in want]
    got_jax = ref.args[:len(want)]
    if gen_type == "DiscreteSymbolStyleMelGANGenerator":
        assert got_jax[1] is None
        got_jax = got_jax[:1]
    assert [float(np.asarray(a).max()) for a in got_jax] == [
        float(batch[k].max()) for k in want[:len(got_jax)]]


def test_trained_multi_band_config_serves_with_the_old_pqmf_prototype():
    """A known behaviour of the JAX package that the port keeps: both
    criteria train a multi-band generator with PQMF's defaults (cutoff
    0.142), while a config written by either trainer (version
    "parallelwavegan_tpu-0.1.0" or "parallelwavegan_torch-0.1.0", whose
    non-numeric parts compare as 0, so "<= 0.4.2") serves with the old
    prototype (cutoff 0.15)."""
    config = small_melgan_train_config("mb_melgan")
    assert build_criterion(config)["pqmf"].cutoff_ratio == 0.142
    assert jax_build_criterion(config)["pqmf"].cutoff_ratio == 0.142
    gen_kw = {k: v for k, v in config["generator_params"].items()
              if k != "in_channels"}
    variables = jax_model_class("MelGANGenerator")(**gen_kw).init(
        jax.random.key(0), jnp.zeros((1, 4, 16)))
    for version in (VERSION, "parallelwavegan_tpu-0.1.0"):
        written = dict(config, version=version)
        assert pqmf_for(written).cutoff_ratio == 0.15
        assert JaxInferenceModel(written, variables).pqmf.cutoff_ratio == 0.15
    assert pqmf_for(dict(config, version="0.5.0")).cutoff_ratio == 0.142


@pytest.mark.parametrize("name, smoke, cut, local", [
    ("multi_band_melgan.v2", "MB_MELGAN_V2_TRAIN", "MB_MELGAN_V2_TRAIN_CUT",
     ()),
    ("parallel_wavegan.v3", "PWG_V3_TRAIN", "PWG_V3_TRAIN_CUT", ("format",)),
])
def test_smoke_training_configs_are_the_yaml(name, smoke, cut, local):
    """chip_smoke trains these two at full width (the GPU machine has no
    yaml): every key of its dict says what the file says, but the data
    format of a seeded npy corpus; every recipe key of the file is there;
    what the script cuts (steps, the discriminator's start, intervals, and
    for Parallel WaveGAN v3 the per-layer path) is named apart."""
    import os

    import yaml

    import chip_smoke

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "egs/ljspeech/voc1/conf", name + ".yaml")) \
            as f:
        want = yaml.safe_load(f)
    got, cuts = getattr(chip_smoke, smoke), getattr(chip_smoke, cut)
    for key, value in got.items():
        if key not in local:
            assert want[key] == value, key
    recipe = [k for k in want if k.startswith((
        "generator_", "discriminator_", "lambda_", "use_", "stft_",
        "subband_", "batch_", "feat_match", "mixed_", "fuse_"))]
    assert not set(recipe) - set(got) - set(cuts)
    assert not set(cuts) & set(got)
    assert set(cuts) - set(want) <= {"fused_wavenet"}


def test_multi_scale_discriminator_refuses_other_pooling():
    """Only AvgPool1d between scales, as the JAX module asserts."""
    with pytest.raises(NotImplementedError, match="MaxPool1d"):
        get_model_class("MelGANMultiScaleDiscriminator")(
            downsample_pooling="MaxPool1d")
