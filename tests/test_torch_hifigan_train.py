"""HiFi-GAN v1 training in the port against the JAX package on the CPU: the
five discriminator classes, the adversarial losses over their outputs, the
train step (G, G+adv+D, D; f32 and mixed precision) on the small recipe of
``tests/torch_helpers.small_hifigan_train_config``, and the CLI from
training to decoding the EMA weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from parallelwavegan_tpu.losses import (
    DiscriminatorAdversarialLoss as JaxDisAdv,
    GeneratorAdversarialLoss as JaxGenAdv,
)
from parallelwavegan_tpu.models import get_model_class as jax_model_class
from parallelwavegan_torch.bin import decode as decode_cli
from parallelwavegan_torch.bin import train as train_cli
from parallelwavegan_torch.engine import checkpoint as ckpt
from parallelwavegan_torch.losses import (
    DiscriminatorAdversarialLoss,
    GeneratorAdversarialLoss,
)
from parallelwavegan_torch.models import get_model_class
from parallelwavegan_torch.utils.model_loader import load_model
from parallelwavegan_torch.utils.params import convert_jax_params
from tests.torch_helpers import (
    as_jax,
    as_torch,
    assert_first_moment,
    assert_losses,
    assert_params,
    assert_tensors,
    both_train_states,
    perturbed,
    sine_batch,
    small_hifigan_train_config,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEBUG_YAML = os.path.join(REPO, "egs/yesno/voc1/conf/hifigan.v1.debug.yaml")
G_NAMES = ["mel_loss", "generator_loss"]
ADV_NAMES = ["adversarial_loss", "feature_matching_loss"]
D_NAMES = ["real_loss", "fake_loss", "discriminator_loss"]

SCALE = dict(channels=8, downsample_scales=(2, 4), max_groups=4,
             max_downsample_channels=32)
PERIOD = dict(channels=4, downsample_scales=(3, 1),
              max_downsample_channels=16)
DISCRIMINATORS = {
    "period": ("HiFiGANPeriodDiscriminator", dict(period=3, **PERIOD)),
    "period_spectral": ("HiFiGANPeriodDiscriminator", dict(
        period=2, use_weight_norm=False, use_spectral_norm=True, **PERIOD)),
    "multi_period": ("HiFiGANMultiPeriodDiscriminator", dict(
        periods=(2, 5), discriminator_params=PERIOD)),
    "scale": ("HiFiGANScaleDiscriminator", dict(SCALE)),
    "multi_scale": ("HiFiGANMultiScaleDiscriminator", dict(
        scales=2, discriminator_params=SCALE, follow_official_norm=True)),
    # the v1 structure at narrow widths: 3 scales + 5 periods, 8 output lists
    "msmpd": ("HiFiGANMultiScaleMultiPeriodDiscriminator", dict(
        scale_discriminator_params=SCALE,
        period_discriminator_params=PERIOD)),
}


def _leaves(outs):
    return [t for o in outs for t in (o if isinstance(o, (list, tuple))
                                      else [o])]


@pytest.mark.parametrize("which", sorted(DISCRIMINATORS))
def test_discriminators_match_flax(which):
    """Every feature map and the logits to 2e-5 absolute in eval mode and
    in training mode (where u advances and must match after the pass), and
    the gradients of a weighted sum of all outputs on every parameter to
    5e-5 of (1 + the largest entry), on perturbed parameters."""
    name, kwargs = DISCRIMINATORS[which]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 257, 1)).astype(np.float32)
    flax_d = jax_model_class(name)(**kwargs)
    v = flax_d.init({"params": jax.random.key(0)}, jnp.asarray(x))
    params = perturbed(v["params"], rng)
    extra = {k: val for k, val in v.items() if k != "params"}
    port = get_model_class(name)(**kwargs, folded=False,
                                 generator=torch.Generator().manual_seed(0))
    port.load_state_dict(convert_jax_params(
        jax.tree.map(np.asarray, params), fold=False,
        spectral=jax.tree.map(np.asarray, extra).get("spectral")),
        strict=True)
    has_u = bool(extra)
    assert has_u == bool(dict(port.named_buffers()))
    xt = torch.from_numpy(x)

    port.eval()
    ref = flax_d.apply({"params": params, **extra}, jnp.asarray(x), True)
    outs = port(xt)
    if which == "msmpd":
        assert len(outs) == 8 and all(isinstance(o, list) for o in outs)
        assert [len(o) for o in outs] == [5] * 3 + [3] * 5
    for got, want in zip(_leaves(outs), _leaves(ref), strict=True):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=2e-5)

    port.train()
    weights = [rng.standard_normal(t.shape).astype(np.float32)
               for t in _leaves(ref)]

    def loss_fn(params):
        if has_u:
            out, updated = flax_d.apply({"params": params, **extra},
                                        jnp.asarray(x), False,
                                        mutable=["spectral"])
        else:
            out = flax_d.apply({"params": params}, jnp.asarray(x), False)
            updated = {}
        return sum(jnp.sum(t * w) for t, w in zip(_leaves(out), weights)), \
            updated

    (_, updated), g_ref = jax.value_and_grad(loss_fn, has_aux=True)(params)
    outs = port(xt)
    loss = sum((t * torch.from_numpy(w)).sum()
               for t, w in zip(_leaves(outs), weights))
    names = [n for n, _ in port.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                list(port.parameters()))))
    want = convert_jax_params(jax.tree.map(np.asarray, g_ref), fold=False)
    assert sorted(want) == sorted(names)
    for key, b in want.items():
        b = b.numpy()
        err = np.abs(grads[key].numpy() - b).max()
        assert err <= 5e-5 * (1 + np.abs(b).max()), (key, err)
    if has_u:
        assert_tensors(dict(port.named_buffers()), updated["spectral"], 1e-6,
                       "u after a training pass")


@pytest.mark.parametrize("loss_type", ["mse", "hinge"])
def test_adversarial_losses_on_msmpd_outputs(loss_type):
    """Lists of lists (feature maps, logits last) of different shapes, as
    the multi-scale multi-period discriminator returns them, summed over
    the eight discriminators (average_by_discriminators: false)."""
    rng = np.random.default_rng(4)
    shapes = [[(2, 64, 8), (2, 64, 1)]] * 3 + [[(2, 10, p, 4), (2, 10 * p)]
                                               for p in (2, 3, 5, 7, 11)]
    fake, real = ([[rng.standard_normal(s).astype(np.float32) for s in d]
                   for d in shapes] for _ in range(2))
    to_jax = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    to_torch = lambda t: jax.tree.map(torch.from_numpy, t)  # noqa: E731
    g_ref = JaxGenAdv(False, loss_type)(to_jax(fake))
    g = GeneratorAdversarialLoss(False, loss_type)(to_torch(fake))
    np.testing.assert_allclose(float(g), float(g_ref), rtol=1e-6)
    r_ref, f_ref = JaxDisAdv(False, loss_type)(to_jax(fake), to_jax(real))
    r, f = DiscriminatorAdversarialLoss(False, loss_type)(to_torch(fake),
                                                          to_torch(real))
    np.testing.assert_allclose(float(r), float(r_ref), rtol=1e-6)
    np.testing.assert_allclose(float(f), float(f_ref), rtol=1e-6)


def _names(train_g, use_adv, train_d):
    return ((G_NAMES if train_g else []) + (ADV_NAMES if use_adv else [])
            + (D_NAMES if train_d else []))


@pytest.mark.parametrize("flags", [(True, False, False), (True, True, True),
                                   (False, False, True)],
                         ids=["g_only", "g_adv_d", "d_only"])
def test_hifigan_train_step_matches_jax(flags):
    """One step on the same parameters, u and batch. Losses to 2e-5
    relative (the mel loss is a mean of |log| differences of energies down
    to the clamp, times 45); gradients through Adam's first moments, 1e-3 of
    each one's largest entry plus 1e-4 of the network's largest (the loss
    is an L1 of logs, so every term's gradient carries the sign of a
    difference and is divided by a mel energy, and the bias gradients are
    sums of such terms that nearly cancel: measured 2e-4 of each one's
    largest entry, 1e-2 on output_conv.bias); updated
    parameters and the EMA stream to 1e-5 absolute (a twentieth of the rate
    2e-4, with Adam's eps 1e-3 in this recipe: Adam divides every gradient
    by its own size, so a small gradient's rounding shows in full); the
    spectral-norm vectors to 1e-6. u advances
    only when the discriminator trains, and then twice (real pass, fake
    pass); the EMA moves only when the generator trains."""
    config = small_hifigan_train_config()
    state, (factory, _), t_state, (t_factory, _) = both_train_states(config)
    batch = sine_batch(config)
    assert sorted(batch) == ["c", "y"]
    train_g, use_adv, train_d = flags
    u_before = {k: v.clone() for k, v in t_state.extra_d.items()}
    ema_before = {k: v.clone() for k, v in t_state.ema_g.items()}
    new_state, ref = factory(*flags)(state, as_jax(batch), jax.random.key(0))
    out_state, metrics = t_factory(*flags)(t_state, as_torch(batch))
    assert_losses(metrics, ref, _names(*flags), rtol=2e-5)
    assert out_state is t_state and t_state.steps == int(new_state.steps) == 1
    assert_params(t_state.generator, new_state.params_g, 1e-5, "G")
    assert_params(t_state.discriminator, new_state.params_d, 1e-5, "D")
    assert_tensors(t_state.extra_d, new_state.extra_d["spectral"], 1e-6, "u")
    assert_tensors(t_state.ema_g, new_state.ema_g, 1e-5, "ema_g")
    u_moved = any(not torch.equal(v, u_before[k])
                  for k, v in t_state.extra_d.items())
    ema_moved = any(not torch.equal(v, ema_before[k])
                    for k, v in t_state.ema_g.items())
    assert u_moved == train_d and ema_moved == train_g
    if train_g:
        assert_first_moment(t_state.opt_g, new_state.opt_g, "G", floor=1e-4)
        # one decay step from the parameters before the update
        key = "output_conv.kernel_g"
        want = (0.999 * ema_before[key]
                + 0.001 * t_state.params_g[key].detach())
        np.testing.assert_allclose(t_state.ema_g[key].numpy(), want.numpy(),
                                   atol=1e-7)
    if train_d:
        assert_first_moment(t_state.opt_d, new_state.opt_d, "D", floor=1e-4)
    assert all(m.dim() == 0 and not m.requires_grad for m in metrics.values())
    assert t_state.discriminator.training  # the mode is restored


def test_u_advances_twice_in_the_two_pass_update_and_once_fused():
    """The fake pass starts from the real pass's u: after one D step the
    stored u is two power iterations from the old one with the two-pass
    update (the default for this discriminator) and one with the fused
    real|fake pass; both as the JAX step has it."""
    from parallelwavegan_torch.layers.common import spectral_normalize

    for fused, iterations in ((False, 2), (True, 1)):
        config = small_hifigan_train_config(
            **({"fuse_real_fake_discriminator": True} if fused else {}))
        state, (factory, _), t_state, (t_factory, _) = both_train_states(
            config)
        conv = t_state.discriminator.msd.discriminators_0.layer_1
        u = conv.u.clone()
        kernel = conv.kernel.detach().clone()
        for _ in range(iterations):
            spectral_normalize(kernel, u, update=True)
        batch = sine_batch(config)
        new_state, ref = factory(False, False, True)(
            state, as_jax(batch), jax.random.key(0))
        _, metrics = t_factory(False, False, True)(t_state, as_torch(batch))
        assert_losses(metrics, ref, D_NAMES, rtol=2e-5)
        np.testing.assert_allclose(conv.u.numpy(), u.numpy(), atol=1e-6)
        assert_tensors(t_state.extra_d, new_state.extra_d["spectral"], 1e-6,
                       "u")


def test_several_hifigan_steps_and_eval_step_match_jax():
    """Four G+adv+D steps across a MultiStepLR milestone, then eval_step
    with and without the adversarial terms (no u update, no parameter
    update). Losses 1e-4 relative and parameters 2e-5 absolute after the
    updates compound."""
    config = small_hifigan_train_config()
    state, (factory, eval_step), t_state, (t_factory, t_eval) = \
        both_train_states(config)
    step, t_step = factory(True, True, True), t_factory(True, True, True)
    for i in range(4):  # the rate halves after the third
        batch = sine_batch(config, seed=10 + i)
        state, ref = step(state, as_jax(batch), jax.random.key(0))
        _, metrics = t_step(t_state, as_torch(batch))
        assert_losses(metrics, ref, _names(True, True, True), rtol=1e-4)
    assert_params(t_state.generator, state.params_g, 2e-5, "G")
    assert_tensors(t_state.ema_g, state.ema_g, 2e-5, "ema_g")
    assert_tensors(t_state.extra_d, state.extra_d["spectral"], 2e-5, "u")
    batch = sine_batch(config, seed=20)
    before = {k: v.clone() for k, v in
              t_state.discriminator.state_dict().items()}
    for use_adv in (True, False):
        ref = eval_step(state, as_jax(batch), jax.random.key(0), use_adv)
        metrics = t_eval(t_state, as_torch(batch), use_adv)
        assert_losses(metrics, ref, _names(True, use_adv, use_adv), rtol=1e-4)
    for key, value in t_state.discriminator.state_dict().items():
        assert torch.equal(value, before[key]), key


def test_hifigan_mixed_precision_step():
    """bf16 copies of the parameters, the batch and u go in, f32 comes out:
    master parameters, gradients, optimizer state and the EMA stay float32;
    the stored u is a bf16 value widened to float32, as in the JAX step
    (which the 2e-2 absolute bound on u holds: bf16 has 8 bits, and the two
    packages sum the power iteration's products in another order); the
    losses agree to bf16 accuracy (5e-2 relative)."""
    config = small_hifigan_train_config(mixed_precision=True)
    state, (factory, _), t_state, (t_factory, _) = both_train_states(config)
    batch = sine_batch(config)
    before = {k: v.detach().clone() for k, v in t_state.params_g.items()}
    new_state, ref = factory(True, True, True)(state, as_jax(batch),
                                               jax.random.key(0))
    _, metrics = t_factory(True, True, True)(t_state, as_torch(batch))
    assert_losses(metrics, ref, _names(True, True, True), rtol=5e-2)
    assert all(m.dtype == torch.float32 for m in metrics.values())
    for key, p in t_state.params_g.items():
        assert p.dtype == torch.float32 and torch.isfinite(p).all(), key
        assert not torch.equal(p, before[key]), key
        assert t_state.ema_g[key].dtype == torch.float32
    for key, u in t_state.extra_d.items():
        assert u.dtype == torch.float32
        assert torch.equal(u, u.to(torch.bfloat16).float()), key
    assert_tensors(t_state.extra_d, new_state.extra_d["spectral"], 2e-2, "u")
    for leaf in jax.tree.leaves(t_state.opt_d.state_dict()):
        assert leaf.dtype in (torch.float32, torch.int32)


def _write_corpus(root, n_utts, num_mels, hop, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n_utts):
        frames = 30 + 7 * i
        t = np.arange(frames * hop)
        wave = 0.3 * np.sin(0.02 * (i + 1) * t) + 0.01 * rng.standard_normal(
            t.shape)
        np.save(os.path.join(root, f"utt{i}-wave.npy"),
                wave.astype(np.float32))
        np.save(os.path.join(root, f"utt{i}-feats.npy"),
                rng.standard_normal((frames, num_mels)).astype(np.float32))


def test_train_cli_then_decode_use_ema(tmp_path):
    """bin.train.main on the debug-width HiFi-GAN yaml, --device cpu, three
    steps (the discriminator from step 0, the generator from step 1), then
    bin.decode --use-ema on the train-state .ckpt, and load_model on it
    with and without the EMA weights."""
    with open(DEBUG_YAML) as f:
        config = yaml.safe_load(f)
    config.update(format="npy", batch_size=2, train_max_steps=3,
                  save_interval_steps=3, eval_interval_steps=3,
                  log_interval_steps=3, generator_ema_decay=0.999,
                  mixed_precision=False)
    root = str(tmp_path / "dump")
    _write_corpus(root, 4, num_mels=config["num_mels"],
                  hop=config["hop_size"])
    conf_path = str(tmp_path / "conf.yaml")
    with open(conf_path, "w") as f:
        yaml.safe_dump(config, f)
    outdir = str(tmp_path / "exp")
    trainer = train_cli.main([
        "--train-dumpdir", root, "--dev-dumpdir", root, "--outdir", outdir,
        "--config", conf_path, "--device", "cpu", "--verbose", "0"])
    assert trainer.steps == trainer.state.steps == 3
    names = _names(True, True, True)
    assert sorted(trainer.last_train_loss) == sorted(
        f"train/{n}" for n in names)
    assert sorted(trainer.last_eval_loss) == sorted(
        f"eval/{n}" for n in names)
    assert all(np.isfinite(v) for v in trainer.last_train_loss.values())
    # the discriminator trained at steps 0..2, the generator at 2 only
    # (strict gates: steps > start)
    assert trainer.state.opt_d.count == 2 and trainer.state.opt_g.count == 1
    path = os.path.join(outdir, "checkpoint-3steps.ckpt")
    assert os.path.exists(path)
    assert os.path.exists(
        os.path.join(outdir, "predictions", "3steps", "0_gen.wav"))
    state = trainer.state
    key = "input_conv.kernel_v"
    assert not torch.equal(state.ema_g[key], state.params_g[key])

    # load_model on the .ckpt: the parameters, or the EMA stream
    plain = load_model(path, device="cpu")
    ema = load_model(path, device="cpu", use_ema=True)
    from parallelwavegan_torch.utils.params import folded_state_dict
    want = folded_state_dict(state.ema_g)
    for name, value in ema.generator.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   atol=1e-7)
    assert not torch.equal(plain.generator.input_conv.kernel,
                           ema.generator.input_conv.kernel)
    with pytest.raises(ValueError, match="generator_ema_decay"):
        load_model(path, dict(config, generator_ema_decay=0.0), device="cpu",
                   use_ema=True)

    # a .gckpt of the EMA stream serves the same weights
    gckpt = str(tmp_path / "ema.gckpt")
    ckpt.save_generator_checkpoint(gckpt, state, use_ema=True)
    served = load_model(gckpt, config, device="cpu")
    for name, value in served.generator.state_dict().items():
        assert torch.equal(value, ema.generator.state_dict()[name]), name
    with pytest.raises(ValueError, match="use_ema"):
        load_model(gckpt, config, device="cpu", use_ema=True)
    with pytest.raises(ValueError, match="use_ema"):
        ckpt.save_generator_checkpoint(gckpt, state.generator, use_ema=True)

    # decode --use-ema
    wavdir = tmp_path / "wav"
    decode_cli.main(["--dumpdir", root, "--checkpoint", path, "--outdir",
                     str(wavdir), "--device", "cpu", "--use-ema",
                     "--batch-size", "2", "--verbose", "0"])
    mels = [np.load(os.path.join(root, f"utt{i}-feats.npy")) for i in (0, 1)]
    sr, wave = wavfile.read(wavdir / "utt1_gen.wav")
    assert sr == config["sampling_rate"]
    assert wave.shape == (len(mels[1]) * config["hop_size"],)
    want = ema.synthesize_batch(mels)[1][:, 0]  # decode's first batch
    got = wave.astype(np.float32) / 32767.0
    assert np.abs(got - np.clip(want, -1, 1)).max() <= 2.0 / 32767

    # resume: the EMA stream and u come back from the file
    config["train_max_steps"] = 4
    resumed = train_cli.run(config, root, root, str(tmp_path / "exp2"),
                            resume=path, device="cpu")
    assert resumed.steps == 4 and resumed.state.opt_g.count == 2
    assert not torch.equal(resumed.state.ema_g[key], state.ema_g[key])
