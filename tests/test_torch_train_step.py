"""The port's GAN train step, checkpoints, data pipeline and Trainer on the
CPU against the JAX package's (``fused_wavenet: false`` there, the
per-layer forward here), on the same parameters, batch and noise, at the
widths of egs/yesno/voc1/conf/parallel_wavegan.v1.debug.yaml."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from parallelwavegan_tpu.datasets import Collater as JaxCollater
from parallelwavegan_tpu.datasets.loader import DataLoader as JaxDataLoader
from parallelwavegan_tpu.engine import checkpoint as jax_ckpt
from parallelwavegan_tpu.engine.build import (
    example_batch as jax_example_batch,
    init_train_state as jax_init_train_state,
)
from parallelwavegan_torch.bin import train as train_cli
from parallelwavegan_torch.datasets.audio_mel_dataset import AudioMelDataset
from parallelwavegan_torch.datasets.collater import Collater
from parallelwavegan_torch.datasets.loader import DataLoader
from parallelwavegan_torch.engine import checkpoint as ckpt
from parallelwavegan_torch.engine.build import (
    build_models,
    example_batch,
    init_train_state,
)
from parallelwavegan_torch.engine.criterion import build_criterion
from parallelwavegan_torch.engine.step import build_steps
from parallelwavegan_torch.engine.trainer import Trainer
from parallelwavegan_torch.utils.model_loader import load_model
from parallelwavegan_torch.utils.params import nested
from tests.torch_helpers import (
    as_torch,
    assert_first_moment,
    assert_losses,
    assert_params,
    assert_tensors,
    both_train_states,
    sine_batch,
    small_hifigan_train_config,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEBUG_YAML = os.path.join(
    REPO, "egs/yesno/voc1/conf/parallel_wavegan.v1.debug.yaml")
LOSS_NAMES = [
    "spectral_convergence_loss", "log_stft_magnitude_loss",
    "adversarial_loss", "generator_loss", "real_loss", "fake_loss",
    "discriminator_loss",
]


def _config(**overrides):
    with open(DEBUG_YAML) as f:
        config = yaml.safe_load(f)
    config.update(format="npy", batch_size=3, fused_wavenet=False)
    config.update(overrides)
    return config


@pytest.mark.parametrize("flags", [(True, False, False), (True, True, True),
                                   (False, False, True)],
                         ids=["g_only", "g_adv_d", "d_only"])
def test_train_step_matches_jax(flags):
    """One step on the same parameters, batch and z. Losses to 1e-5
    relative; gradients through the optimizers' first moments; updated
    parameters to 1e-6 absolute (rates 1e-4 and 5e-5, so this holds the
    update's size, the moments its direction)."""
    config = _config()
    state, (factory, _), t_state, (t_factory, _) = both_train_states(config)
    batch = sine_batch(config)
    train_g, use_adv, train_d = flags
    new_state, ref = factory(*flags)(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(0))
    out_state, metrics = t_factory(*flags)(t_state, as_torch(batch))
    names = []
    if train_g:
        names += LOSS_NAMES[:2] + LOSS_NAMES[3:4]
    if use_adv:
        names += LOSS_NAMES[2:3]
    if train_d:
        names += LOSS_NAMES[4:]
    assert_losses(metrics, ref, names, rtol=1e-5)
    assert out_state is t_state and t_state.steps == int(new_state.steps) == 1
    assert_params(t_state.generator, new_state.params_g, 1e-6, "G")
    assert_params(t_state.discriminator, new_state.params_d, 1e-6, "D")
    if train_g:
        assert_first_moment(t_state.opt_g, new_state.opt_g, "G")
    if train_d:
        assert_first_moment(t_state.opt_d, new_state.opt_d, "D")
    assert all(m.dim() == 0 and not m.requires_grad for m in metrics.values())


def test_several_steps_and_eval_step_match_jax():
    """Four G+adv+D steps (the second update already sees the first one's
    optimizer state), then eval_step with and without the adversarial
    terms. Losses 1e-4 relative after the updates compound."""
    config = _config()
    state, (factory, eval_step), t_state, (t_factory, t_eval) = both_train_states(config)
    step, t_step = factory(True, True, True), t_factory(True, True, True)
    for i in range(4):
        batch = sine_batch(config, seed=10 + i)
        state, ref = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.key(0))
        _, metrics = t_step(t_state, as_torch(batch))
        assert_losses(metrics, ref, LOSS_NAMES, rtol=1e-4)
    assert_params(t_state.generator, state.params_g, 2e-6, "G")
    assert_params(t_state.discriminator, state.params_d, 2e-6, "D")
    batch = sine_batch(config, seed=20)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    before = copy.deepcopy(t_state.generator.state_dict())
    for use_adv, names in ((True, LOSS_NAMES),
                           (False, LOSS_NAMES[:2] + LOSS_NAMES[3:4])):
        ref = eval_step(state, jbatch, jax.random.key(0), use_adv)
        metrics = t_eval(t_state, as_torch(batch), use_adv)
        assert_losses(metrics, ref, names, rtol=1e-4)
    assert t_state.steps == 4
    for key, value in t_state.generator.state_dict().items():
        assert torch.equal(value, before[key]), key


@pytest.mark.parametrize("option", ["fuse_real_fake_discriminator",
                                    "update_prediction_after_generator_update"])
def test_step_options_follow_jax(option):
    """One real|fake pass and two passes give the same numbers; without
    the recompute the discriminator sees the prediction made before the
    generator update. Each setting is held to the JAX step."""
    for value in (True, False):
        config = _config(**{option: value})
        state, (factory, _), t_state, (t_factory, _) = both_train_states(config)
        batch = sine_batch(config)
        _, ref = factory(True, True, True)(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.key(0))
        _, metrics = t_factory(True, True, True)(t_state, as_torch(batch))
        assert_losses(metrics, ref, LOSS_NAMES, rtol=1e-5)


def test_mixed_precision_step():
    """bf16 copies of the parameters and the batch go in, f32 comes out:
    master parameters, gradients and optimizer state stay float32, and
    the losses agree with the JAX mixed-precision step to bf16 accuracy
    (5e-2 relative: 8 bits of mantissa through 6 layers, and the two
    frameworks round at different places)."""
    config = _config(mixed_precision=True)
    state, (factory, _), t_state, (t_factory, _) = both_train_states(config)
    batch = sine_batch(config)
    before = {k: v.detach().clone() for k, v in t_state.params_g.items()}
    _, ref = factory(True, True, True)(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(0))
    _, metrics = t_factory(True, True, True)(t_state, as_torch(batch))
    assert_losses(metrics, ref, LOSS_NAMES, rtol=5e-2)
    assert all(m.dtype == torch.float32 for m in metrics.values())
    moved = 0
    for key, p in t_state.params_g.items():
        assert p.dtype == torch.float32 and torch.isfinite(p).all(), key
        moved += int(not torch.equal(p, before[key]))
    # all but the last layer's residual 1x1 (v, g, bias), which feeds nothing
    assert moved == len(before) - 3
    for leaf in jax.tree.leaves(t_state.opt_g.state_dict()):
        assert leaf.dtype in (torch.float32, torch.int32)


HIFIGAN_LOSS_NAMES = [
    "mel_loss", "adversarial_loss", "feature_matching_loss", "generator_loss",
    "real_loss", "fake_loss", "discriminator_loss",
]


def _assert_extras(t_state, state, atol, what):
    """The spectral-norm vectors and the EMA stream, where the config has
    them, against the JAX state's."""
    if t_state.extra_d:
        assert_tensors(t_state.extra_d, state.extra_d["spectral"], atol,
                       f"{what} u")
    else:
        assert not state.extra_d
    if t_state.ema_g is not None:
        assert_tensors(t_state.ema_g, state.ema_g, atol, f"{what} ema_g")
    else:
        assert state.ema_g is None


@pytest.mark.parametrize("family", ["pwg", "hifigan"])
def test_ckpt_params_exchange_both_ways(tmp_path, family):
    """A .ckpt of either package restores into the other: parameters with
    load_params_only (fresh optimizers), and the whole state (optimizer
    moments and counts, and for HiFi-GAN the spectral-norm vectors u and
    the EMA stream) with load_checkpoint, after which both continue on the
    same trajectory. After the steps the parameters agree to 2e-6 for PWG
    (rates 1e-4 and 5e-5) and to 1e-5 for HiFi-GAN (rate 2e-4: a twentieth
    of one update, whose gradients pass a log of mel energies near the
    clamp)."""
    if family == "pwg":
        config, names, atol = _config(), LOSS_NAMES, 2e-6
    else:
        config, names = small_hifigan_train_config(), HIFIGAN_LOSS_NAMES
        atol = 1e-5
    state, (factory, _), t_state, (t_factory, _) = both_train_states(config)
    step, t_step = factory(True, True, True), t_factory(True, True, True)
    batches = [sine_batch(config, seed=30 + i) for i in range(4)]
    for batch in batches[:2]:
        state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.key(0))
        t_step(t_state, as_torch(batch))
    _assert_extras(t_state, state, atol, "after two steps")

    # JAX -> port
    jax_path = str(tmp_path / "jax-2steps.ckpt")
    jax_ckpt.save_checkpoint(jax_path, state)
    fresh, _, _, _, _ = init_train_state(config, seed=5, device="cpu")
    ckpt.load_params_only(jax_path, fresh)
    assert fresh.steps == 0 and fresh.opt_g.count == 0
    assert_params(fresh.generator, state.params_g, 0, "G")
    assert_params(fresh.discriminator, state.params_d, 0, "D")
    _assert_extras(fresh, state, 0, "params only")
    resumed, gen, dis, opt_g, opt_d = init_train_state(config, seed=6,
                                                       device="cpu")
    ckpt.load_checkpoint(jax_path, resumed)
    assert resumed.steps == 2 and resumed.opt_g.count == 2
    _assert_extras(resumed, state, 0, "resumed")
    r_step = build_steps(config, gen, dis, build_criterion(config), opt_g,
                         opt_d)[0](True, True, True)

    # port -> JAX
    port_path = str(tmp_path / "port-2steps.ckpt")
    ckpt.save_checkpoint(port_path, t_state)
    template = jax_init_train_state(config, jax.random.key(7))[0]
    only = jax_ckpt.load_params_only(port_path, template)
    assert_params(t_state.generator, only.params_g, 0, "G")
    assert_params(t_state.discriminator, only.params_d, 0, "D")
    _assert_extras(t_state, only, 0, "JAX params only")
    assert int(only.steps) == 0
    j_resumed = jax_ckpt.load_checkpoint(port_path, template)
    assert int(j_resumed.steps) == 2
    _assert_extras(t_state, j_resumed, 0, "JAX resumed")

    # every copy takes the same two further steps
    for batch in batches[2:]:
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        state, ref = step(state, jb, jax.random.key(0))
        j_resumed, ref2 = step(j_resumed, jb, jax.random.key(0))
        _, m1 = t_step(t_state, as_torch(batch))
        _, m2 = r_step(resumed, as_torch(batch))
        assert_losses(m1, ref, names, rtol=1e-4)
        assert_losses(m2, ref, names, rtol=1e-4)
        assert_losses(ref2, ref, names, rtol=1e-4)
    assert_params(resumed.generator, state.params_g, atol, "G")
    assert_params(t_state.generator, j_resumed.params_g, atol, "G")
    assert_params(resumed.discriminator, j_resumed.params_d, atol, "D")
    _assert_extras(resumed, state, atol, "resumed, two more steps")
    _assert_extras(t_state, j_resumed, atol, "JAX resumed, two more steps")


def _write_corpus(root, n_utts, num_mels, hop, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n_utts):
        frames = 30 + 7 * i
        t = np.arange(frames * hop + 3)  # a little longer than frames * hop
        wave = 0.3 * np.sin(0.02 * (i + 1) * t) + 0.01 * rng.standard_normal(
            t.shape)
        np.save(os.path.join(root, f"utt{i}-wave.npy"),
                wave.astype(np.float32))
        np.save(os.path.join(root, f"utt{i}-feats.npy"),
                rng.standard_normal((frames, num_mels)).astype(np.float32))


def test_dataset_collater_and_loader_match_the_jax_copies(tmp_path):
    root = str(tmp_path / "dump")
    _write_corpus(root, 5, num_mels=40, hop=64)
    dataset = AudioMelDataset(root, "*-wave.npy", "*-feats.npy", np.load,
                              np.load, mel_length_threshold=36,
                              allow_cache=True)
    assert len(dataset) == 4 and dataset.utt_ids[0] == "utt1"
    audio, mel = dataset[0]
    assert audio.ndim == 1 and mel.shape == (37, 40)
    assert dataset[0][0] is audio  # cached
    kwargs = dict(batch_max_steps=1000, hop_size=64, aux_context_window=2,
                  use_noise_input=True)
    ref_loader = JaxDataLoader(
        dataset, JaxCollater(rng=np.random.default_rng(3), **kwargs),
        batch_size=3, seed=4)
    loader = DataLoader(
        dataset, Collater(rng=np.random.default_rng(3), **kwargs),
        batch_size=3, seed=4)
    assert len(loader) == len(ref_loader) == 1
    for epoch in range(2):
        ref_loader.set_epoch(epoch)
        loader.set_epoch(epoch)
        batches, refs = list(loader), list(ref_loader)
        assert len(batches) == len(refs) == 1
        for batch, ref in zip(batches, refs):
            assert sorted(batch) == ["c", "y", "z"]
            assert batch["y"].shape == (3, 960, 1)
            assert batch["c"].shape == (3, 15 + 4, 40)
            for key in ref:
                np.testing.assert_array_equal(batch[key], ref[key])
    with pytest.raises(ValueError, match="shorter"):
        Collater(batch_max_steps=64 * 100, hop_size=64)([dataset[0]])
    with pytest.raises(ValueError, match="No audio"):
        AudioMelDataset(str(tmp_path / "empty"), "*-wave.npy", "*-feats.npy")


def test_trainer_cli_runs_ten_steps_across_the_warm_up(tmp_path):
    """bin.train.main on a synthetic npy corpus, --device cpu: nothing
    trains at step 0 (strict >), G alone up to the discriminator's start,
    then G+adv+D; logs, eval dumps, checkpoints, and a resume."""
    root = str(tmp_path / "dump")
    _write_corpus(root, 6, num_mels=40, hop=64)
    config = _config(batch_size=2, discriminator_train_start_steps=5,
                     train_max_steps=10, save_interval_steps=8,
                     eval_interval_steps=5, log_interval_steps=5)
    config.pop("fused_wavenet")
    conf_path = str(tmp_path / "conf.yaml")
    with open(conf_path, "w") as f:
        yaml.safe_dump(config, f)
    outdir = str(tmp_path / "exp")
    trainer = train_cli.main([
        "--train-dumpdir", root, "--dev-dumpdir", root, "--outdir", outdir,
        "--config", conf_path, "--device", "cpu", "--seed", "1",
        "--verbose", "0"])
    assert trainer.steps == trainer.state.steps == 10
    assert trainer.device.type == "cpu"
    assert sorted(trainer.last_train_loss) == sorted(
        f"train/{n}" for n in LOSS_NAMES)
    assert sorted(trainer.last_eval_loss) == sorted(
        f"eval/{n}" for n in LOSS_NAMES)
    assert all(np.isfinite(v) for v in trainer.last_train_loss.values())
    # G took 9 updates (steps 1..9 at entry), D 4 (steps 6..9)
    assert trainer.state.opt_g.count == 9 and trainer.state.opt_d.count == 4
    files = os.listdir(outdir)
    assert {"config.yml", "checkpoint-8steps.ckpt",
            "checkpoint-10steps.ckpt", "predictions"} <= set(files)
    assert os.path.exists(
        os.path.join(outdir, "predictions", "10steps", "0_gen.wav"))
    with open(os.path.join(outdir, "config.yml")) as f:
        assert yaml.safe_load(f)["version"] == train_cli.VERSION
    # the JAX package reads the final checkpoint's parameters
    template = jax_init_train_state(config, jax.random.key(0))[0]
    restored = jax_ckpt.load_params_only(
        os.path.join(outdir, "checkpoint-10steps.ckpt"), template)
    assert_params(trainer.generator, restored.params_g, 0, "G")
    # resume continues from the saved step; pretrain starts from 0
    config["train_max_steps"] = 9
    resumed = train_cli.run(config, root, root, str(tmp_path / "exp2"),
                            resume=os.path.join(outdir,
                                                "checkpoint-8steps.ckpt"),
                            seed=1, device="cpu")
    assert resumed.steps == 9 and resumed.state.opt_g.count == 8
    loaders = (resumed.train_loader, resumed.eval_loader)
    fresh = Trainer(config, *loaders, outdir=str(tmp_path / "exp3"),
                    device="cpu")
    fresh.load_checkpoint(os.path.join(outdir, "checkpoint-8steps.ckpt"),
                          load_only_params=True)
    assert fresh.steps == 0 and fresh.state.opt_g.count == 0
    assert fresh._flags() == (False, False, False)
    fresh.steps = 6
    assert fresh._flags() == (True, True, True)
    fresh.steps = 5
    assert fresh._flags() == (True, False, False)


def test_train_state_generator_serves_through_a_gckpt(tmp_path):
    """save_generator_checkpoint folds a trainable generator, and the
    serving path gives the trainable module's function."""
    config = _config()
    state, _, _, _, _ = init_train_state(config, seed=2, device="cpu")
    with torch.no_grad():
        for p in state.params_g.values():  # move g away from ||v||
            p.mul_(1.1).add_(0.01)
    path = str(tmp_path / "generator.gckpt")
    ckpt.save_generator_checkpoint(path, state.generator)
    model = load_model(path, config, device="cpu")
    assert all(k.endswith(("kernel", "bias"))
               for k in model.generator.state_dict())
    batch = as_torch(example_batch(config, batch_size=1))
    with torch.no_grad():
        want = state.generator(batch["z"], batch["c"])
        got = model.generator(batch["z"], batch["c"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    # a .gckpt with kernel_v / kernel_g warm-starts a trainable generator
    full = str(tmp_path / "trainable.gckpt")
    ckpt.save_generator_checkpoint(
        full, {"params": nested(state.generator.state_dict())})
    other, _, _, _, _ = init_train_state(config, seed=3, device="cpu")
    ckpt.load_params_only(full, other)
    for key, value in other.generator.state_dict().items():
        assert torch.equal(value, state.generator.state_dict()[key]), key


def test_build_names_what_is_not_ported():
    config = _config()
    hifigan = small_hifigan_train_config()
    for cfg in (config, hifigan):
        a, b = example_batch(cfg), jax_example_batch(cfg)
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    assert "z" not in example_batch(hifigan)
    gen, dis = build_models(config, torch.Generator().manual_seed(0))
    assert any(k.endswith("kernel_g") for k in gen.state_dict())
    assert any(k.endswith("kernel_v") for k in dis.state_dict())
    gen_h, dis_h = build_models(hifigan, torch.Generator().manual_seed(0))
    assert any(k.endswith("kernel_g") for k in gen_h.state_dict())
    # follow_official_norm: scale 0 spectral-normed, the others weight-normed
    keys = list(dis_h.state_dict())
    assert "msd.discriminators_0.layer_0.u" in keys
    assert "msd.discriminators_0.layer_0.kernel" in keys
    assert "msd.discriminators_1.layer_0.kernel_v" in keys
    assert "mpd.discriminators_1.convs_0.kernel_g" in keys
    # the MelGAN family, StyleMelGAN, VQ-VAE, UHiFiGAN, the residual
    # discriminator, the subband loss, the discrete-symbol families and the
    # duration loss are ported: the F0 generator builds flax's tree, the
    # token generator's example batch is the JAX one, the duration loss is
    # the JAX criterion's; a name the registry lacks raises
    from parallelwavegan_tpu.engine.build import (
        build_models as jax_build_models,
    )
    from parallelwavegan_tpu.engine.criterion import (
        build_criterion as jax_build_criterion,
    )

    f0 = dict(config, generator_type="DiscreteSymbolF0Generator",
              generator_params={
                  "in_channels": 8, "channels": 16, "num_embs": 10,
                  "num_spk_embs": 2, "spk_emb_dim": 8, "linear_channel": 4,
                  "upsample_scales": (4, 4), "upsample_kernel_sizes": (8, 8),
                  "resblock_kernel_sizes": (3,), "resblock_dilations": ((1,),)})
    gen_f0, _ = build_models(f0, torch.Generator().manual_seed(0))
    batch = example_batch(f0)
    flax_f0, _ = jax_build_models(f0)
    shapes = jax.eval_shape(lambda: flax_f0.init(
        jax.random.key(0), batch["c"], batch["f0"], True))["params"]
    assert sorted(nested(gen_f0.state_dict())) == sorted(shapes)
    assert gen_f0.f0_embedding.kernel.shape == \
        shapes["f0_embedding"]["kernel"].shape
    token = dict(f0, generator_type="DiscreteSymbolHiFiGANGenerator")
    token["generator_params"] = {k: v for k, v in f0[
        "generator_params"].items() if k != "linear_channel"}
    a, b = example_batch(token), jax_example_batch(token)
    assert sorted(a) == sorted(b) == ["c", "y"]
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    assert "f0" in batch and "f0" not in jax_example_batch(f0)
    with pytest.raises(NotImplementedError,
                       match="unknown model: NoSuchDiscriminator"):
        build_models(dict(config, discriminator_type="NoSuchDiscriminator"))
    duration = dict(config, use_duration_loss=True,
                    duration_loss_params={"offset": 0.5})
    assert build_criterion(duration)["duration"].offset == \
        jax_build_criterion(duration)["duration"].offset == 0.5
    melgan = dict(config, generator_type="MelGANGenerator",
                  generator_params={"in_channels": 80, "channels": 32,
                                    "upsample_scales": [4, 4]},
                  discriminator_type="ResidualParallelWaveGANDiscriminator",
                  discriminator_params={"layers": 2, "stacks": 1})
    gen_m, dis_m = build_models(melgan, torch.Generator().manual_seed(0))
    assert "layer_0.kernel_v" in gen_m.state_dict()
    assert "conv_layers_1.conv1x1_out.kernel_g" in dis_m.state_dict()
    a, b = example_batch(melgan), jax_example_batch(melgan)
    assert sorted(a) == sorted(b) == ["c", "y"]
    assert sorted(build_criterion(dict(
        melgan, use_subband_stft_loss=True, subband_stft_loss_params={},
        generator_params={"out_channels": 4}))) == [
            "dis_adv", "gen_adv", "pqmf", "stft", "sub_stft"]
    assert sorted(build_criterion(hifigan)) == [
        "dis_adv", "feat_match", "gen_adv", "mel"]
    # an EMA run keeps real copies of the initial parameters
    state, _, _, _, _ = init_train_state(hifigan, seed=0, device="cpu")
    assert sorted(state.ema_g) == sorted(state.params_g)
    for key, value in state.params_g.items():
        assert torch.equal(state.ema_g[key], value)
        assert state.ema_g[key].data_ptr() != value.data_ptr()
        assert not state.ema_g[key].requires_grad
    assert init_train_state(config, device="cpu")[0].ema_g is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_train_state(config)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(config, None)
