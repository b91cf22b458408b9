"""StyleMelGAN training in the port against the JAX package on the CPU:
one (G, adv, D) step of each warm-up variant (and with feature matching),
two steps and ``eval_step``, the mixed-precision step, all on the same
noise and window starts: the port's ``step_generator`` draws them, and the
JAX package is handed the same draws through a stand-in for the ``jax`` name of
its ``models/style_melgan.py`` (``tests.torch_helpers.JaxDraws``); the
random source's order and seeding, a run resumed from a ``.ckpt`` drawing
what an unbroken run draws, ``.ckpt`` both ways, ``--pretrain`` from a
reference ``.pkl``, batches from dump dirs and Kaldi lists, and
chip_smoke's recipe against its yaml."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallelwavegan_tpu.models.style_melgan as jax_style_melgan
from parallelwavegan_tpu.engine import checkpoint as jax_ckpt
from parallelwavegan_tpu.engine.build import (
    example_batch as jax_example_batch,
)
from parallelwavegan_tpu.engine.build import (
    init_train_state as jax_init_train_state,
)
from parallelwavegan_tpu.engine.criterion import (
    build_criterion as jax_build_criterion,
)
from parallelwavegan_tpu.engine.step import build_steps as jax_build_steps
from parallelwavegan_tpu.utils import torch_export as jax_export
from parallelwavegan_torch.bin.train import (
    build_dataset,
    build_loader,
    build_scp_dataset,
    run,
)
from parallelwavegan_torch.engine import checkpoint as ckpt
from parallelwavegan_torch.engine.build import (
    build_models,
    example_batch,
    init_train_state,
)
from parallelwavegan_torch.engine.criterion import build_criterion
from parallelwavegan_torch.engine.step import (
    build_steps,
    needs_step_random,
    step_generator,
    uses_noise,
    with_noise,
)
from parallelwavegan_torch.utils.io import write_wav
from tests.test_torch_reference_pkl import (
    _melgan_msd_name,
    reference_state_dict,
)
from tests.torch_helpers import (
    JaxDraws,
    as_jax,
    as_torch,
    assert_first_moment,
    assert_losses,
    assert_params,
    load_jax_state,
    melgan_perturbed,
    perturbed,
    sine_batch,
    small_melgan_train_config,
    small_style_melgan_train_config,
)

torch.set_num_threads(2)

FLAGS = {"g_only": (True, False, False), "g_adv_d": (True, True, True),
         "d_only": (False, False, True)}
G_NAMES = ["spectral_convergence_loss", "log_stft_magnitude_loss",
           "generator_loss"]
D_NAMES = ["real_loss", "fake_loss", "discriminator_loss"]


@functools.lru_cache(maxsize=1)
def _jax_initial():
    """The JAX train state of the small recipe, perturbed (the generator
    by 20 %, the discriminator's weight-norm g near 1 as MelGAN's tests
    do), with optimizer states for the perturbed parameters; built once
    (flax's eager init compiles each op)."""
    config = small_style_melgan_train_config()
    state, gen, dis, opt_g, opt_d = jax_init_train_state(
        config, jax.random.key(0))
    params_g = perturbed(state.params_g, np.random.default_rng(0))
    params_d = melgan_perturbed(state.params_d, 1)
    return state.replace(params_g=params_g, opt_g=opt_g.init(params_g),
                         params_d=params_d, opt_d=opt_d.init(params_d)), \
        gen, dis, opt_g, opt_d


def _both(config):
    """(JAX state, JAX (factory, eval_step), port state, port (factory,
    eval_step)) on the same parameters; the port on the CPU."""
    state, gen, dis, opt_g, opt_d = _jax_initial()
    state = jax.tree.map(jnp.array, state)
    jax_steps = jax_build_steps(config, gen, dis, jax_build_criterion(config),
                                opt_g, opt_d)
    t_state, t_gen, t_dis, t_opt_g, t_opt_d = init_train_state(
        config, 0, device="cpu")
    load_jax_state(state, t_gen, t_dis)
    steps = build_steps(config, t_gen, t_dis, build_criterion(config),
                        t_opt_g, t_opt_d)
    return state, jax_steps, t_state, steps


def _draws(t_state, batch, passes, steps, stream=0):
    """The draws of step_generator(0, steps, stream) in the order ``passes``
    names them ("z" the noise, "w" one pass's 8 window starts), as a
    stand-in for the JAX module's ``jax`` that hands them out."""
    g = step_generator(0, steps, stream)
    B, frames = batch["c"].shape[:2]
    normals, ints = [], []
    for p in passes:
        if p == "z":
            normals.append(t_state.generator.draw_noise(B, frames, g).numpy())
        else:
            ints += t_state.discriminator.draw_window_starts(
                batch["y"].shape[1], g)
    return JaxDraws(normals, ints)


def _passes(flags, feat_match=False):
    """What one step draws, in the order the docstring of engine/step.py
    gives: G update z, the fake pass, the real pass with feature matching;
    D update a fresh z for the recompute, the real pass, the fake pass."""
    train_g, use_adv, train_d = flags
    out = ""
    if train_g:
        out += "z" + ("w" + "w" * feat_match if use_adv else "")
    if train_d:
        out += "zww"
    return out


def _jax_step(monkeypatch, factory, flags, state, batch, draws):
    """One JAX step, traced afresh on ``draws``; every draw is used."""
    monkeypatch.setattr(jax_style_melgan, "jax", draws)
    out = factory.__wrapped__(*flags)(state, as_jax(batch),
                                      jax.random.key(0))
    assert draws.random.normals == [] and draws.random.ints == []
    return out


def _names(flags, feat_match=False):
    train_g, use_adv, train_d = flags
    names = list(G_NAMES) if train_g else []
    if use_adv:
        names += ["adversarial_loss"]
        if feat_match:
            names += ["feature_matching_loss"]
    return names + (D_NAMES if train_d else [])


@pytest.mark.parametrize("case", ["g_only", "g_adv_d", "d_only",
                                  "g_adv_d_feat_match"])
def test_train_step_matches_jax(monkeypatch, case):
    """One step on the same parameters, batch, noise and window starts:
    the losses to 1e-5 relative, the gradients through the optimizers'
    first moments, the updated parameters to 1e-6 absolute."""
    fm = case.endswith("feat_match")
    flags = FLAGS[case.replace("_feat_match", "")]
    config = small_style_melgan_train_config(
        **({"use_feat_match_loss": True, "lambda_feat_match": 2.0}
           if fm else {}))
    state, (factory, _), t_state, (t_factory, _) = _both(config)
    batch = sine_batch(config)
    assert sorted(batch) == ["c", "y"]
    draws = _draws(t_state, batch, _passes(flags, fm), 0)
    new_state, ref = _jax_step(monkeypatch, factory, flags, state, batch,
                               draws)
    _, metrics = t_factory(*flags)(t_state, as_torch(batch),
                                   step_generator(0, 0))
    assert_losses(metrics, ref, _names(flags, fm), rtol=1e-5)
    assert t_state.steps == int(new_state.steps) == 1
    assert_params(t_state.generator, new_state.params_g, 1e-6, "G")
    assert_params(t_state.discriminator, new_state.params_d, 1e-6, "D")
    if flags[0]:
        assert_first_moment(t_state.opt_g, new_state.opt_g, "G")
    if flags[2]:
        assert_first_moment(t_state.opt_d, new_state.opt_d, "D")


def test_two_steps_and_eval_step_match_jax(monkeypatch):
    """Two G+adv+D steps, each on the draws of its step count, then
    eval_step with and without the adversarial terms (noise, the fake
    pass, then the discriminator's real and fake passes): losses to 1e-4
    relative, parameters to 2e-6."""
    config = small_style_melgan_train_config()
    state, (factory, eval_step), t_state, (t_factory, t_eval) = \
        _both(config)
    flags = (True, True, True)
    for i in range(2):
        batch = sine_batch(config, seed=10 + i)
        draws = _draws(t_state, batch, _passes(flags), i)
        state, ref = _jax_step(monkeypatch, factory, flags, state, batch,
                               draws)
        _, metrics = t_factory(*flags)(t_state, as_torch(batch),
                                       step_generator(0, i))
        assert_losses(metrics, ref, _names(flags), rtol=1e-4)
    assert_params(t_state.generator, state.params_g, 2e-6, "G")
    assert_params(t_state.discriminator, state.params_d, 2e-6, "D")
    batch = sine_batch(config, seed=20)
    for use_adv in (True, False):
        draws = _draws(t_state, batch, "zwww" if use_adv else "z", 2, 1)
        monkeypatch.setattr(jax_style_melgan, "jax", draws)
        ref = eval_step(state, as_jax(batch), jax.random.key(0), use_adv)
        metrics = t_eval(t_state, as_torch(batch), use_adv,
                         step_generator(0, 2, 1))
        assert draws.random.normals == [] and draws.random.ints == []
        assert_losses(metrics, ref, _names((True, use_adv, use_adv)),
                      rtol=1e-4)


def test_mixed_precision_step_matches_jax(monkeypatch):
    """bf16 networks on bf16 copies of z (cast as the batch is), f32
    losses: the losses agree with the JAX mixed step to bf16 accuracy
    (5e-2 relative), the master parameters stay float32 and move."""
    config = small_style_melgan_train_config(mixed_precision=True)
    state, (factory, _), t_state, (t_factory, _) = _both(config)
    batch = sine_batch(config)
    flags = (True, True, True)
    before = {k: v.detach().clone() for k, v in
              {**t_state.params_g, **t_state.params_d}.items()}
    draws = _draws(t_state, batch, _passes(flags), 0)
    _, ref = _jax_step(monkeypatch, factory, flags, state, batch, draws)
    _, metrics = t_factory(*flags)(t_state, as_torch(batch),
                                   step_generator(0, 0))
    assert_losses(metrics, ref, _names(flags), rtol=5e-2)
    assert all(m.dtype == torch.float32 for m in metrics.values())
    params = {**t_state.params_g, **t_state.params_d}
    moved = sum(not torch.equal(p, before[k]) for k, p in params.items())
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
               for p in params.values())
    assert moved >= len(params) - 2, moved


def test_step_needs_its_random_source():
    """StyleMelGAN's step and eval_step raise without a random source; the
    other families neither take z from it nor need it; the source is a
    function of (seed, steps, stream)."""
    config = small_style_melgan_train_config()
    assert needs_step_random(config) and not uses_noise(config)
    _, _, t_state, (t_factory, t_eval) = _both(config)
    batch = as_torch(sine_batch(config))
    with pytest.raises(ValueError, match="step_generator"):
        t_factory(True, True, True)(t_state, batch)
    with pytest.raises(ValueError, match="step_generator"):
        t_eval(t_state, batch)
    assert t_state.steps == 0
    melgan = small_melgan_train_config("mb_melgan")
    assert not needs_step_random(melgan)
    gen, _ = build_models(melgan)
    assert with_noise(gen, batch, None) is batch
    assert not needs_step_random(dict(melgan,
                                      generator_type="HiFiGANGenerator"))
    assert needs_step_random(dict(
        melgan, discriminator_type="StyleMelGANDiscriminator"))

    def first(*key):
        return torch.randn(4, generator=step_generator(*key))

    assert torch.equal(first(3, 5), first(3, 5))
    assert not torch.equal(first(3, 5), first(3, 6))
    assert not torch.equal(first(3, 5), first(4, 5))
    assert not torch.equal(first(3, 5, 0), first(3, 5, 1))


def test_build_and_example_batch_follow_jax():
    """c with no context window and no z, as the JAX package's example
    batch; both modules in their training form."""
    config = small_style_melgan_train_config()
    want = jax_example_batch(config)
    got = example_batch(config)
    assert sorted(got) == sorted(want) == ["c", "y"]
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()} == {"y": (2, 384, 1),
                                                 "c": (2, 24, 16)}
    gen, dis = build_models(config, torch.Generator().manual_seed(0))
    assert "blocks_0.tade1.aux_conv.kernel_v" in gen.state_dict()
    assert "noise_upsample_1.kernel_g" in gen.state_dict()
    assert gen.noise_upsample_1.kernel_g.shape == (1, 16, 1)
    assert "discriminators_3.layer_0.kernel_v" in dis.state_dict()
    assert dis.discriminators_3.layer_0.kernel_v.shape[1] == 8


def _write_corpus(root, config, n, frames, seed=0):
    """n npy dump pairs and a wav.scp + feats.scp of the same utterances
    (16-bit wav files); returns (dump dir, scp split)."""
    rng = np.random.default_rng(seed)
    hop, sr = config["hop_size"], config["sampling_rate"]
    os.makedirs(root)
    wav_lines, feats_lines = [], []
    for i in range(n):
        t = np.arange(frames * hop) / sr
        wave = (0.3 * np.sin(2 * np.pi * (300 + 40 * i) * t)
                + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
        mel = rng.standard_normal((frames, config["num_mels"])).astype(
            np.float32)
        np.save(os.path.join(root, f"u{i}-wave.npy"), wave)
        np.save(os.path.join(root, f"u{i}-feats.npy"), mel)
        write_wav(os.path.join(root, f"u{i}.wav"), wave, sr)
        wav_lines.append(f"u{i} {os.path.join(root, f'u{i}.wav')}")
        feats_lines.append(f"u{i} {os.path.join(root, f'u{i}-feats.npy')}")
    split = {"wav_scp": os.path.join(root, "wav.scp"),
             "feats_scp": os.path.join(root, "feats.scp")}
    for key, lines in (("wav_scp", wav_lines), ("feats_scp", feats_lines)):
        with open(split[key], "w") as f:
            f.write("\n".join(lines) + "\n")
    return root, split


def test_batches_from_dump_dirs_and_kaldi_lists(tmp_path):
    """Both inputs give the step's batches: y (B, 384, 1) and c (B, 24,
    16), the window one noise grid long, no context, no z."""
    config = small_style_melgan_train_config()
    root, split = _write_corpus(str(tmp_path / "corpus"), config, 4, 40)
    for dataset in (build_dataset(config, root),
                    build_scp_dataset(config, split["wav_scp"],
                                      split["feats_scp"])):
        batch = next(iter(build_loader(config, dataset, seed=0)))
        assert sorted(batch) == ["c", "y"]
        assert batch["y"].shape == (2, 384, 1)
        assert batch["c"].shape == (2, 24, 16)


def test_resumed_run_draws_what_an_unbroken_run_draws(tmp_path):
    """bin.train.run on identical utterances one window long (so every
    batch is the same and only the step's draws differ from step to
    step): three steps, against two steps and one more resumed from the
    .ckpt, end on equal parameters."""
    config = small_style_melgan_train_config(
        train_max_steps=3, save_interval_steps=100, eval_interval_steps=100,
        log_interval_steps=100, num_workers=0)
    root = str(tmp_path / "corpus")
    os.makedirs(root)
    rng = np.random.default_rng(0)
    wave = (0.3 * np.sin(np.arange(400) / 3.0)).astype(np.float32)
    mel = rng.standard_normal((25, 16)).astype(np.float32)
    for i in range(2):
        np.save(os.path.join(root, f"u{i}-wave.npy"), wave)
        np.save(os.path.join(root, f"u{i}-feats.npy"), mel)
    kw = dict(seed=3, device="cpu", dump_config=False)
    whole = run(config, root, root, str(tmp_path / "whole"), **kw)
    first = run(dict(config, train_max_steps=2), root, root,
                str(tmp_path / "first"), **kw)
    resumed = run(config, root, root, str(tmp_path / "resumed"),
                  resume=str(tmp_path / "first" / "checkpoint-2steps.ckpt"),
                  **kw)
    assert whole.steps == resumed.steps == 3
    want = {**whole.state.params_g, **whole.state.params_d}
    got = {**resumed.state.params_g, **resumed.state.params_d}
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    assert not torch.equal(first.state.params_g["output_conv.bias"],
                           want["output_conv.bias"])


def test_ckpt_exchange_both_ways(monkeypatch, tmp_path):
    """A StyleMelGAN train state after one step through a .ckpt of either
    package into the other: parameters, optimizer states and the step."""
    config = small_style_melgan_train_config()
    state, (factory, _), t_state, (t_factory, _) = _both(config)
    batch = sine_batch(config)
    flags = (True, True, True)
    state, _ = _jax_step(monkeypatch, factory, flags, state, batch,
                         _draws(t_state, batch, _passes(flags), 0))
    t_factory(*flags)(t_state, as_torch(batch), step_generator(0, 0))

    jax_path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(jax_path, state)
    resumed = init_train_state(config, seed=4, device="cpu")[0]
    ckpt.load_checkpoint(jax_path, resumed)
    assert resumed.steps == 1 and resumed.opt_g.count == 1
    assert_params(resumed.generator, state.params_g, 0, "G")
    assert_params(resumed.discriminator, state.params_d, 0, "D")

    port_path = str(tmp_path / "port.ckpt")
    ckpt.save_checkpoint(port_path, t_state)
    template = jax.tree.map(jnp.array, _jax_initial()[0])
    back = jax_ckpt.load_checkpoint(port_path, template)
    assert int(back.steps) == 1
    assert_params(t_state.generator, back.params_g, 0, "G")
    assert_params(t_state.discriminator, back.params_d, 0, "D")
    assert_first_moment(t_state.opt_d, back.opt_d, "D", rel=0, floor=0)


def test_pretrain_from_a_reference_pkl(tmp_path):
    """--pretrain semantics from a StyleMelGAN .pkl with its
    discriminator beside the generator: both networks load, the
    optimizers and the step stay fresh."""
    config = small_style_melgan_train_config()
    state = _jax_initial()[0]
    path = str(tmp_path / "checkpoint-5steps.pkl")
    jax_export.save_reference_checkpoint(path, state.params_g, config,
                                         steps=5)
    pkl = torch.load(path, weights_only=True)
    names = _melgan_msd_name(len(config["discriminator_params"][
        "discriminator_params"]["downsample_scales"]) + 2)
    pkl["model"]["discriminator"] = reference_state_dict(
        jax.tree.map(np.asarray, {"params": state.params_d}), names)
    torch.save(pkl, path)
    t_state = init_train_state(config, seed=1, device="cpu")[0]
    ckpt.load_params_only(path, t_state, config=config)
    assert t_state.steps == 0 and t_state.opt_g.count == 0
    assert_params(t_state.discriminator, state.params_d, 0, "D")
    assert_params(t_state.generator, state.params_g, 0, "G")


def test_smoke_training_config_is_the_yaml():
    """chip_smoke trains StyleMelGAN v1 at full width (the GPU machine has
    no yaml): every key of STYLE_MELGAN_V1_TRAIN says what the file says
    but the data format of a seeded npy corpus; every recipe key of the
    file is there; what the script cuts is named apart."""
    import yaml

    import chip_smoke

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "egs/ljspeech/voc1/conf",
                           "style_melgan.v1.yaml")) as f:
        want = yaml.safe_load(f)
    got = chip_smoke.STYLE_MELGAN_V1_TRAIN
    cuts = chip_smoke.STYLE_MELGAN_V1_TRAIN_CUT
    for key, value in got.items():
        if key != "format":
            assert want[key] == value, key
    recipe = [k for k in want if k.startswith((
        "generator_", "discriminator_", "lambda_", "use_", "stft_",
        "batch_", "sampling_", "hop_", "num_mels"))]
    assert not set(recipe) - set(got) - set(cuts)
    assert not set(cuts) & set(got)
    assert set(cuts) <= set(want)
