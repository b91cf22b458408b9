"""VQ-VAE training in the port against the JAX package on the CPU: the
(G, adv, D) step's warm-up variants with a global, a local and no
condition, ``eval_step``, the mixed-precision step, the step at
``in_channels`` 4 (the PQMF analysis of y), the dead-code restart at
``vq_restart_prob`` 1.0 and 0.5 on the same draws (the port's
``step_generator`` draws them; the JAX step is handed them through a
stand-in for its ``jax`` name, ``tests.torch_helpers.JaxDraws``), ``.ckpt``
both ways after a restart, ``bin.train.run`` from npy dumps with speaker
ids and local conditions and a resumed run against an unbroken one, the
example batch, and chip_smoke's recipes against their yaml."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallelwavegan_tpu.engine.step as jax_step_module
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
from parallelwavegan_torch.bin import decode as decode_cli
from parallelwavegan_torch.bin.train import run
from parallelwavegan_torch.engine import checkpoint as ckpt
from parallelwavegan_torch.engine.build import example_batch, init_train_state
from parallelwavegan_torch.engine.criterion import build_criterion
from parallelwavegan_torch.engine.step import (
    SHARED_STREAM,
    build_steps,
    needs_step_random,
    step_generator,
)
from parallelwavegan_torch.utils.model_loader import load_model
from tests.torch_helpers import (
    JaxDraws,
    as_jax,
    as_torch,
    assert_first_moment,
    assert_losses,
    assert_params,
    load_jax_state,
    melgan_perturbed,
    seed_codebook,
    sine_batch,
    small_vqvae_train_config,
)

torch.set_num_threads(2)

FLAGS = {"g_only": (True, False, False), "g_adv_d": (True, True, True),
         "d_only": (False, False, True)}
G_NAMES = ["quantization_loss", "commitment_loss",
           "spectral_convergence_loss", "log_stft_magnitude_loss",
           "generator_loss"]
ADV_NAMES = ["adversarial_loss", "feature_matching_loss"]
D_NAMES = ["real_loss", "fake_loss", "discriminator_loss"]
CODES = 16  # the small recipe's codebook


def _names(flags, restart=False):
    train_g, use_adv, train_d = flags
    names = list(G_NAMES) if train_g else []
    names += ADV_NAMES if use_adv else []
    names += ["vq_codes_used"] if restart and train_g else []
    return names + (D_NAMES if train_d else [])


def _batch(config, seed=1):
    """The JAX example batch with sines as y and speaker ids 1 and 3."""
    batch = sine_batch(config, seed=seed)
    if "g" in batch:
        batch["g"] = np.array([1, 3], np.int32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_initial(cond, seeded):
    """The JAX train state of the cond's small recipe, moved off its init
    as the MelGAN tests move it, with optimizer states for those
    parameters; ``seeded``: the codebook rows are latents of the sine
    batch (else the U(+-1/K) init, where most codes are dead)."""
    config = small_vqvae_train_config(cond)
    state, gen, dis, opt_g, opt_d = jax_init_train_state(
        config, jax.random.key(0))
    params_g = melgan_perturbed(state.params_g, 0)
    if seeded:
        b = as_jax(_batch(config))
        z_e = gen.apply({"params": params_g}, b["y"], b.get("l"),
                        b.get("g"))[1]
        params_g = seed_codebook({"params": params_g}, z_e)["params"]
    else:
        params_g["codebook"]["embedding"] = \
            state.params_g["codebook"]["embedding"]
    params_d = melgan_perturbed(state.params_d, 1)
    return state.replace(params_g=params_g, opt_g=opt_g.init(params_g),
                         params_d=params_d, opt_d=opt_d.init(params_d)), \
        gen, dis, opt_g, opt_d


def _both(config, cond, seeded=True):
    """(JAX state, JAX (factory, eval_step), port state, port (factory,
    eval_step)) on the same parameters; the port on the CPU."""
    state, gen, dis, opt_g, opt_d = _jax_initial(cond, seeded)
    state = jax.tree.map(jnp.array, state)
    jax_steps = jax_build_steps(config, gen, dis, jax_build_criterion(config),
                                opt_g, opt_d)
    t_state, t_gen, t_dis, t_opt_g, t_opt_d = init_train_state(
        config, 0, device="cpu")
    load_jax_state(state, t_gen, t_dis)
    steps = build_steps(config, t_gen, t_dis, build_criterion(config),
                        t_opt_g, t_opt_d)
    return state, jax_steps, t_state, steps


def _restart_draws(batch, config, steps=0):
    """The restart's draws of step_generator(0, steps): the rows from the
    step's stream, the gate's uniforms from the shared one, as a stand-in
    for the JAX step module's ``jax`` that hands them out."""
    latents = batch["y"].shape[0] * batch["y"].shape[1] // 16
    rows = torch.randint(0, latents, (CODES,),
                         generator=step_generator(0, steps)).numpy()
    gate = torch.rand(CODES, generator=step_generator(
        0, steps, SHARED_STREAM)).numpy()
    return JaxDraws(ints=[rows], uniforms=[gate])


def _port_step(t_factory, flags, t_state, batch, steps=0):
    return t_factory(*flags)(t_state, as_torch(batch),
                             step_generator(0, steps),
                             step_generator(0, steps, SHARED_STREAM))


@pytest.mark.parametrize("cond, case", [
    ("global", "g_only"), ("global", "g_adv_d"), ("global", "d_only"),
    ("none", "g_adv_d"), ("local", "g_adv_d")])
def test_train_step_matches_jax(cond, case):
    """One step on the same parameters and batch: every loss to 1e-5
    relative, the gradients through the optimizers' first moments, the
    updated parameters (the codebook included) to 1e-6 absolute."""
    flags = FLAGS[case]
    config = small_vqvae_train_config(cond)
    state, (factory, _), t_state, (t_factory, _) = _both(config, cond)
    batch = _batch(config)
    assert sorted(batch) == {"none": ["y"], "global": ["g", "y"],
                             "local": ["g", "l", "y"]}[cond]
    new_state, ref = factory.__wrapped__(*flags)(state, as_jax(batch),
                                                 jax.random.key(0))
    _, metrics = _port_step(t_factory, flags, t_state, batch)
    assert_losses(metrics, ref, _names(flags), rtol=1e-5)
    assert t_state.steps == int(new_state.steps) == 1
    assert_params(t_state.generator, new_state.params_g, 1e-6, "G")
    assert_params(t_state.discriminator, new_state.params_d, 1e-6, "D")
    if flags[0]:
        assert_first_moment(t_state.opt_g, new_state.opt_g, "G")
    if flags[2]:
        assert_first_moment(t_state.opt_d, new_state.opt_d, "D")


def test_eval_step_matches_jax():
    """eval_step with and without the adversarial terms, after a step."""
    config = small_vqvae_train_config("local")
    state, (factory, eval_step), t_state, (t_factory, t_eval) = \
        _both(config, "local")
    flags = FLAGS["g_adv_d"]
    batch = _batch(config)
    state, _ = factory.__wrapped__(*flags)(state, as_jax(batch),
                                           jax.random.key(0))
    _port_step(t_factory, flags, t_state, batch)
    batch = _batch(config, seed=5)
    for use_adv in (True, False):
        ref = eval_step(state, as_jax(batch), jax.random.key(0), use_adv)
        metrics = t_eval(t_state, as_torch(batch), use_adv)
        assert_losses(metrics, ref, _names((True, use_adv, use_adv)),
                      rtol=1e-4)


def test_mixed_precision_step_matches_jax():
    """bf16 networks, bf16 code distances and argmin, f32 losses: the
    losses agree with the JAX mixed step to bf16 accuracy (5e-2
    relative), the master parameters stay float32 and move."""
    config = small_vqvae_train_config("global", mixed_precision=True)
    state, (factory, _), t_state, (t_factory, _) = _both(config, "global")
    batch = _batch(config)
    flags = FLAGS["g_adv_d"]
    before = {k: v.detach().clone() for k, v in
              {**t_state.params_g, **t_state.params_d}.items()}
    _, ref = factory.__wrapped__(*flags)(state, as_jax(batch),
                                         jax.random.key(0))
    _, metrics = _port_step(t_factory, flags, t_state, batch)
    assert_losses(metrics, ref, _names(flags), rtol=5e-2)
    assert all(m.dtype == torch.float32 for m in metrics.values())
    params = {**t_state.params_g, **t_state.params_d}
    moved = sum(not torch.equal(p, before[k]) for k, p in params.items())
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
               for p in params.values())
    assert moved >= len(params) - 2, moved


def test_step_on_pqmf_subbands_matches_jax():
    """in_channels 4 (no recipe sets it): the encoder takes the PQMF
    analysis of y, a 4-band decoder's output is merged by PQMF before the
    loss; losses to 1e-5, parameters to 1e-6, as the JAX step. (The JAX
    package's init_train_state builds a 1-channel encoder there: its
    example batch has no x_vq. The test hands it one.)"""
    config = small_vqvae_train_config("none")
    gp = config["generator_params"]
    gp.update(in_channels=4, out_channels=4)
    gp["encoder_conf"]["downsample_scales"] = [4]
    gp["decoder_conf"]["upsample_scales"] = [4]
    init = jax_example_batch(config)
    init["x_vq"] = jax_build_criterion(config)["pqmf"].analysis(
        jnp.asarray(init["y"]))
    state, gen, dis, opt_g, opt_d = jax_init_train_state(
        config, jax.random.key(0), batch=init)
    params_g = melgan_perturbed(state.params_g, 0)
    params_d = melgan_perturbed(state.params_d, 1)
    state = state.replace(params_g=params_g, opt_g=opt_g.init(params_g),
                          params_d=params_d, opt_d=opt_d.init(params_d))
    factory, _ = jax_build_steps(config, gen, dis,
                                 jax_build_criterion(config), opt_g, opt_d)
    t_state, t_gen, t_dis, t_opt_g, t_opt_d = init_train_state(
        config, 0, device="cpu")
    load_jax_state(state, t_gen, t_dis)
    t_factory, _ = build_steps(config, t_gen, t_dis, build_criterion(config),
                               t_opt_g, t_opt_d)
    batch = _batch(config)
    flags = FLAGS["g_adv_d"]
    new_state, ref = factory.__wrapped__(*flags)(state, as_jax(batch),
                                                 jax.random.key(0))
    _, metrics = _port_step(t_factory, flags, t_state, batch)
    assert_losses(metrics, ref, _names(flags), rtol=1e-5)
    assert_params(t_state.generator, new_state.params_g, 1e-6, "G")
    assert_params(t_state.discriminator, new_state.params_d, 1e-6, "D")


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_dead_code_restart_matches_jax(monkeypatch, prob):
    """From the U(+-1/K) codebook, where most codes are dead: the restart
    after the generator's update on the port's draws (rows from the
    step's stream, the gate from the shared one) gives the JAX step's
    codebook rows, vq_codes_used and every other parameter."""
    config = small_vqvae_train_config(
        "global", vq_dead_code_restart=True, vq_restart_prob=prob)
    assert needs_step_random(config)
    state, (factory, _), t_state, (t_factory, _) = _both(config, "global",
                                                         seeded=False)
    batch = _batch(config)
    flags = FLAGS["g_adv_d"]
    draws = _restart_draws(batch, config)
    gate = draws.random.uniforms[0] < prob
    monkeypatch.setattr(jax_step_module, "jax", draws)
    new_state, ref = factory.__wrapped__(*flags)(state, as_jax(batch),
                                                 jax.random.key(0))
    assert draws.random.ints == [] and draws.random.uniforms == []
    monkeypatch.undo()
    before = t_state.params_g["codebook.embedding"].detach().clone()
    _, metrics = _port_step(t_factory, flags, t_state, batch)
    assert_losses(metrics, ref, _names(flags, restart=True), rtol=1e-5)
    used = int(metrics["vq_codes_used"])
    assert 1 <= used <= CODES // 2, used  # most codes dead at init
    after = t_state.params_g["codebook.embedding"].detach()
    restarted = (after - before).abs().max(dim=1).values > 0.05
    assert not restarted[~torch.from_numpy(gate)].any()
    if prob == 1.0:
        assert int(restarted.sum()) == CODES - used
    else:
        assert 0 < int(restarted.sum()) < CODES - used
    assert_params(t_state.generator, new_state.params_g, 1e-6, "G")
    assert_params(t_state.discriminator, new_state.params_d, 1e-6, "D")


def test_restart_needs_both_random_sources():
    config = small_vqvae_train_config("none", vq_dead_code_restart=True)
    _, _, t_state, (t_factory, _) = _both(config, "none")
    batch = as_torch(_batch(config))
    with pytest.raises(ValueError, match="step_generator"):
        t_factory(True, False, False)(t_state, batch)
    with pytest.raises(ValueError, match="SHARED_STREAM"):
        t_factory(True, False, False)(t_state, batch, step_generator(0, 0))
    assert t_state.steps == 0
    assert not needs_step_random(small_vqvae_train_config("none"))


def test_ckpt_both_ways_after_a_restart(monkeypatch, tmp_path):
    """A train state after a step with restarts through a .ckpt of either
    package into the other: parameters (the restarted codebook), the
    optimizer states and the step."""
    config = small_vqvae_train_config("global", vq_dead_code_restart=True)
    state, (factory, _), t_state, (t_factory, _) = _both(config, "global",
                                                         seeded=False)
    batch = _batch(config)
    flags = FLAGS["g_adv_d"]
    monkeypatch.setattr(jax_step_module, "jax",
                        _restart_draws(batch, config))
    state, _ = factory.__wrapped__(*flags)(state, as_jax(batch),
                                           jax.random.key(0))
    monkeypatch.undo()
    _port_step(t_factory, flags, t_state, batch)

    jax_path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(jax_path, state)
    resumed = init_train_state(config, seed=4, device="cpu")[0]
    ckpt.load_checkpoint(jax_path, resumed)
    assert resumed.steps == 1 and resumed.opt_g.count == 1
    assert_params(resumed.generator, state.params_g, 0, "G")
    assert_params(resumed.discriminator, state.params_d, 0, "D")

    port_path = str(tmp_path / "port.ckpt")
    ckpt.save_checkpoint(port_path, t_state)
    template = jax.tree.map(jnp.array, _jax_initial("global", False)[0])
    back = jax_ckpt.load_checkpoint(port_path, template)
    assert int(back.steps) == 1
    assert_params(t_state.generator, back.params_g, 0, "G")
    assert_params(t_state.discriminator, back.params_d, 0, "D")
    assert_first_moment(t_state.opt_g, back.opt_g, "G", rel=0, floor=0)


@pytest.mark.parametrize("cond", ["none", "global", "local"])
def test_example_batch_follows_jax(cond):
    config = small_vqvae_train_config(cond)
    want = jax_example_batch(config)
    got = example_batch(config)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _write_corpus(root, n, cond, T=1000, seed=0, same=False):
    """n npy wav2wav dumps: ``-wave.npy``, and as the cond asks
    ``-global.npy`` (speaker i % 4) and ``-local.npy`` (T // 16 frames of
    2 channels); ``same``: one utterance and speaker n times."""
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    for i in range(n):
        j = 0 if same else i
        t = np.arange(T) / 8000.0
        wave = (0.4 * np.sin(2 * np.pi * (200 + 60 * j) * t)
                + 0.02 * np.random.default_rng(j).standard_normal(T)
                ).astype(np.float32)
        np.save(os.path.join(root, f"u{i}-wave.npy"), wave)
        if cond in ("global", "local"):
            np.save(os.path.join(root, f"u{i}-global.npy"),
                    np.array([j % 4]))
        if cond == "local":
            np.save(os.path.join(root, f"u{i}-local.npy"),
                    rng.standard_normal((T // 16, 2)).astype(np.float32))
    return root


def test_train_run_from_npy_dumps_then_serve(tmp_path):
    """bin.train.run from npy dumps with speaker ids and local conditions
    (restarts on, 3 steps, one evaluation); the run's .ckpt serves through
    load_model with the dumps' conditions; bin.decode refuses those npy
    dumps (the conditions are read from hdf5)."""
    config = small_vqvae_train_config(
        "local", vq_dead_code_restart=True, train_max_steps=3,
        save_interval_steps=3, eval_interval_steps=3, log_interval_steps=1,
        num_workers=0)
    root = _write_corpus(str(tmp_path / "dump"), 4, "local")
    trainer = run(config, root, root, str(tmp_path / "exp"), seed=0,
                  device="cpu", dump_config=False)
    assert trainer.steps == 3
    names = set(trainer.last_train_loss)
    assert {f"train/{k}" for k in _names(FLAGS["g_adv_d"], True)} <= names
    assert all(np.isfinite(v) for v in trainer.last_train_loss.values())
    assert "eval/quantization_loss" in trainer.last_eval_loss
    assert os.path.exists(tmp_path / "exp/predictions/3steps/0_gen.wav")
    path = str(tmp_path / "exp/checkpoint-3steps.ckpt")
    with open(tmp_path / "config.json", "w") as f:
        json.dump(config, f)
    model = load_model(path, config, device="cpu")
    wave = np.load(os.path.join(root, "u1-wave.npy"))
    local = np.load(os.path.join(root, "u1-local.npy"))
    codes = model.vq_encode(wave[: 62 * 16])
    y = model.vq_decode(codes, l=local[:62], g=1)
    assert codes.shape == (62,) and y.shape == (62 * 16, 1)
    assert np.isfinite(y).all()
    with pytest.raises(ValueError, match="hdf5"):
        decode_cli.main(["--dumpdir", root, "--checkpoint", path,
                         "--config", str(tmp_path / "config.json"),
                         "--outdir", str(tmp_path / "out"), "--device",
                         "cpu"])


def test_unconditioned_run_then_decode_cli(tmp_path):
    """bin.train.run from npy dumps, then bin.decode on the run's .ckpt:
    a wav and a line of ``text`` an utterance, the codes those vq_encode
    gives."""
    from scipy.io import wavfile

    config = small_vqvae_train_config(
        "none", train_max_steps=2, save_interval_steps=2,
        eval_interval_steps=100, log_interval_steps=100, num_workers=0)
    root = _write_corpus(str(tmp_path / "dump"), 3, "none")
    run(config, root, root, str(tmp_path / "exp"), seed=0, device="cpu",
        dump_config=False)
    path = str(tmp_path / "exp/checkpoint-2steps.ckpt")
    conf = str(tmp_path / "config.json")
    with open(conf, "w") as f:
        json.dump(config, f)
    out = tmp_path / "out"
    decode_cli.main(["--dumpdir", root, "--checkpoint", path, "--config",
                     conf, "--outdir", str(out), "--device", "cpu"])
    model = load_model(path, config, device="cpu")
    lines = (out / "text").read_text().splitlines()
    assert [ln.split()[0] for ln in lines] == ["u0", "u1", "u2"]
    for i, line in enumerate(lines):
        wave = np.load(os.path.join(root, f"u{i}-wave.npy"))
        codes = model.vq_encode(wave)
        assert line.split()[1:] == [str(c) for c in codes]
        sr, y = wavfile.read(out / f"u{i}_gen.wav")
        assert sr == 8000 and y.shape == (len(codes) * 16,)


def test_resumed_run_equals_an_unbroken_run(tmp_path):
    """With restarts at probability 0.5, on identical utterances one
    window long (so every batch is the same and only the restart's draws
    differ from step to step): three steps, against two steps and one
    more resumed from the .ckpt, end on equal parameters (the draws are
    functions of the seed and the step)."""
    config = small_vqvae_train_config(
        "global", vq_dead_code_restart=True, vq_restart_prob=0.5,
        train_max_steps=3, save_interval_steps=100, eval_interval_steps=100,
        log_interval_steps=100, num_workers=0)
    root = _write_corpus(str(tmp_path / "dump"), 2, "global", T=513,
                         same=True)
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
    assert not torch.equal(first.state.params_g["codebook.embedding"],
                           want["codebook.embedding"])


@pytest.mark.parametrize("name, yaml_file", [
    ("VQVAE_V3_TRAIN", "conditioned_melgan_vae.v3.yaml"),
    ("VQVAE_LOCAL_V3_TRAIN", "local_conditioned_melgan_vae.v3.yaml")])
def test_smoke_vq_configs_are_the_yaml(name, yaml_file):
    """chip_smoke trains the VCTK recipes at full width (the GPU machine
    has no yaml): every key says what the file says but the data format
    of a seeded npy corpus and the restart the script turns on; every
    recipe key of the file is there; what the script cuts is named
    apart."""
    import yaml

    import chip_smoke

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "egs/vctk/vq1/conf", yaml_file)) as f:
        want = yaml.safe_load(f)
    got = getattr(chip_smoke, name)
    cuts = dict(chip_smoke.VQVAE_V3_TRAIN_CUT)
    if name == "VQVAE_V3_TRAIN":  # its windows at hop 64: 8,192 samples
        cuts.update(chip_smoke.VQVAE_V3_HOP_CUT)
    for key, value in got.items():
        if key != "format":
            assert want[key] == value, key
    recipe = [k for k in want if k.startswith((
        "generator_", "discriminator_", "lambda_", "use_", "stft_",
        "batch_", "sampling_", "hop_"))]
    assert not set(recipe) - set(got) - set(cuts)
    assert not set(cuts) & set(got)
    assert set(cuts) - {"vq_dead_code_restart"} <= set(want)
    assert cuts["vq_dead_code_restart"] is True


def test_the_global_recipes_hop_cuts_a_window_neither_step_takes():
    """conditioned_melgan_vae.v3.yaml sets hop_size 300: the collater cuts
    batch_max_steps 8,192 to 8,100 samples, which the encoder and decoder
    return as a whole number of codes (8,128 samples at the recipe's 64x,
    8,112 at this small recipe's 16x), and the STFT loss fails on the two
    lengths in the JAX step as in the port's (chip_smoke trains it at hop
    64)."""
    config = small_vqvae_train_config("global", hop_size=300,
                                      batch_max_steps=8192)
    state, gen, dis, opt_g, opt_d = jax_init_train_state(
        config, jax.random.key(0))
    factory, _ = jax_build_steps(config, gen, dis,
                                 jax_build_criterion(config), opt_g, opt_d)
    batch = jax_example_batch(config)
    assert batch["y"].shape == (2, 8100, 1)
    with pytest.raises(TypeError, match="incompatible shapes"):
        factory(True, False, False)(state, as_jax(batch), jax.random.key(0))
    t_state, t_gen, t_dis, t_opt_g, t_opt_d = init_train_state(
        config, 0, device="cpu")
    t_factory, _ = build_steps(config, t_gen, t_dis, build_criterion(config),
                               t_opt_g, t_opt_d)
    with pytest.raises(RuntimeError, match="size"):
        t_factory(True, False, False)(t_state, as_torch(batch))
    assert t_state.generator(torch.from_numpy(batch["y"]),
                             g=torch.from_numpy(batch["g"]))[0].shape == (
        2, 8112, 1)
