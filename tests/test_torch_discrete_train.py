"""Training the discrete-symbol generators in the port against the JAX
package on the CPU: the duration batch against the JAX collater's on the
same generator, one (G, adv, D) step of each family in f32 (the duration
predictor's dropout on the port's masks, handed to flax by
``torch_helpers.FlaxMasks``; the token StyleMelGAN's noise and windows on
the port's draws, handed to the JAX module by ``torch_helpers.JaxDraws``)
and the mixed step, ``bin.train`` from npy token dumps then serving, and
what each package does with the known JAX behaviours: the mixed step's
bf16 ids, the duration recipes whose odd scale lengthens the output, and
the JAX init of a recipe without speakers.

Both states start from the port's init (``port_first_train_states``): the
JAX init compiles each parameter shape apart, and its example batch is
two columns wide, which a generator without speakers refuses."""

import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

import parallelwavegan_tpu.models.style_melgan as jax_style_melgan
from parallelwavegan_tpu.datasets.collater import Collater as JaxCollater
from parallelwavegan_torch.bin import train as train_cli
from parallelwavegan_torch.datasets.collater import Collater
from parallelwavegan_torch.engine.build import build_models, example_batch
from parallelwavegan_torch.engine.step import (
    DROPOUT_STREAM,
    SHARED_STREAM,
    step_generator,
)
from parallelwavegan_torch.utils.model_loader import load_model
from tests.torch_helpers import (
    FlaxMasks,
    JaxDraws,
    as_jax,
    as_torch,
    assert_first_moment,
    assert_losses,
    assert_params,
    port_first_train_states,
    small_hifigan_train_config,
    small_style_melgan_train_config,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 16
TRUNK = {"in_channels": 16, "channels": 32, "upsample_scales": (4, 4),
         "upsample_kernel_sizes": (8, 8), "resblock_kernel_sizes": (3,),
         "resblock_dilations": ((1, 3),), "num_embs": 300}
HIFIGAN_NAMES = ["mel_loss", "adversarial_loss", "feature_matching_loss",
                 "generator_loss", "real_loss", "fake_loss",
                 "discriminator_loss"]
FAMILIES = ("token", "duration", "f0", "style")


def _config(family, **overrides):
    """The small recipe of a family at hop 16: the token HiFi-GAN (4
    speakers added), the duration generator (no speakers, a predictor of
    2 x 16 with dropout 0.5, the duration loss), the F0 generator (no
    speakers, f0 through 8 channels) on ``small_hifigan_train_config``'s
    discriminator, losses and optimizers (its windows of 512 samples, 32
    frames), the token StyleMelGAN on ``small_style_melgan_train_config``'s
    (384 samples, 24 frames, 3 noise frames). The HiFi-GAN trunk's Adam
    takes eps 100, as ``small_uhifigan_train_config`` explains: 45 x the
    mel L1 gives the token table gradients of up to 1e2 beside entries
    within the packages' rounding of 0, and at eps 1e-3 an update is then
    lr * sign(g)."""
    if family == "style":
        config = small_style_melgan_train_config(
            generator_type="DiscreteSymbolStyleMelGANGenerator")
        config["generator_params"] = dict(
            config["generator_params"], num_embs=300, num_spk_embs=4,
            spk_emb_dim=16)
        config.pop("num_mels")
    else:
        gp = {"token": dict(TRUNK, num_spk_embs=4, spk_emb_dim=16),
              "duration": dict(TRUNK, num_spk_embs=0, duration_chans=16),
              "f0": dict(TRUNK, num_spk_embs=0, linear_channel=8)}[family]
        gen_type = {"token": "DiscreteSymbolHiFiGANGenerator",
                    "duration": "DiscreteSymbolDurationGenerator",
                    "f0": "DiscreteSymbolF0Generator"}[family]
        config = small_hifigan_train_config(
            generator_type=gen_type, generator_params=gp, hop_size=HOP,
            batch_size=2, use_duration_loss=family == "duration",
            use_f0=family == "f0")
        del config["num_mels"]
        config["generator_optimizer_params"] = dict(
            config["generator_optimizer_params"], eps=100.0)
    config.update(overrides)
    return config


def _items(config, n, seed, max_id=257):
    """n utterances 8 frames longer than a window: (audio, ids (frames, 1|2)
    in runs of 1 to 4 frames (a speaker column where the generator has
    speakers)[, f0 (frames,)])."""
    rng = np.random.default_rng(seed)
    gp = config["generator_params"]
    frames = config["batch_max_steps"] // HOP + 8
    out = []
    for i in range(n):
        runs = rng.integers(1, 5, frames)
        ids = np.repeat(rng.integers(0, max_id, frames), runs)[:frames]
        c = ids[:, None]
        if gp.get("num_spk_embs", 128) > 0:
            c = np.concatenate([c, np.full_like(c, i % 4)], axis=1)
        t = np.arange(frames * HOP) / config["sampling_rate"]
        audio = (0.3 * np.sin(2 * np.pi * (300 + 150 * i) * t)
                 + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
        item = (audio, c.astype(np.int64))
        if config.get("use_f0"):
            item += (np.abs(200 + 50 * rng.standard_normal(frames)).astype(
                np.float32),)
        out.append(item)
    return out


def _collater(config, seed, cls=Collater):
    return cls(batch_max_steps=config["batch_max_steps"], hop_size=HOP,
               aux_context_window=0,
               use_duration="Duration" in config["generator_type"],
               use_f0=bool(config.get("use_f0")),
               rng=np.random.default_rng(seed))


def _batch(config, seed=1, max_id=257):
    return _collater(config, seed)(_items(config, config["batch_size"], seed,
                                          max_id))


def test_duration_batch_matches_the_jax_collater():
    """Runs of equal ids and their lengths over each random window, both
    zero-padded to the longest: equal to the JAX collater's on the same
    generator; each row's durations sum to the window's frames."""
    config = _config("duration")
    items = _items(config, 3, 2) + [(
        np.zeros(40 * HOP, np.float32), np.arange(40))]  # 1-D ids
    got = Collater(batch_max_steps=512, hop_size=HOP, aux_context_window=0,
                   use_duration=True, rng=np.random.default_rng(5))(items)
    want = JaxCollater(batch_max_steps=512, hop_size=HOP,
                       aux_context_window=0, use_duration=True,
                       rng=np.random.default_rng(5))(items)
    assert sorted(got) == sorted(want) == ["c", "ds", "y"]
    for key in got:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (got["ds"].sum(axis=1) == 32).all()
    assert got["c"].shape[-1] == 1 and got["c"].dtype == np.int32
    runs = (got["ds"] > 0).sum(axis=1)
    assert got["c"].shape[1] == runs.max() == 32  # the arange row
    for row, n in zip(got["c"], runs):
        assert (row[n:] == 0).all()


def _dropout_masks(t_state, batch, n_forwards):
    """The masks the port's step draws from step_generator(0, 0,
    DROPOUT_STREAM): the generator update's forward, then the recompute."""
    g = step_generator(0, 0, DROPOUT_STREAM)
    b = as_torch(batch)
    return [m for _ in range(n_forwards)
            for m in t_state.generator.batch_dropout_masks(b, g)]


def _style_draws(t_state, batch):
    """The token StyleMelGAN step's draws of step_generator(0, 0): the
    noise, the fake pass's windows; the recompute's noise, the real and
    the fake pass's windows."""
    g = step_generator(0, 0)
    B, frames = batch["c"].shape[:2]
    normals, ints = [], []
    for p in "zwzww":
        if p == "z":
            normals.append(t_state.generator.draw_noise(B, frames, g).numpy())
        else:
            ints += t_state.discriminator.draw_window_starts(
                batch["y"].shape[1], g)
    return JaxDraws(normals, ints)


def _names(family):
    if family == "style":
        return ["spectral_convergence_loss", "log_stft_magnitude_loss",
                "generator_loss", "adversarial_loss", "real_loss",
                "fake_loss", "discriminator_loss"]
    return HIFIGAN_NAMES + (["duration_loss"] if family == "duration"
                            else [])


def _both_steps(monkeypatch, config, batch):
    """(port metrics, JAX metrics, port state, JAX state) after one (G,
    adv, D) step on the same parameters, batch and draws."""
    family = next(f for f in FAMILIES if f in _family_key(config))
    state, (factory, _), t_state, (t_factory, _) = port_first_train_states(
        config, unit_g=True)
    if family == "duration":
        stand_in = FlaxMasks([m.numpy() for m in _dropout_masks(
            t_state, batch, 2)])
        monkeypatch.setattr("flax.linen.stochastic.random", stand_in)
    if family == "style":
        stand_in = _style_draws(t_state, batch)
        monkeypatch.setattr(jax_style_melgan, "jax", stand_in)
    new_state, ref = factory.__wrapped__(True, True, True)(
        state, as_jax(batch), jax.random.key(0))
    if family == "duration":
        assert not stand_in.masks  # every mask taken, in order
    if family == "style":
        assert not stand_in.random.normals and not stand_in.random.ints
    _, metrics = t_factory(True, True, True)(
        t_state, as_torch(batch), step_generator(0, 0),
        step_generator(0, 0, SHARED_STREAM),
        step_generator(0, 0, DROPOUT_STREAM))
    return metrics, ref, t_state, new_state


def _family_key(config):
    t = config["generator_type"]
    return {"DiscreteSymbolHiFiGANGenerator": "token",
            "DiscreteSymbolDurationGenerator": "duration",
            "DiscreteSymbolF0Generator": "f0",
            "DiscreteSymbolStyleMelGANGenerator": "style"}[t]


@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_matches_jax(family, monkeypatch):
    """One (G, adv, D) step of each family on the collater's batch (ids in
    runs, below 257) and the same draws: losses (the duration loss
    included) to 2e-5 relative, the updated parameters to 1e-5 absolute
    (the token tables and the duration predictor among them), the
    gradients through Adam's first moments."""
    config = _config(family)
    batch = _batch(config)
    metrics, ref, t_state, new_state = _both_steps(monkeypatch, config, batch)
    assert_losses(metrics, ref, _names(family), rtol=2e-5)
    assert_params(t_state.generator, new_state.params_g, 1e-5, "G")
    assert_params(t_state.discriminator, new_state.params_d, 1e-5, "D")
    assert_first_moment(t_state.opt_g, new_state.opt_g, "G", floor=1e-4)
    assert_first_moment(t_state.opt_d, new_state.opt_d, "D", floor=1e-4)
    if family == "duration":
        assert float(metrics["duration_loss"]) > 0


@pytest.mark.parametrize("family", FAMILIES)
def test_mixed_precision_step_matches_jax(family, monkeypatch):
    """mixed_precision of each family (the duration predictor's dropout
    on) on ids <= 256, which bf16 holds exactly (the JAX
    step casts float ids to bf16; above 256 they part, see
    test_mixed_step_reads_ids_above_256_as_jax_cannot): losses to bf16
    accuracy (5e-2 relative), master parameters float32 and finite."""
    config = _config(family, mixed_precision=True)
    batch = _batch(config, max_id=257)
    assert batch["c"].max() <= 256
    metrics, ref, t_state, _ = _both_steps(monkeypatch, config, batch)
    assert_losses(metrics, ref, _names(family), rtol=5e-2)
    for key, p in t_state.params_g.items():
        assert p.dtype == torch.float32 and torch.isfinite(p).all(), key


def test_mixed_step_reads_ids_above_256_as_jax_cannot():
    """The collater gives a token batch float32 ids; the JAX mixed step
    casts them to bf16, where 257 reads as 256; the port's step turns them
    to int64 first: its generator loss (the eval step's) on a batch of
    257s differs from that on 256s, the JAX step's is the same."""
    config = _config("token", mixed_precision=True)
    state, (_, eval_step), t_state, (_, t_eval_step) = \
        port_first_train_states(config)
    batch = _batch(config)
    table = t_state.generator.emb.embedding
    with torch.no_grad():
        table[256], table[257] = 3.0, -3.0  # rows that tell them apart
    params_g = dict(state.params_g, emb={"embedding": jax.numpy.asarray(
        table.detach().numpy())})
    state = state.replace(params_g=params_g)
    losses = {}
    for ident in (256, 257):
        b = dict(batch, c=np.where(np.arange(2) == 0, ident,
                                   batch["c"]).astype(np.float32))
        ref = eval_step(state, as_jax(b), jax.random.key(0), False)
        metrics = t_eval_step(t_state, as_torch(b), False)
        losses[ident] = (float(ref["generator_loss"]),
                         float(metrics["generator_loss"]))
    assert losses[256][0] == losses[257][0]
    assert abs(losses[256][1] - losses[257][1]) > 1e-3 * losses[256][1]


DURATION_RECIPES = ("egs/vctk/hubert_voc1/conf/hifigan_hubert_duration.v1.yaml",
                    "egs/cvss_c/hubert_voc1/conf/"
                    "hifigan_hubert_duration.v1.yaml")


def test_duration_recipes_odd_scale_lengthens_what_neither_step_takes(
        monkeypatch):
    """upsample_scales [5, 4, 4, 4] with kernels [10, 8, 8, 8] pad by
    (k - s) // 2 = 2 at the scale 5 with no output padding: T tokens give
    320 T + 64 samples, not T x 320, in both packages (the recipe's scales
    at 16 channels). In training the regulated length is batch_max_steps
    // hop frames, so y_hat is 64 samples longer than y: on a window of 4
    frames the JAX step fails on the two lengths, and so does the port's
    (chip_smoke trains the opencpop recipe, whose scales give T x 320)."""
    recipes = []
    for path in DURATION_RECIPES:  # the VCTK and the CVSS-C recipe
        with open(os.path.join(REPO, path)) as f:
            recipes.append(yaml.safe_load(f))
    recipe = recipes[0]
    gp = recipe["generator_params"]
    for r in recipes:
        assert r["generator_params"]["upsample_scales"] == [5, 4, 4, 4]
        assert r["generator_params"]["upsample_kernel_sizes"] == gp[
            "upsample_kernel_sizes"] and r["hop_size"] == 320
    small = dict(_config("duration"), **{
        k: recipe[k] for k in ("hop_size", "mel_loss_params",
                               "generator_type", "use_duration_loss")})
    small["generator_params"] = dict(
        gp, channels=16, in_channels=8, num_embs=20, duration_chans=8,
        resblock_kernel_sizes=[3], resblock_dilations=[[1]])
    small["batch_max_steps"] = 1280
    gen, _ = build_models(small)
    c = torch.randint(0, 20, (1, 4, 1))
    with torch.no_grad():
        y, _ = gen(c, torch.ones((1, 4), dtype=torch.int64))
    assert y.shape == (1, 4 * 320 + 64, 1)
    state, (factory, _), t_state, (t_factory, _) = port_first_train_states(
        small)
    rng = np.random.default_rng(0)
    batch = {"y": rng.standard_normal((2, 1280, 1)).astype(np.float32),
             "c": rng.integers(0, 20, (2, 3, 1)).astype(np.int32),
             "ds": np.array([[1, 2, 1], [2, 2, 0]], np.int32)}
    y_jax, _ = jax.eval_shape(lambda v, b: _flax_forward(small, v, b),
                              state.params_g, as_jax(batch))
    assert y_jax.shape == (2, 4 * 320 + 64, 1)
    monkeypatch.setattr("flax.linen.stochastic.random", FlaxMasks(
        [m.numpy() for m in _dropout_masks(t_state, batch, 2)]))
    with pytest.raises(TypeError, match="incompatible shapes"):
        factory(True, True, True)(state, as_jax(batch), jax.random.key(0))
    with pytest.raises(RuntimeError, match="size"):
        t_factory(True, True, True)(
            t_state, as_torch(batch),
            dropout_rng=step_generator(0, 0, DROPOUT_STREAM))


def _flax_forward(config, params, batch):
    """The JAX duration generator's forward on ``batch`` (deterministic)."""
    from parallelwavegan_tpu.engine.build import (
        build_models as jax_build_models,
    )

    gen, _ = jax_build_models(config)
    return gen.apply({"params": params}, batch["c"], batch["ds"], True)


def test_jax_init_of_a_recipe_without_speakers_fails_and_the_ports_builds():
    """The JAX example batch is (B, frames, 2) for every discrete generator
    and returns before the F0 generator's f0, so its init_train_state
    fails the one-column assert of a generator without speakers (the
    duration and F0 recipes); the port's example batch follows
    num_spk_embs and carries the f0, and its init builds."""
    from parallelwavegan_tpu.engine.build import (
        init_train_state as jax_init_train_state,
    )
    from parallelwavegan_torch.engine.build import init_train_state

    for family in ("duration", "f0"):
        config = _config(family)
        with pytest.raises(AssertionError):
            jax_init_train_state(config, jax.random.key(0))
        batch = example_batch(config)
        assert batch["c"].shape == (2, 32, 1) and batch["c"].dtype == np.int32
        assert ("ds" in batch) == (family == "duration")
        assert ("f0" in batch) == (family == "f0")
        state, gen, *_ = init_train_state(config, device="cpu")
        if family == "duration":
            assert gen.max_reg_len == 32  # batch_max_steps // hop
        else:
            assert gen.f0_embedding.kernel.shape == (1, 8)


def _write_corpus(root, config, n, seed):
    """npy dumps: -wave.npy, -feats.npy of ids (frames, 1|2) in runs."""
    os.makedirs(root, exist_ok=True)
    for i, item in enumerate(_items(config, n, seed)):
        np.save(os.path.join(root, f"utt{i}-wave.npy"), item[0])
        np.save(os.path.join(root, f"utt{i}-feats.npy"), item[1])
        if len(item) > 2:
            np.save(os.path.join(root, f"utt{i}-f0.npy"), item[2])
    return root


@pytest.mark.parametrize("family", ["duration", "f0"])
def test_train_cli_from_npy_dumps_then_serve(tmp_path, family):
    """bin.train.main --device cpu on npy token dumps (the F0 generator
    reads -f0.npy by default): three steps (D from step 0, G from step 1),
    finite losses under every name (duration_loss for the duration
    generator), one evaluation; then load_model on the .ckpt serves an
    utterance: the duration generator at its config's max_reg_len (the
    pin is training's), its wave sum(predicted ds) x hop long."""
    config = _config(family, train_max_steps=3, save_interval_steps=3,
                     eval_interval_steps=3, log_interval_steps=3,
                     num_workers=0)
    root = _write_corpus(str(tmp_path / "dump"), config, 4, 3)
    conf = str(tmp_path / "conf.yaml")
    with open(conf, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(config)), f)
    trainer = train_cli.main([
        "--train-dumpdir", root, "--dev-dumpdir", root, "--outdir",
        str(tmp_path / "exp"), "--config", conf, "--device", "cpu",
        "--verbose", "0"])
    assert trainer.steps == 3 and trainer.state.opt_g.count == 1
    names = _names(family)
    assert sorted(trainer.last_train_loss) == sorted(
        f"train/{n}" for n in names)
    assert all(np.isfinite(v) for v in trainer.last_train_loss.values())
    assert sorted(trainer.last_eval_loss) == sorted(
        f"eval/{n}" for n in names)
    serve = config if family == "f0" else dict(config, generator_params=dict(
        config["generator_params"], max_reg_len=64))
    model = load_model(str(tmp_path / "exp/checkpoint-3steps.ckpt"), serve,
                       device="cpu")
    c = np.load(os.path.join(root, "utt0-feats.npy"))
    f0 = np.load(os.path.join(root, "utt0-f0.npy")) if family == "f0" \
        else None
    y = model.inference(c, f0=f0)
    assert np.isfinite(y).all()
    if family == "duration":
        ds = np.clip(np.round(np.exp(model.predicted_log_durations(c)) - 1),
                     0, None)
        assert y.shape == (min(int(ds.sum()), 64) * HOP, 1)
    else:
        assert y.shape == (len(c) * HOP, 1)
