"""UHiFiGAN training in the port against the JAX package on the CPU: the
G, G+adv+D and D steps and the mixed-precision step on
``torch_helpers.small_uhifigan_train_config`` with the dropout masks of
the port handed to flax (``torch_helpers.FlaxMasks``), several steps and
the deterministic eval step, the example batch, the step's dropout source,
``bin.train`` from ``-wave/-feats/-f0/-excitation.npy`` dumps then
``bin.decode`` and serving, a resumed run against an unbroken one, and
``--use-f0`` for the other families.

Both states start from the port's init (``port_first_train_states``): the
JAX package's init compiles each of the U-Net's parameter shapes apart."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from parallelwavegan_tpu.engine.build import example_batch as jax_example
from parallelwavegan_torch.bin import decode as decode_cli
from parallelwavegan_torch.bin import train as train_cli
from parallelwavegan_torch.engine.build import example_batch
from parallelwavegan_torch.engine.step import DROPOUT_STREAM, step_generator
from parallelwavegan_torch.ops.sine import sine_excitation
from parallelwavegan_torch.utils.model_loader import load_model
from tests.torch_helpers import (
    FlaxMasks,
    as_jax,
    as_torch,
    assert_first_moment,
    assert_losses,
    assert_params,
    port_first_train_states,
    sine_batch,
    small_hifigan_train_config,
    small_uhifigan_train_config,
)

torch.set_num_threads(2)

G_NAMES = ["spectral_convergence_loss", "log_stft_magnitude_loss",
           "mel_loss", "generator_loss"]
ADV_NAMES = ["adversarial_loss", "feature_matching_loss"]
D_NAMES = ["real_loss", "fake_loss", "discriminator_loss"]


def _names(train_g, use_adv, train_d):
    return ((G_NAMES if train_g else []) + (ADV_NAMES if use_adv else [])
            + (D_NAMES if train_d else []))


def _batch(config, seed=1):
    """sine_batch with a sine excitation of a voiced f0 in place of the
    example batch's noise."""
    batch = sine_batch(config, seed)
    B, T, _ = batch["excitation"].shape
    f0 = np.repeat(150.0 + 50.0 * np.arange(B)[:, None], T, axis=1)
    batch["excitation"] = sine_excitation(
        torch.from_numpy(f0[..., None]).float(), config["sampling_rate"],
        generator=torch.Generator().manual_seed(seed))[0].numpy()
    return batch


def _masks(t_state, batch, n_forwards, seed=0, steps=0):
    """The keep masks the port's step draws from its dropout stream for
    ``n_forwards`` forwards (the generator update's, then the
    discriminator update's recompute)."""
    B, T, _ = batch["excitation"].shape
    g = step_generator(seed, steps, DROPOUT_STREAM)
    return [m for _ in range(n_forwards)
            for m in t_state.generator.draw_dropout_masks(B, T, g)]


def _hand_masks(monkeypatch, masks):
    stand_in = FlaxMasks([m.numpy() for m in masks])
    monkeypatch.setattr("flax.linen.stochastic.random", stand_in)
    return stand_in


@pytest.mark.parametrize("flags", [(True, False, False), (True, True, True),
                                   (False, False, True)],
                         ids=["g_only", "g_adv_d", "d_only"])
def test_uhifigan_train_step_matches_jax(flags, monkeypatch):
    """One step on the same parameters, batch and dropout masks (the
    port's, drawn from ``step_generator(0, 0, DROPOUT_STREAM)``: the
    generator update's forward, then the discriminator update's recompute,
    each dropout-on as in the JAX step). Losses to 2e-5 relative; the
    gradients through Adam's first moments, 1e-3 of each one's largest
    entry plus 1e-4 of the network's largest (as for HiFi-GAN: L1s of logs
    of small energies); the updated parameters to 1e-5 absolute (the
    generator's Adam at eps 100, ``small_uhifigan_train_config``)."""
    config = small_uhifigan_train_config()
    state, (factory, _), t_state, (t_factory, _) = port_first_train_states(
        config)
    batch = _batch(config)
    train_g, use_adv, train_d = flags
    stand_in = _hand_masks(monkeypatch, _masks(t_state, batch,
                                               train_g + train_d))
    new_state, ref = factory(*flags)(state, as_jax(batch), jax.random.key(0))
    assert not stand_in.masks  # every mask taken, in order
    _, metrics = t_factory(*flags)(
        t_state, as_torch(batch),
        dropout_rng=step_generator(0, 0, DROPOUT_STREAM))
    assert_losses(metrics, ref, _names(*flags), rtol=2e-5)
    assert t_state.steps == int(new_state.steps) == 1
    assert_params(t_state.generator, new_state.params_g, 1e-5, "G")
    assert_params(t_state.discriminator, new_state.params_d, 1e-5, "D")
    if train_g:
        assert_first_moment(t_state.opt_g, new_state.opt_g, "G", floor=1e-4)
    if train_d:
        assert_first_moment(t_state.opt_d, new_state.opt_d, "D", floor=1e-4)


def test_uhifigan_mixed_precision_step_matches_jax(monkeypatch):
    """mixed_precision: bf16 copies of the parameters and of the batch (c,
    f0 and the excitation too, as the JAX step's ``_half``) on the same
    masks; losses to bf16 accuracy (5e-2 relative), master parameters,
    their moments and the metrics float32 and finite, every parameter
    moved (Adam's eps back at 1e-3: the parameters are not compared, and
    each then moves by about the rate)."""
    config = small_uhifigan_train_config(mixed_precision=True)
    config["generator_optimizer_params"]["eps"] = 1e-3
    state, (factory, _), t_state, (t_factory, _) = port_first_train_states(
        config)
    batch = _batch(config)
    _hand_masks(monkeypatch, _masks(t_state, batch, 2))
    before = {k: v.detach().clone() for k, v in t_state.params_g.items()}
    _, ref = factory(True, True, True)(state, as_jax(batch),
                                       jax.random.key(0))
    _, metrics = t_factory(True, True, True)(
        t_state, as_torch(batch),
        dropout_rng=step_generator(0, 0, DROPOUT_STREAM))
    assert_losses(metrics, ref, _names(True, True, True), rtol=5e-2)
    assert all(m.dtype == torch.float32 for m in metrics.values())
    for key, p in t_state.params_g.items():
        assert p.dtype == torch.float32 and torch.isfinite(p).all(), key
        assert not torch.equal(p, before[key]), key
    for leaf in jax.tree.leaves(t_state.opt_g.state_dict()):
        assert leaf.dtype in (torch.float32, torch.int32)


def test_several_steps_and_the_eval_step_match_jax(monkeypatch):
    """Three G+adv+D steps on new batches (the JAX step, traced once, keeps
    the masks it was traced with: the port is handed the same dropout
    stream at each step), then eval_step with and without the adversarial
    terms, deterministic in both packages (no masks drawn): losses 1e-4
    relative, parameters 2e-5 after the updates compound."""
    config = small_uhifigan_train_config()
    state, (factory, eval_step), t_state, (t_factory, t_eval) = \
        port_first_train_states(config)
    batch = _batch(config)
    stand_in = _hand_masks(monkeypatch, _masks(t_state, batch, 2))
    step, t_step = factory(True, True, True), t_factory(True, True, True)
    for i in range(3):
        batch = _batch(config, seed=10 + i)
        state, ref = step(state, as_jax(batch), jax.random.key(0))
        _, metrics = t_step(t_state, as_torch(batch),
                            dropout_rng=step_generator(0, 0, DROPOUT_STREAM))
        assert_losses(metrics, ref, _names(True, True, True), rtol=1e-4)
    assert not stand_in.masks
    assert_params(t_state.generator, state.params_g, 2e-5, "G")
    batch = _batch(config, seed=20)
    for use_adv in (True, False):
        ref = eval_step(state, as_jax(batch), jax.random.key(0), use_adv)
        metrics = t_eval(t_state, as_torch(batch), use_adv)
        assert_losses(metrics, ref, _names(True, use_adv, use_adv), rtol=1e-4)


def test_the_step_draws_its_masks_from_the_dropout_source():
    """A training step without ``dropout_rng`` raises; the same source
    gives the same step, another seed another one; the eval step needs
    none. ``step_generator`` on a device seeds a generator there from the
    same (seed, steps, stream)."""
    config = small_uhifigan_train_config()
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.engine.criterion import build_criterion
    from parallelwavegan_torch.engine.step import build_steps

    outs = []
    batch = as_torch(_batch(config))
    for seed in (0, 0, 1):
        t_state, gen, dis, opt_g, opt_d = init_train_state(config, 0, "cpu")
        factory, t_eval = build_steps(config, gen, dis,
                                      build_criterion(config), opt_g, opt_d)
        step = factory(True, False, False)
        with pytest.raises(ValueError, match="dropout_rng"):
            step(t_state, batch)
        t_eval(t_state, batch, True)
        _, metrics = step(t_state, batch, dropout_rng=step_generator(
            seed, 0, DROPOUT_STREAM))
        outs.append(float(metrics["generator_loss"]))
    assert outs[0] == outs[1] != outs[2]
    g = step_generator(5, 2, DROPOUT_STREAM, device="cpu")
    assert g.device.type == "cpu"
    assert torch.equal(torch.rand(4, generator=g), torch.rand(
        4, generator=step_generator(5, 2, DROPOUT_STREAM)))


def test_example_batch_matches_jax():
    """UHiFiGAN's example batch: y, c, then the excitation (B, T, 1) and
    f0 (B, T', 1) drawn after c as in the JAX package."""
    config = small_uhifigan_train_config()
    got, want = example_batch(config), jax_example(config)
    assert sorted(got) == sorted(want) == ["c", "excitation", "f0", "y"]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _write_corpus(root, config, n, rng, same_frames=None):
    """npy dumps: -wave, -feats, -f0 (frames,) and -excitation (frames,
    hop), the excitation a sine excitation of the f0 contour; with
    ``same_frames``, n copies of one utterance of that many frames."""
    hop, mels = config["hop_size"], config["num_mels"]
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        frames = same_frames or 40 + 6 * i
        if same_frames:
            rng = np.random.default_rng(0)
        f0 = np.where(rng.random(frames) < 0.8,
                      120 + 200 * rng.random(frames), 0.0).astype(np.float32)
        exc = sine_excitation(
            torch.from_numpy(np.repeat(f0, hop)[None, :, None]),
            config["sampling_rate"], generator=torch.Generator().manual_seed(
                0 if same_frames else i))[0][0, :, 0].numpy()
        t = np.arange(frames * hop)
        k = 1 if same_frames else i + 1
        np.save(os.path.join(root, f"utt{i}-wave.npy"),
                (0.3 * np.sin(0.03 * k * t)).astype(np.float32))
        np.save(os.path.join(root, f"utt{i}-feats.npy"),
                rng.standard_normal((frames, mels)).astype(np.float32))
        np.save(os.path.join(root, f"utt{i}-f0.npy"), f0)
        np.save(os.path.join(root, f"utt{i}-excitation.npy"),
                exc.reshape(frames, hop))
    return root


def test_train_cli_from_npy_dumps_then_decode(tmp_path):
    """bin.train.main --device cpu on -wave/-feats/-f0/-excitation.npy
    dumps: three steps (the discriminator from step 0, the generator from
    step 1), finite losses under every name, one evaluation; then
    bin.decode on the .ckpt (waves of frames x hop samples) equal to
    load_model's inference on the same dumps."""
    import yaml
    from scipy.io import wavfile

    config = small_uhifigan_train_config(
        train_max_steps=3, save_interval_steps=3, eval_interval_steps=3,
        log_interval_steps=3, num_workers=0)
    root = _write_corpus(str(tmp_path / "dump"), config, 4,
                         np.random.default_rng(0))
    conf = str(tmp_path / "conf.yaml")
    with open(conf, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(config)), f)
    outdir = str(tmp_path / "exp")
    trainer = train_cli.main([
        "--train-dumpdir", root, "--dev-dumpdir", root, "--outdir", outdir,
        "--config", conf, "--device", "cpu", "--verbose", "0"])
    assert trainer.steps == 3
    # strict gates (steps > start): D at steps 1 and 2, G at step 2
    assert trainer.state.opt_d.count == 2 and trainer.state.opt_g.count == 1
    names = _names(True, True, True)
    assert sorted(trainer.last_train_loss) == sorted(
        f"train/{n}" for n in names)
    assert all(np.isfinite(v) for v in trainer.last_train_loss.values())
    assert sorted(trainer.last_eval_loss) == sorted(
        f"eval/{n}" for n in names)
    batch = next(iter(trainer.train_loader))
    assert batch["excitation"].shape == (2, 512, 1)
    assert batch["f0"].shape == (2, 32, 1)
    path = os.path.join(outdir, "checkpoint-3steps.ckpt")
    out = tmp_path / "out"
    decode_cli.main(["--dumpdir", root, "--checkpoint", path, "--outdir",
                     str(out), "--device", "cpu"])
    model = load_model(path, device="cpu")
    assert model.upsample_factor == 16
    for i in range(4):
        frames = 40 + 6 * i
        sr, wave = wavfile.read(out / f"utt{i}_gen.wav")
        assert sr == 16000 and wave.shape == (frames * 16,)
        y = model.inference(
            np.load(os.path.join(root, f"utt{i}-feats.npy")),
            f0=np.load(os.path.join(root, f"utt{i}-f0.npy")),
            excitation=np.load(os.path.join(root, f"utt{i}-excitation.npy")))
        want = (np.clip(y[:, 0], -1, 1) * 32767).astype(np.int16)
        assert np.abs(wave.astype(np.int32) - want).max() <= 1


def test_resumed_run_equals_an_unbroken_run(tmp_path):
    """On identical utterances one window long (so every batch is the
    same and only the dropout masks differ from step to step): three
    steps, against two steps and one more resumed from the .ckpt, end on
    equal parameters (the masks are functions of the seed and the step,
    ``DROPOUT_STREAM``)."""
    config = small_uhifigan_train_config(
        train_max_steps=3, save_interval_steps=2, eval_interval_steps=100,
        log_interval_steps=100, num_workers=0)
    root = _write_corpus(str(tmp_path / "dump"), config, 2,
                         np.random.default_rng(1), same_frames=33)
    kw = dict(seed=3, device="cpu", dump_config=False)
    whole = train_cli.run(config, root, root, str(tmp_path / "whole"), **kw)
    train_cli.run(dict(config, train_max_steps=2), root, root,
                  str(tmp_path / "first"), **kw)
    resumed = train_cli.run(
        config, root, root, str(tmp_path / "second"),
        resume=str(tmp_path / "first/checkpoint-2steps.ckpt"), **kw)
    assert resumed.steps == whole.steps == 3
    for key, p in whole.generator.state_dict().items():
        assert torch.equal(p, resumed.generator.state_dict()[key]), key


def test_use_f0_gives_the_other_families_the_f0(tmp_path, monkeypatch):
    """--use-f0 (use_f0 in the config, as the JAX CLI sets it) reads
    -f0.npy beside the waves through AudioMelF0Dataset and puts the f0 of
    the frame window in the batch; HiFi-GAN's step runs on that batch and
    its generator does not read it; bin.decode --use-f0 reads the f0 beside
    each mel and decodes one utterance a call at its exact length, as
    ``InferenceModel.inference`` does (the bucketed path edge-pads the
    batch, which moves the last samples). Without the flag the yaml's
    use_f0 is not read, as in the JAX CLI (its config takes the flag's
    value); a Kaldi list with f0 is refused."""
    from scipy.io import wavfile

    from parallelwavegan_torch.datasets.audio_mel_dataset import (
        AudioMelDataset,
        AudioMelF0Dataset,
    )

    config = small_hifigan_train_config(
        use_f0=True, train_max_steps=3, save_interval_steps=100,
        eval_interval_steps=100, log_interval_steps=100, num_workers=0,
        batch_max_steps=512)
    root = _write_corpus(str(tmp_path / "dump"), config, 3,
                         np.random.default_rng(2))
    dataset = train_cli.build_dataset(config, root)
    assert type(dataset) is AudioMelF0Dataset
    batch = next(iter(train_cli.build_loader(config, dataset, 0)))
    assert sorted(batch) == ["c", "f0", "y"]
    assert batch["f0"].shape == (3, 8, 1)
    trainer = train_cli.run(config, root, root, str(tmp_path / "exp"),
                            seed=0, device="cpu", dump_config=False)
    assert trainer.steps == 3 and trainer.state.opt_g.count == 1
    path = str(tmp_path / "exp/checkpoint-3steps.ckpt")
    trainer.save_checkpoint(path)
    conf = str(tmp_path / "config.json")
    with open(conf, "w") as f:
        json.dump(config, f)
    decode_cli.main(["--dumpdir", root, "--checkpoint", path, "--config",
                     conf, "--outdir", str(tmp_path / "out"), "--device",
                     "cpu", "--verbose", "0", "--use-f0"])
    model = load_model(path, config, device="cpu")
    for i in range(3):
        wave = wavfile.read(tmp_path / "out" / f"utt{i}_gen.wav")[1]
        y = model.inference(np.load(os.path.join(root, f"utt{i}-feats.npy")))
        want = (np.clip(y[:, 0], -1, 1) * 32767).astype(np.int16)
        assert wave.shape == want.shape == ((40 + 6 * i) * 64,)
        assert np.abs(wave.astype(np.int32) - want).max() <= 1
    assert type(train_cli.build_dataset(dict(config, use_f0=False), root)
                ) is AudioMelDataset
    seen = []
    monkeypatch.setattr(train_cli, "run",
                        lambda config, *args, **kw: seen.append(config))
    for flag in ([], ["--use-f0"]):
        train_cli.main(["--train-dumpdir", root, "--dev-dumpdir", root,
                        "--outdir", str(tmp_path / "x"), "--config", conf,
                        "--verbose", "0"] + flag)
    assert [c["use_f0"] for c in seen] == [False, True]
    with pytest.raises(NotImplementedError, match="f0"):
        train_cli.build_scp_dataset(config, "wav.scp", "feats.scp")
    with pytest.raises(NotImplementedError, match="excitation"):
        train_cli.build_scp_dataset(small_uhifigan_train_config(),
                                    "wav.scp", "feats.scp")


def test_the_gates_mel_loss_takes_float64s_kinks():
    """chip_smoke.kinked_mel, the mel loss of step 14's gradient gate with
    its kinks (the power clamp, the mel clamp, the L1 signs) decided once
    by the first (float64) route: the value of the mel loss on every
    route, and on f32 the mel loss's own gradient (1e-4 of its largest
    entry), a silent stretch putting bins under the power clamp (the mel
    clamp binds only where a filter sums clamped amplitudes to under
    1e-10, which these filters do not)."""
    import chip_smoke
    from parallelwavegan_torch.losses import MelSpectrogramLoss

    loss = MelSpectrogramLoss(
        **small_hifigan_train_config()["mel_loss_params"])
    rng = np.random.default_rng(5)
    t = np.arange(1024) / 16000
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(1024)
    y = 0.3 * np.sin(2 * np.pi * 445 * t) + 0.05 * rng.standard_normal(1024)
    x[600:900] = 0.0
    x, y = (torch.from_numpy(np.stack([a, a[::-1].copy()])).float()
            for a in (x, y))
    kinks = {}
    with torch.no_grad():
        chip_smoke.kinked_mel(loss, x.double(), y.double(), kinks, "mel")
    decided = kinks["mel"]
    assert len(decided) == 5 and not decided[0].all()
    got_x = x.clone().requires_grad_()
    got = chip_smoke.kinked_mel(loss, got_x, y, kinks, "mel")
    assert len(kinks["mel"]) == 5 and kinks["mel"][0] is decided[0]
    want_x = x.clone().requires_grad_()
    want = loss(want_x, y)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)
    (g,) = torch.autograd.grad(got, got_x)
    (w,) = torch.autograd.grad(want, want_x)
    np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                               atol=1e-4 * w.abs().max().item())
