"""Kaldi-style training inputs and the training CLI of the MelGAN family in
the port, on the CPU: the paired scp datasets against the JAX package's,
``bin.train`` on a wav.scp + feats.scp against the same corpus as npy
dumps, its either-or checks and refusals, ``--pretrain`` from a reference
``.pkl`` (generator and discriminator), and ``bin.decode`` of the trained
multi-band MelGAN checkpoint."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from parallelwavegan_tpu.datasets.scp_dataset import (
    AudioMelSCPDataset as JaxAudioMelSCPDataset,
    AudioSCPDataset as JaxAudioSCPDataset,
)
from parallelwavegan_tpu.models import get_model_class as jax_model_class
from parallelwavegan_torch.bin import decode as decode_cli
from parallelwavegan_torch.bin import train as train_cli
from parallelwavegan_torch.datasets.scp_dataset import (
    AudioMelSCPDataset,
    AudioSCPDataset,
)
from parallelwavegan_torch.engine.build import init_train_state
from parallelwavegan_torch.engine.trainer import Trainer
from parallelwavegan_torch.utils.io import read_wav, write_wav
from parallelwavegan_torch.utils.params import convert_jax_params, nested
from parallelwavegan_torch.utils.torch_export import save_reference_checkpoint
from tests.test_torch_reference_pkl import _melgan_msd_name, reference_state_dict
from tests.torch_helpers import melgan_perturbed, small_melgan_train_config

torch.set_num_threads(2)

HOP, MELS, SR = 64, 16, 16000


def _write_corpus(root, n_utts=6, seed=0):
    """The same utterances twice: wav files with a wav.scp and npy feats
    with a feats.scp, and npy dumps (the wave read back from its wav, so
    both routes see the same samples). Returns (wav.scp, feats.scp,
    dump directory)."""
    rng = np.random.default_rng(seed)
    wavs, dump = os.path.join(root, "wavs"), os.path.join(root, "dump")
    os.makedirs(wavs)
    os.makedirs(dump)
    wav_lines, feats_lines = [], []
    for i in range(n_utts):
        frames = 20 + 4 * i
        t = np.arange(frames * HOP) / SR
        wave = 0.3 * np.sin(2 * np.pi * 200 * (i + 1) * t) \
            + 0.01 * rng.standard_normal(t.shape)
        utt = f"utt{i}"
        write_wav(os.path.join(wavs, f"{utt}.wav"), wave, SR)
        wave, _ = read_wav(os.path.join(wavs, f"{utt}.wav"))
        feats = rng.standard_normal((frames, MELS)).astype(np.float32)
        np.save(os.path.join(dump, f"{utt}-wave.npy"), wave)
        np.save(os.path.join(dump, f"{utt}-feats.npy"), feats)
        wav_lines.append(f"{utt} {os.path.join(wavs, utt + '.wav')}")
        feats_lines.append(f"{utt} {os.path.join(dump, utt + '-feats.npy')}")
    wav_scp = os.path.join(root, "wav.scp")
    feats_scp = os.path.join(root, "feats.scp")
    with open(wav_scp, "w") as f:
        f.write("\n".join(wav_lines) + "\n")
    with open(feats_scp, "w") as f:
        f.write("\n".join(feats_lines) + "\n")
    return wav_scp, feats_scp, dump


def _assert_items_equal(got, want):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_items_equal(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_scp_datasets_match_jax(tmp_path):
    """AudioMelSCPDataset and AudioSCPDataset give the JAX package's items
    (ids, waves, mels, rates, in order) with thresholds, segments, the
    item options and the cache."""
    wav_scp, feats_scp, _ = _write_corpus(str(tmp_path))
    for kw in (dict(), dict(mel_length_threshold=27),
               dict(audio_length_threshold=24 * HOP, return_utt_id=True,
                    return_sampling_rate=True, allow_cache=True)):
        got = AudioMelSCPDataset(wav_scp, feats_scp, **kw)
        want = JaxAudioMelSCPDataset(wav_scp, feats_scp, **kw)
        assert got.utt_ids == want.utt_ids and len(got) == len(want)
        for i in range(len(want)):
            _assert_items_equal(got[i], want[i])
        if kw.get("allow_cache"):
            assert got[0] is got[0]
    assert len(AudioMelSCPDataset(wav_scp, feats_scp,
                                  mel_length_threshold=27)) == 4
    segments = str(tmp_path / "segments")
    with open(segments, "w") as f:
        f.write("a utt3 0.01 0.05\nb utt4 0.02 0.08\n")
    for kw in (dict(segments=segments), dict(
            segments=segments, audio_length_threshold=700,
            return_utt_id=True, return_sampling_rate=True)):
        got, want = AudioSCPDataset(wav_scp, **kw), JaxAudioSCPDataset(
            wav_scp, **kw)
        assert got.utt_ids == want.utt_ids
        for i in range(len(want)):
            _assert_items_equal(got[i], want[i])
    assert AudioSCPDataset(wav_scp, segments=segments)[1].shape == (960,)


def _cli_config(tmp_path, kind="mb_melgan", **overrides):
    config = small_melgan_train_config(
        kind, batch_max_steps=1024, discriminator_train_start_steps=2,
        train_max_steps=4, save_interval_steps=4, eval_interval_steps=4,
        log_interval_steps=2, remove_short_samples=True, **overrides)
    path = str(tmp_path / "conf.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return config, path


@pytest.mark.parametrize("kind", ["mb_melgan", "melgan_v1", "pwg_v3"])
def test_train_cli_from_scp_matches_npy_dumps_and_decodes(tmp_path, kind):
    """bin.train on a wav.scp + feats.scp and on npy dumps of the same
    corpus, for each recipe shape: the same losses (relative 1e-6) after 4
    steps across the discriminator's start (for multi-band MelGAN the
    subband terms among them); the trainer's predictions are full-band;
    bin.decode serves the .ckpt (multi-band MelGAN through PQMF). Both runs
    take the PyTorch loader (npy dumps would take the native one by
    default, whose crops come from its own stream)."""
    wav_scp, feats_scp, dump = _write_corpus(str(tmp_path))
    config, conf = _cli_config(tmp_path, kind, use_native_loader=False)
    common = ["--config", conf, "--device", "cpu", "--seed", "3",
              "--verbose", "0"]
    scp = train_cli.main([
        "--train-wav-scp", wav_scp, "--train-feats-scp", feats_scp,
        "--dev-wav-scp", wav_scp, "--dev-feats-scp", feats_scp,
        "--outdir", str(tmp_path / "exp_scp")] + common)
    npy = train_cli.main(["--train-dumpdir", dump, "--dev-dumpdir", dump,
                          "--outdir", str(tmp_path / "exp_npy")] + common)
    assert scp.steps == npy.steps == 4
    # Parallel WaveGAN's context frames leave out utt0 (20 frames)
    assert len(scp.train_loader.dataset) == (5 if kind == "pwg_v3" else 6)
    for got, want in ((scp.last_train_loss, npy.last_train_loss),
                      (scp.last_eval_loss, npy.last_eval_loss)):
        assert sorted(got) == sorted(want)
        assert any("sub_spectral" in k for k in got) == (kind == "mb_melgan")
        for key in want:
            assert np.isfinite(want[key])
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       err_msg=key)
    with open(tmp_path / "exp_scp" / "config.yml") as f:
        written = yaml.safe_load(f)
    assert written["train_wav_scp"] == wav_scp
    assert written["version"] == train_cli.VERSION
    gen_wav, sr = read_wav(str(tmp_path / "exp_scp" / "predictions"
                               / "4steps" / "0_gen.wav"))
    assert sr == SR and gen_wav.shape == (config["batch_max_steps"],)

    out = str(tmp_path / "decoded")
    decode_cli.main([
        "--dumpdir", dump, "--checkpoint",
        str(tmp_path / "exp_scp" / "checkpoint-4steps.ckpt"),
        "--config", str(tmp_path / "exp_scp" / "config.yml"),
        "--outdir", out, "--device", "cpu", "--verbose", "0"])
    for i in range(6):
        wave, _ = read_wav(os.path.join(out, f"utt{i}_gen.wav"))
        assert wave.shape == ((20 + 4 * i) * HOP,)


@pytest.mark.parametrize("args, message", [
    ([], "--train-dumpdir or"),
    (["--train-wav-scp", "w"], "--train-dumpdir or"),
    (["--train-dumpdir", "d", "--train-wav-scp", "w",
      "--train-feats-scp", "f"], "not both"),
    (["--train-dumpdir", "d", "--dev-feats-scp", "f"], "--dev-dumpdir or"),
])
def test_train_cli_needs_one_source_per_split(args, message):
    with pytest.raises(ValueError, match=message):
        train_cli.main(args + ["--outdir", "o", "--config", "c"])


@pytest.mark.parametrize("config, message", [
    ({"generator_type": "UHiFiGANGenerator"}, "f0 and excitation"),
    ({"use_f0": True}, "for f0"),
    ({"generator_type": "VQVAE"}, "VQVAE"),
])
def test_scp_refuses_what_the_jax_cli_refuses(config, message):
    with pytest.raises(NotImplementedError, match=message):
        train_cli.build_scp_dataset(config, "wav.scp", "feats.scp")


def test_pretrain_from_a_reference_pkl_loads_both_networks(tmp_path):
    """--pretrain (Trainer.load_checkpoint with load_only_params, as
    bin.train calls it) of a reference .pkl with the generator (the port's
    exporter) and the multi-scale discriminator beside it (the reference's
    names, from a flax tree): both networks start from the file, the
    optimizers and the step from zero."""
    config, _ = _cli_config(tmp_path)
    source, _, _, _, _ = init_train_state(config, seed=9, device="cpu")
    name, kw = config["discriminator_type"], config["discriminator_params"]
    flax_d = jax_model_class(name)(**kw)
    dv = jax.tree.map(np.asarray, melgan_perturbed(flax_d.init(
        {"params": jax.random.key(2)}, jnp.zeros((1, 1024, 1)))))
    path = str(tmp_path / "checkpoint-100steps.pkl")
    save_reference_checkpoint(path, nested(source.generator.state_dict()),
                              config, steps=100)
    pkl = torch.load(path, weights_only=True)
    pkl["model"]["discriminator"] = reference_state_dict(
        dv, _melgan_msd_name(len(kw["downsample_scales"]) + 2))
    torch.save(pkl, path)
    trainer = Trainer(config, None, outdir=str(tmp_path / "exp"),
                      device="cpu")
    trainer.load_checkpoint(path, load_only_params=True)
    assert trainer.steps == 0 and trainer.state.opt_g.count == 0
    for key, p in trainer.generator.state_dict().items():
        torch.testing.assert_close(p, source.generator.state_dict()[key],
                                   rtol=0, atol=0)
    want = convert_jax_params(dv["params"], fold=False)
    got = trainer.discriminator.state_dict()
    assert sorted(got) == sorted(want)
    for key, p in got.items():
        np.testing.assert_array_equal(p.numpy(), want[key].numpy(),
                                      err_msg=key)
