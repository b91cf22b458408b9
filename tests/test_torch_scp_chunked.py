"""feats.scp input and overlap-chunked synthesis in the port against the
JAX package on the CPU: the Kaldi binary readers on files written here,
MelSCPDataset over ark, hdf5 and npy scp files, inference_chunked for
MelGAN, multi-band MelGAN and HiFi-GAN (against the JAX chunking and the
port's own whole forward) and for Parallel WaveGAN window by window on
explicit noise, the decode CLI with --feats-scp and --chunk-frames, and
its error probes."""

import os
import struct

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from parallelwavegan_tpu.datasets import MelSCPDataset as JaxMelSCPDataset
from parallelwavegan_tpu.models import get_model_class as jax_model_class
from parallelwavegan_tpu.utils import kaldiio_lite as jax_kaldi
from parallelwavegan_tpu.utils.model_loader import (
    InferenceModel as JaxInferenceModel,
)
from parallelwavegan_tpu.utils.torch_export import save_reference_checkpoint
from parallelwavegan_torch.bin.decode import main as decode_main
from parallelwavegan_torch.datasets.scp_dataset import MelSCPDataset
from parallelwavegan_torch.utils import kaldiio_lite
from parallelwavegan_torch.utils.model_loader import InferenceModel
from tests.torch_helpers import flax_generator_kwargs, melgan_perturbed

torch.set_num_threads(2)

T, CHUNK, CONTEXT = 700, 128, 48
A = 16
MELGAN = {"in_channels": A, "out_channels": 1, "channels": 32,
          "upsample_scales": [4, 4], "stacks": 2}
CONFIGS = {
    "melgan": {"generator_type": "MelGANGenerator",
               "generator_params": MELGAN},
    "mb_melgan": {"generator_type": "MelGANGenerator",
                  "generator_params": dict(MELGAN, out_channels=4)},
    "hifigan": {"generator_type": "HiFiGANGenerator",
                "generator_params": {
                    "in_channels": A, "channels": 32,
                    "upsample_scales": [4, 4],
                    "upsample_kernel_sizes": [8, 8],
                    "resblock_kernel_sizes": [3],
                    "resblock_dilations": [[1, 3]]}},
}


def write_ark(path, arrays):
    """Kaldi binary ark of float/double matrices and vectors; returns the
    scp lines "utt path:offset"."""
    lines = []
    with open(path, "wb") as f:
        for utt, a in arrays.items():
            f.write(utt.encode() + b" ")
            offset = f.tell()
            token = {(2, np.float32): b"FM ", (2, np.float64): b"DM ",
                     (1, np.float32): b"FV ", (1, np.float64): b"DV "}[
                         (a.ndim, a.dtype.type)]
            f.write(b"\x00B" + token)
            for n in a.shape:
                f.write(b"\x04" + struct.pack("<i", n))
            f.write(np.ascontiguousarray(a).tobytes())
            lines.append(f"{utt} {path}:{offset}")
    return lines


def _write_scp(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def test_kaldi_readers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {
        "fm": rng.standard_normal((7, 5)).astype(np.float32),
        "dm": rng.standard_normal((3, 4)),
        "fv": rng.standard_normal(9).astype(np.float32),
        "dv": rng.standard_normal(2),
    }
    lines = write_ark(str(tmp_path / "feats.ark"), arrays)
    scp = _write_scp(tmp_path / "feats.scp", lines)
    for line in lines:
        utt, rx = line.split()
        got = kaldiio_lite.read_kaldi_array(rx)
        want = jax_kaldi.read_kaldi_array(rx)
        assert got.dtype == want.dtype == arrays[utt].dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, arrays[utt])
    reader = kaldiio_lite.ArkScpReader(scp)
    assert reader.keys() == jax_kaldi.ArkScpReader(scp).keys() == list(arrays)
    for (utt, got), (_, want) in zip(reader, jax_kaldi.ArkScpReader(scp)):
        np.testing.assert_array_equal(got, want)
    text = tmp_path / "text.ark"
    text.write_bytes(b"utt [ 1 2 ]\n")
    with pytest.raises(ValueError, match="binary"):
        kaldiio_lite.read_kaldi_array(f"{text}:4")
    bad = tmp_path / "bad.ark"
    bad.write_bytes(b"\x00BFM \x08" + struct.pack("<i", 1))
    with pytest.raises(ValueError, match="size field"):
        kaldiio_lite.read_kaldi_array(str(bad))


@pytest.mark.parametrize("kind", ["ark", "h5", "h5_path", "npy"])
def test_mel_scp_dataset_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(1)
    mels = {f"utt{i}": rng.standard_normal((n, A)).astype(np.float32)
            for i, n in enumerate((12, 5, 9))}
    if kind == "ark":
        lines = write_ark(str(tmp_path / "feats.ark"), mels)
    else:
        lines = []
        for utt, m in mels.items():
            if kind == "npy":
                path = str(tmp_path / f"{utt}.npy")
                np.save(path, m)
                lines.append(f"{utt} {path}")
                continue
            path = str(tmp_path / f"{utt}.h5")
            with h5py.File(path, "w") as f:
                f["feats"] = m
                f["other"] = m[:, :3]
            lines.append(f"{utt} {path}:other" if kind == "h5_path"
                         else f"{utt} {path}")
    scp = _write_scp(tmp_path / "feats.scp", lines)
    got = MelSCPDataset(scp, mel_length_threshold=6, return_utt_id=True,
                        allow_cache=True)
    want = JaxMelSCPDataset(scp, mel_length_threshold=6, return_utt_id=True)
    assert got.utt_ids == want.utt_ids == ["utt0", "utt2"]
    for i in range(len(got)):
        (u1, m1), (u2, m2) = got[i], want[i]
        assert u1 == u2 and m1.dtype == np.float32
        np.testing.assert_array_equal(m1, m2)
        assert got[i] is got[i]  # cached
    bad = _write_scp(tmp_path / "bad.scp", ["utt0 feats.txt"])
    with pytest.raises(ValueError, match="Not supported"):
        MelSCPDataset(bad)


def _models(name, device="cpu"):
    config = CONFIGS[name]
    gp = config["generator_params"]
    flax = jax_model_class(config["generator_type"])(
        **{k: v for k, v in gp.items() if k != "in_channels"})
    v = melgan_perturbed(flax.init(jax.random.key(0), jnp.zeros((1, 8, A))))
    return JaxInferenceModel(config, v), InferenceModel(config, v,
                                                        device=device)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_inference_chunked_matches_jax_and_the_whole_forward(name):
    """T 700, chunk 128, context 48: the windows' interiors equal the whole
    forward (48 frames cover these generators' receptive fields), in the
    port and in the JAX package."""
    ref, model = _models(name)
    mel = np.random.default_rng(2).standard_normal((T, A)).astype(np.float32)
    got = model.inference_chunked(mel, chunk_frames=CHUNK,
                                  context_frames=CONTEXT)
    whole = model.inference(mel)
    want = ref.inference_chunked(mel, chunk_frames=CHUNK,
                                 context_frames=CONTEXT)
    up = model.upsample_factor
    assert got.shape == whole.shape == want.shape == (T * up, 1)
    scale = 1 + np.abs(want).max()
    assert np.abs(want).max() > 0.05
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got - whole).max() <= 1e-5 * scale
    short = mel[:200]  # one window: the plain forward
    np.testing.assert_array_equal(
        model.inference_chunked(short, CHUNK, CONTEXT), model.inference(short))


def test_pwg_chunks_are_the_windows_forward_on_their_noise():
    """A Parallel WaveGAN draws each window's z from one generator in window
    order: each chunk is the JAX forward of its window on that z."""
    kw = dict(flax_generator_kwargs(layers=4, stacks=2, aux_channels=A))
    config = {"generator_type": "ParallelWaveGANGenerator",
              "generator_params": kw}
    flax = jax_model_class("ParallelWaveGANGenerator")(**kw)
    v = melgan_perturbed(flax.init(jax.random.key(0), jnp.zeros((1, 32, 1)),
                                   jnp.zeros((1, 12, A))))
    ref = JaxInferenceModel(config, v)
    model = InferenceModel(config, v, device="cpu")
    mel = np.random.default_rng(3).standard_normal((450, A)).astype(
        np.float32)
    got = model.inference_chunked(mel, CHUNK, CONTEXT,
                                  generator=torch.Generator().manual_seed(5))
    up = model.upsample_factor
    assert got.shape == (450 * up, 1)
    noise = torch.Generator().manual_seed(5)
    window = CHUNK + 2 * CONTEXT
    starts = list(range(0, 450, CHUNK))
    for a in starts:
        b = min(a + CHUNK, 450)
        lo = max(0, min(a - CONTEXT, 450 - window))
        hi = min(450, lo + window) if lo > 0 else b + CONTEXT
        z = torch.randn((1, (hi - lo) * up, 1), generator=noise)
        fn, args, _ = ref.prepare_batch([mel[lo:hi]], bucket_size=1)
        want = np.asarray(fn(args[0], args[1], jnp.asarray(z.numpy())))[0]
        want = want[(a - lo) * up: (b - lo) * up]
        seg = got[a * up: b * up]
        assert np.abs(want).max() > 0.05
        assert np.abs(seg - want).max() <= 1e-5 * (1 + np.abs(want).max())
    assert len(starts) == 4


def _decode_setup(tmp_path, name):
    """A reference .pkl (the JAX exporter), its config.yml, and npy mels
    behind a feats.scp."""
    ref, _ = _models(name)
    config = dict(CONFIGS[name], sampling_rate=8000, format="npy")
    ckpt = tmp_path / "checkpoint-10steps.pkl"
    save_reference_checkpoint(
        str(ckpt), jax.tree.map(np.asarray, ref.variables["params"]), config)
    with open(tmp_path / "config.yml", "w") as f:
        yaml.safe_dump(config, f)
    rng = np.random.default_rng(4)
    lines, mels = [], {}
    for utt, n in (("long", 300), ("short", 40)):
        mels[utt] = rng.standard_normal((n, A)).astype(np.float32)
        np.save(tmp_path / f"{utt}.npy", mels[utt])
        lines.append(f"{utt} {tmp_path / f'{utt}.npy'}")
    scp = _write_scp(tmp_path / "feats.scp", lines)
    return ref, ckpt, scp, mels


def test_decode_cli_feats_scp_chunked(tmp_path):
    """bin.decode --feats-scp --chunk-frames on a multi-band MelGAN .pkl:
    each wav is the JAX package's chunked synthesis, as 16-bit PCM (one
    LSB for rounding at the truncation)."""
    ref, ckpt, scp, mels = _decode_setup(tmp_path, "mb_melgan")
    out = tmp_path / "wav"
    decode_main(["--feats-scp", scp, "--checkpoint", str(ckpt),
                 "--outdir", str(out), "--chunk-frames", "64",
                 "--device", "cpu"])
    for utt, mel in mels.items():
        sr, pcm = wavfile.read(out / f"{utt}_gen.wav")
        want = ref.inference_chunked(mel, chunk_frames=64)[:, 0]
        want = (np.clip(want, -1, 1) * 32767.0).astype(np.int16)
        assert sr == 8000 and pcm.shape == want.shape == (len(mel) * 64,)
        assert np.abs(pcm.astype(np.int32) - want).max() <= 1


def test_decode_cli_error_probes(tmp_path, capsys):
    """Both inputs or neither; --int8 on a MelGAN and on a multi-band
    HiFi-GAN, with the JAX CLI's messages, before anything is written."""
    _, ckpt, scp, _ = _decode_setup(tmp_path, "melgan")
    base = ["--checkpoint", str(ckpt), "--outdir", str(tmp_path / "o"),
            "--device", "cpu"]
    with pytest.raises(ValueError, match="either --dumpdir or --feats-scp"):
        decode_main(base + ["--feats-scp", scp, "--dumpdir", str(tmp_path)])
    with pytest.raises(ValueError, match="either --dumpdir or --feats-scp"):
        decode_main(base)
    with pytest.raises(SystemExit):
        decode_main(base + ["--scp", scp, "--int8"])
    assert ("--int8 supports HiFiGANGenerator checkpoints only (got "
            "MelGANGenerator)") in capsys.readouterr().err
    config = dict(CONFIGS["hifigan"], format="npy")
    config["generator_params"] = dict(config["generator_params"],
                                      out_channels=4)
    with open(tmp_path / "hifigan.yml", "w") as f:
        yaml.safe_dump(config, f)
    with pytest.raises(SystemExit):
        decode_main(base + ["--scp", scp, "--int8", "--config",
                            str(tmp_path / "hifigan.yml")])
    assert ("--int8 does not support multi-band (PQMF) generators"
            in capsys.readouterr().err)
    assert not os.path.exists(tmp_path / "o")
