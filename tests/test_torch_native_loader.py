"""The port's native loader (``datasets/native_loader.py`` over its own
copy of ``native/data_loader.cc``) against the JAX package's
``NativeMelWavLoader`` on an npy corpus the test writes: bit-equal y, c and
z over two epochs, at one and four threads, in two shards; and
``bin.train``'s choice of loader under ``use_native_loader`` auto, true
and false."""

import logging
import os

import numpy as np
import pytest

from parallelwavegan_torch.bin import train as train_cli
from parallelwavegan_torch.datasets import native_loader
from parallelwavegan_torch.datasets.loader import DataLoader
from parallelwavegan_tpu.datasets import native_loader as jax_native_loader

HOP, MELS, CTX = 16, 8, 2


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Nine utterances of 12-90 frames (f32 waves; two of the feats in
    float64, which the loader converts), one too short to crop."""
    root = tmp_path_factory.mktemp("npy")
    rng = np.random.default_rng(0)
    pairs = []
    for i, frames in enumerate((40, 55, 61, 70, 90, 47, 83, 12, 66)):
        wave = rng.standard_normal(frames * HOP).astype(np.float32)
        feats = rng.standard_normal((frames, MELS))
        feats = feats.astype(np.float64 if i in (2, 5) else np.float32)
        paths = (str(root / f"utt{i}-wave.npy"),
                 str(root / f"utt{i}-feats.npy"))
        np.save(paths[0], wave)
        np.save(paths[1], feats)
        pairs.append(paths)
    return str(root), pairs


def _batches(loader, epochs=(0, 1)):
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        out.append([{k: v.copy() for k, v in b.items()} for b in loader])
    return out


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("shard", [0, 1])
def test_batches_are_bit_equal_to_jax(corpus, threads, shard):
    """Batches of 2 at 320-sample windows with z, shard ``shard`` of 2,
    epochs 0 and 1: the same number, keys and bits as the JAX loader's at
    the same seed (the JAX one at 4 threads); each epoch reshuffles."""
    _, pairs = corpus
    kw = dict(batch_size=2, batch_max_steps=20 * HOP + 5, hop_size=HOP,
              aux_context_window=CTX, use_noise_input=True, seed=3,
              num_shards=2, shard_index=shard)
    got = _batches(native_loader.NativeMelWavLoader(pairs, num_threads=threads,
                                                    **kw))
    want = _batches(jax_native_loader.NativeMelWavLoader(pairs,
                                                         num_threads=4, **kw))
    assert [len(e) for e in got] == [len(e) for e in want] == [2, 2]
    for g_epoch, w_epoch in zip(got, want):
        for g, w in zip(g_epoch, w_epoch):
            assert sorted(g) == sorted(w) == ["c", "y", "z"]
            assert g["y"].shape == (2, 20 * HOP, 1)
            assert g["c"].shape == (2, 20 + 2 * CTX, MELS)
            for key in w:
                assert g[key].dtype == np.float32
                np.testing.assert_array_equal(g[key], w[key])
    assert not np.array_equal(got[0][0]["y"], got[1][0]["y"])


def test_surface_matches_the_pytorch_loader(corpus):
    """``len`` as the JAX loader's; without noise no z; the crop is a
    window of the utterance: y the wave's samples of the mel window's
    frames."""
    _, pairs = corpus
    loader = native_loader.NativeMelWavLoader(
        pairs, batch_size=3, batch_max_steps=10 * HOP, hop_size=HOP,
        aux_context_window=CTX, shuffle=False)
    jax_loader = jax_native_loader.NativeMelWavLoader(
        pairs, batch_size=3, batch_max_steps=10 * HOP, hop_size=HOP,
        aux_context_window=CTX, shuffle=False)
    assert len(loader) == len(jax_loader) == 2 and loader.num_utts == 8
    batch = next(iter(loader))
    assert sorted(batch) == ["c", "y"]
    waves = {i: np.load(p[0]) for i, p in enumerate(pairs)}
    feats = {i: np.load(p[1]).astype(np.float32) for i, p in enumerate(pairs)}
    for b in range(3):
        i = b  # no shuffle: the first three utterances, in order
        starts = [s for s in range(CTX, len(feats[i]) - 10 - CTX)
                  if np.array_equal(feats[i][s - CTX:s + 10 + CTX],
                                    batch["c"][b])]
        assert len(starts) == 1
        np.testing.assert_array_equal(
            batch["y"][b, :, 0], waves[i][starts[0] * HOP:
                                          (starts[0] + 10) * HOP])


def _config(**overrides):
    config = {"generator_type": "ParallelWaveGANGenerator",
              "generator_params": {"aux_context_window": CTX},
              "format": "npy", "batch_size": 2, "batch_max_steps": 20 * HOP,
              "hop_size": HOP}
    config.update(overrides)
    return config


@pytest.mark.parametrize("setting,fmt,gen_type,want", [
    ("auto", "npy", "ParallelWaveGANGenerator", "native"),
    (None, "npy", "HiFiGANGenerator", "native"),
    ("auto", "npy", "UHiFiGANGenerator", "pytorch"),
    ("auto", "hdf5", "ParallelWaveGANGenerator", "pytorch"),
    (False, "npy", "ParallelWaveGANGenerator", "pytorch"),
    (True, "npy", "ParallelWaveGANGenerator", "native"),
    (True, "npy", "UHiFiGANGenerator", "native"),
], ids=lambda v: str(v))
def test_train_chooses_the_loader_as_jax(corpus, setting, fmt, gen_type, want,
                                         caplog):
    """auto (the default) takes the native loader for npy dumps of the
    four mel2wav families without f0, true takes it whatever the family,
    false never; the choice is logged, and z follows ``uses_noise``."""
    root, _ = corpus
    config = _config(generator_type=gen_type, format=fmt)
    if setting is not None:
        config["use_native_loader"] = setting
    dataset = train_cli.build_dataset(_config(), root)
    with caplog.at_level(logging.INFO):
        loader = train_cli.build_loader(config, dataset, 0)
    kind = ("native" if isinstance(loader, native_loader.NativeMelWavLoader)
            else "pytorch")
    assert kind == want
    assert ("native (C++)" if want == "native" else "PyTorch data loader") \
        in caplog.text
    if want == "native":
        assert ("z" in next(iter(loader))) == (
            gen_type == "ParallelWaveGANGenerator")
    else:
        assert isinstance(loader, DataLoader)


def test_use_f0_keeps_the_pytorch_loader(corpus):
    root, _ = corpus
    config = _config(use_f0=True)
    dataset = train_cli.build_dataset(_config(), root)
    assert isinstance(train_cli.build_loader(config, dataset, 0), DataLoader)


def test_true_raises_where_the_library_cannot_build(corpus, monkeypatch):
    """``use_native_loader: true`` without a toolchain raises, as the JAX
    constructor does; ``auto`` falls back."""
    root, _ = corpus
    monkeypatch.setattr(native_loader, "_LIB", None)
    monkeypatch.setattr(native_loader, "_LIB_ERR", "no g++")
    dataset = train_cli.build_dataset(_config(), root)
    assert isinstance(train_cli.build_loader(_config(), dataset, 0),
                      DataLoader)
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        train_cli.build_loader(_config(use_native_loader=True), dataset, 0)


def test_library_builds_under_the_package(corpus):
    """The shared library lands in the package's _build directory, its
    name hashed over the source and flags; the source is the JAX
    package's line for line below its header comment."""
    path = native_loader.build_library()
    assert os.path.dirname(path) == str(native_loader.BUILD_DIR)
    assert os.path.basename(path).startswith("libpwg_data-")
    with open(native_loader.SOURCE) as f:
        ours = f.read()
    with open(jax_native_loader._SRC) as f:
        theirs = f.read()
    body = ours[ours.index("#include <atomic>"):]
    assert body == theirs[theirs.index("#include <atomic>"):]
