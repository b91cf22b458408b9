"""The VQ-VAE (wav2wav) in the port against the JAX package on the CPU:
the codebook (nearest codes with an exact tie, the straight-through value
and gradient, lookup), the model with no condition, a global, a local and
both (folded and trainable; encode and decode at a ragged length), the
reference ``.pkl`` both ways, ``InferenceModel.vq_encode`` / ``vq_decode``
and the bf16 refusal, ``bin.decode`` against the JAX CLI and its refusal
of conditioned npy dumps, the collater's audio batches and the three
audio datasets.

Codes are compared first (``torch_helpers.assert_codes``): they may differ
only at a near-tie. Each model's codebook rows are latents of a seeded
batch (``torch_helpers.seed_codebook``), so that the codes spread."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelwavegan_tpu.datasets import audio_mel_dataset as jax_datasets
from parallelwavegan_tpu.datasets.collater import Collater as JaxCollater
from parallelwavegan_tpu.engine.checkpoint import (
    load_reference_checkpoint as jax_load_reference_checkpoint,
)
from parallelwavegan_tpu.layers import VQCodebook as FlaxVQCodebook
from parallelwavegan_tpu.models.vqvae import VQVAE as FlaxVQVAE
from parallelwavegan_tpu.utils import torch_export as jax_export
from parallelwavegan_tpu.utils import torch_import as jax_import
from parallelwavegan_tpu.utils.model_loader import (
    InferenceModel as JaxInferenceModel,
)
from parallelwavegan_torch.bin import decode as decode_cli
from parallelwavegan_torch.datasets import audio_mel_dataset as datasets
from parallelwavegan_torch.datasets.collater import Collater
from parallelwavegan_torch.engine.checkpoint import save_generator_checkpoint
from parallelwavegan_torch.layers.vq import VQCodebook
from parallelwavegan_torch.models import VQVAE
from parallelwavegan_torch.utils import torch_export, torch_import
from parallelwavegan_torch.utils.model_loader import InferenceModel, load_model
from parallelwavegan_torch.utils.params import convert_jax_params, nested
from tests.test_torch_reference_pkl import assert_trees_equal
from tests.torch_helpers import (
    assert_codes,
    melgan_perturbed,
    seed_codebook,
    small_vqvae_train_config,
)

torch.set_num_threads(2)

CONDS = ["none", "global", "local_only", "global_local"]
FOLD = pytest.mark.parametrize("fold", [True, False],
                               ids=["folded", "trainable"])
HOP = 16  # the encoder's downsampling, and the local condition's hop


def assert_close(got, want, tol=1e-5):
    """|got - want| <= tol (1 + max |want|), on outputs of order one."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(want).max() > 1e-3
    err = np.abs(got - want).max()
    assert err <= tol * (1 + np.abs(want).max()), err


def _config(cond):
    """small_vqvae_train_config's generator, with a local condition alone
    for "local_only" and both for "global_local"."""
    if cond == "local_only":
        config = small_vqvae_train_config("none", use_local_condition=True)
        gp = config["generator_params"]
        gp.update(num_local_embeds=2, local_embed_dim=3)
        gp["decoder_conf"]["in_channels"] += 3
        return config
    return small_vqvae_train_config(
        {"global_local": "local"}.get(cond, cond))


def _inputs(cond, T=512, B=2, seed=0):
    """(x (B, T, 1), l (B, frames, 2) or None, g (B,) or None); the frames
    those the encoder gives (ceil(T / 16) at a ragged T)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 8000.0
    x = np.stack([0.4 * np.sin(2 * np.pi * (220 + 170 * i) * t)
                  + 0.1 * rng.standard_normal(T) for i in range(B)])
    frames = -(-T // HOP)
    l = (rng.standard_normal((B, frames, 2)).astype(np.float32)
         if "local" in cond else None)
    g = (np.arange(B, dtype=np.int32) % 4 + 1 if "global" in cond
         else None)
    return x.astype(np.float32)[..., None], l, g


@functools.lru_cache(maxsize=None)
def _flax(cond):
    """(flax module, variables) of the cond's generator, moved off its
    init (weight-norm gains near 1, so that the signal, not the biases,
    leads the latents), the codebook rows latents of a seeded batch."""
    gp = _config(cond)["generator_params"]
    module = FlaxVQVAE(**gp)
    x, l, g = _inputs(cond, seed=5)
    v = melgan_perturbed(module.init(jax.random.key(0), x, l, g), 1)
    z_e = module.apply(v, x, l, g)[1]
    return module, seed_codebook(v, z_e)


def _np_tree(v):
    return jax.tree.map(np.asarray, v)


def _port(cond, fold=True):
    module, v = _flax(cond)
    gen = VQVAE(**_config(cond)["generator_params"], folded=fold)
    gen.load_state_dict(convert_jax_params(_np_tree(v["params"]), fold=fold),
                        strict=True)
    return gen


def _t(a, dtype=None):
    return None if a is None else torch.from_numpy(np.array(a, dtype))


def test_codebook_matches_flax():
    """Nearest codes (with an exact tie, which both take at the first
    index), the straight-through value and its gradient, lookup."""
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((16, 8)).astype(np.float32)
    emb[9] = emb[3]  # codes 3 and 9 tie for any latent
    z = rng.standard_normal((2, 20, 8)).astype(np.float32)
    z[0, 4] = emb[3]
    z[1, 7] = 0.5 * (emb[3] + emb[5])
    flax_cb = FlaxVQCodebook(num_embeddings=16, embedding_dim=8)
    v = {"params": {"embedding": jnp.asarray(emb)}}
    cb = VQCodebook(16, 8)
    cb.load_state_dict({"embedding": torch.from_numpy(emb)}, strict=True)
    want = np.asarray(flax_cb.apply(v, z))
    got = cb(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 4] == 3 and 9 not in got

    def loss(e, z):
        z_st, z_q = flax_cb.apply({"params": {"embedding": e}}, z,
                                  method=flax_cb.straight_through)
        return jnp.sum(z_st ** 3) + jnp.sum(z_q ** 2), (z_st, z_q)

    (_, (z_st, z_q)), (de, dz) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(emb), jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_()
    t_st, t_q = cb.straight_through(zt)
    (torch.sum(t_st ** 3) + torch.sum(t_q ** 2)).backward()
    np.testing.assert_array_equal(t_st.detach().numpy(), np.asarray(z_st))
    np.testing.assert_array_equal(t_q.detach().numpy(), np.asarray(z_q))
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(dz), rtol=1e-6)
    np.testing.assert_allclose(cb.embedding.grad.numpy(), np.asarray(de),
                               rtol=1e-6, atol=1e-6)
    idx = rng.integers(0, 16, (3, 5))
    np.testing.assert_array_equal(
        cb.lookup(torch.from_numpy(idx)).detach().numpy(),
        np.asarray(flax_cb.apply(v, idx, method=flax_cb.lookup)))


@pytest.mark.parametrize("cond", CONDS)
@FOLD
def test_vqvae_matches_flax(cond, fold):
    """forward(x, l, g) -> (x_bar, z_e, z_q): the codes first, then the
    three outputs within 1e-5 (1 + max)."""
    module, v = _flax(cond)
    gen = _port(cond, fold)
    x, l, g = _inputs(cond)
    x_bar, z_e, z_q = module.apply(v, x, l, g)
    got = gen(_t(x), _t(l), _t(g))
    emb = np.asarray(v["params"]["codebook"]["embedding"])
    codes = module.apply(v, x, method=module.encode)
    assert_codes(gen.encode(_t(x)).numpy(), codes, z_e, emb)
    assert len(np.unique(np.asarray(codes))) >= 4
    for a, b in zip(got, (x_bar, z_e, z_q)):
        assert_close(a.detach().numpy(), b)
    assert got[0].shape == (2, 512, 1)


@pytest.mark.parametrize("cond", CONDS)
def test_encode_and_decode_match_flax_at_a_ragged_length(cond):
    """T = 517 (not a multiple of the encoder's 16): the same codes, then
    decode of those codes with the conditions within 1e-5 (1 + max)."""
    module, v = _flax(cond)
    gen = _port(cond)
    x, l, g = _inputs(cond, T=517, seed=3)
    codes = np.asarray(module.apply(v, x, method=module.encode))
    got = gen.encode(_t(x)).numpy()
    z_e = module.apply(v, x, l, g)[1]
    assert codes.shape == (2, 33) == z_e.shape[:2]
    assert_codes(got, codes, z_e, v["params"]["codebook"]["embedding"])
    want = module.apply(v, codes, l, g, method=module.decode)
    assert_close(gen.decode(_t(codes), _t(l), _t(g)).detach().numpy(), want)


@pytest.mark.parametrize("cond", ["none", "global_local"])
def test_pkl_both_ways_match_jax(tmp_path, cond):
    """The JAX exporter's state_dict equals the port's; both importers give
    the same tree for it (the local 1x1 conv weight-normed, as the
    reference holds it); a .pkl the port writes reads back through the JAX
    importer to the folded parameters and serves through the port's
    load_model like the JAX InferenceModel."""
    config = _config(cond)
    module, v = _flax(cond)
    params = v["params"]
    state = jax_export.export_generator_state_dict(params, "VQVAE", config)
    mine = torch_export.export_generator_state_dict(params, "VQVAE", config)
    assert sorted(mine) == sorted(state)
    assert "codebook.embedding.weight" in state
    assert "encoder.layers.0.1.weight_v" in state
    assert "decoder.melgan.1.weight_g" in state
    if cond != "none":
        assert "global_embed.weight" in state
        assert "local_embed.weight_v" in state
    for key in state:
        np.testing.assert_array_equal(mine[key], state[key], err_msg=key)
    tensors = {k: torch.from_numpy(np.array(a)) for k, a in state.items()}
    gp = config["generator_params"]
    got = torch_import.import_model_params(tensors, "VQVAE", gp)
    assert_trees_equal(got, jax_import.import_model_params(tensors, "VQVAE",
                                                           gp))
    path = str(tmp_path / "checkpoint-5steps.pkl")
    torch_export.save_reference_checkpoint(
        path, nested(_port(cond, fold=False).state_dict()), config, steps=5)
    back = jax_load_reference_checkpoint(path, config)
    assert back["steps"] == 5
    assert_trees_equal(back["generator"], got)
    model = load_model(path, config, device="cpu")
    ref = JaxInferenceModel(config, {"params": jax.tree.map(
        jnp.asarray, back["generator"]["params"])})
    x, l, g = _inputs(cond, T=256, B=1, seed=9)
    codes = ref.vq_encode(x[0, :, 0])
    assert_codes(model.vq_encode(x[0, :, 0])[None], codes[None],
                 ref.generator.apply(ref.variables, x, l, g)[1],
                 ref.variables["params"]["codebook"]["embedding"])
    gi = None if g is None else int(g[0])
    li = None if l is None else l[0]
    assert_close(model.vq_decode(codes, l=li, g=gi),
                 ref.vq_decode(codes, l=li, g=gi))


@pytest.mark.parametrize("cond", ["global", "local_only"])
def test_inference_model_matches_jax(cond):
    """vq_encode of a ragged utterance (the same codes), then vq_decode
    with the speaker id or the local condition, against the JAX
    InferenceModel; the upsample factor is 1, as there."""
    config = _config(cond)
    _, v = _flax(cond)
    ref = JaxInferenceModel(config, v)
    model = InferenceModel(config, _np_tree(v), device="cpu")
    assert model.upsample_factor == ref.upsample_factor == 1
    x, l, g = _inputs(cond, T=1000, B=1, seed=11)
    codes = ref.vq_encode(x[0, :, 0])
    got = model.vq_encode(x[0, :, 0])
    z_e = ref.generator.apply(ref.variables, x, None if l is None else l,
                              None if g is None else g)[1]
    assert_codes(got[None], codes[None], z_e,
                 v["params"]["codebook"]["embedding"])
    assert codes.shape == (63,)
    kw = {"g": int(g[0])} if g is not None else {"l": l[0]}
    y = model.vq_decode(codes, **kw)
    assert y.shape == (63 * HOP, 1)
    assert_close(y, ref.vq_decode(codes, **kw))


def test_bf16_serving_is_refused_as_the_jax_package_fails():
    """The JAX InferenceModel cannot serve this family in bf16 (its first
    conv gets f32 audio and bf16 weights); the port refuses it at load,
    naming the family."""
    config = _config("global")
    _, v = _flax("global")
    audio = _inputs("global", T=256, B=1)[0][0, :, 0]
    with pytest.raises(TypeError, match="same dtypes"):
        JaxInferenceModel(config, v, dtype=jnp.bfloat16).vq_encode(audio)
    with pytest.raises(NotImplementedError, match="VQVAE"):
        InferenceModel(config, _np_tree(v), dtype=torch.bfloat16,
                       device="cpu")
    model = InferenceModel(config, _np_tree(v), dtype=torch.float32,
                           device="cpu")
    with pytest.raises(ValueError, match="vq_encode"):
        model.synthesize_batch([np.zeros((4, 16), np.float32)])


def _write_dumps(root, n, rng, cond="none", lengths=(700, 1031, 513)):
    """npy wav2wav dumps: ``<utt>-wave.npy`` and, as the cond asks,
    ``-global.npy`` (a speaker id) and ``-local.npy`` (len // 16 frames
    of 2 channels)."""
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        T = lengths[i % len(lengths)]
        t = np.arange(T) / 8000.0
        wave = (0.5 * np.sin(2 * np.pi * (200 + 90 * i) * t)
                + 0.05 * rng.standard_normal(T)).astype(np.float32)
        np.save(os.path.join(root, f"utt{i}-wave.npy"), wave)
        if "global" in cond or cond == "local":
            np.save(os.path.join(root, f"utt{i}-global.npy"),
                    np.array([i % 4], np.int64))
        if "local" in cond:
            np.save(os.path.join(root, f"utt{i}-local.npy"),
                    rng.standard_normal((T // HOP, 2)).astype(np.float32))


def test_decode_cli_matches_the_jax_cli(tmp_path, monkeypatch):
    """bin.decode over npy dumps of an unconditioned VQ-VAE: the same wavs
    (16-bit, within one step) and the same ``text`` as the JAX CLI on the
    same .gckpt."""
    from scipy.io import wavfile

    from parallelwavegan_tpu.bin import decode as jax_decode_cli

    config = dict(_config("none"), format="npy")
    gen = _port("none")
    ckpt = str(tmp_path / "generator.gckpt")
    save_generator_checkpoint(ckpt, gen)
    conf = str(tmp_path / "config.json")
    with open(conf, "w") as f:
        import json

        json.dump(config, f)
    dump = str(tmp_path / "dump")
    _write_dumps(dump, 3, np.random.default_rng(2))
    outs = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    decode_cli.main(["--dumpdir", dump, "--checkpoint", ckpt, "--config",
                     conf, "--outdir", outs["port"], "--device", "cpu"])
    monkeypatch.setenv("PARALLELWAVEGAN_TPU_CACHE_DIR", "")
    monkeypatch.setattr(sys, "argv", [
        "decode", "--dumpdir", dump, "--checkpoint", ckpt, "--config", conf,
        "--outdir", outs["jax"]])
    jax_decode_cli.main()
    texts = {k: open(os.path.join(d, "text")).read() for k, d in outs.items()}
    assert texts["port"] == texts["jax"]
    assert len(texts["port"].splitlines()) == 3
    for i, T in enumerate((700, 1031, 513)):
        line = texts["port"].splitlines()[i].split()
        assert line[0] == f"utt{i}" and len(line) == 1 + -(-T // HOP)
        got, want = (wavfile.read(os.path.join(d, f"utt{i}_gen.wav"))[1]
                     for d in (outs["port"], outs["jax"]))
        assert got.shape == want.shape == ((len(line) - 1) * HOP,)
        assert np.abs(got.astype(np.int32) - want).max() <= 1


@pytest.mark.parametrize("cond", ["global", "local"])
def test_decode_refuses_conditioned_npy_dumps(tmp_path, cond):
    """A conditioned VQ-VAE reads its conditions from hdf5 dumps only (the
    JAX CLI passes none over npy dumps, and its decoder then fails): the
    port raises a ValueError naming hdf5."""
    config = dict(_config({"local": "global_local"}.get(cond, cond)),
                  format="npy")
    gen = _port({"local": "global_local"}.get(cond, cond))
    ckpt = str(tmp_path / "generator.gckpt")
    save_generator_checkpoint(ckpt, gen)
    conf = str(tmp_path / "config.json")
    with open(conf, "w") as f:
        import json

        json.dump(config, f)
    dump = str(tmp_path / "dump")
    _write_dumps(dump, 1, np.random.default_rng(2), cond=cond)
    with pytest.raises(ValueError, match="hdf5"):
        decode_cli.main(["--dumpdir", dump, "--checkpoint", ckpt,
                         "--config", conf, "--outdir", str(tmp_path / "o"),
                         "--device", "cpu"])


def _items(mode, rng):
    """Dataset items of each wav2wav mode, one too short to crop."""
    items = []
    for i, T in enumerate((900, 2000, 300, 1300)):
        x = rng.standard_normal(T).astype(np.float32)
        if mode == "audio":
            items.append(x)
        elif mode == "global":
            items.append((x, i % 3))
        else:
            item = (x, rng.standard_normal((T // HOP + 1, 2)).astype(
                np.float32))
            items.append(item + ((i % 3,) if mode == "local_global" else ()))
    return items


@pytest.mark.parametrize("mode", ["audio", "global", "local",
                                  "local_global"])
def test_audio_batch_matches_the_jax_collater(mode):
    """The wav2wav batches of one seed, over three batches (the local
    condition with 2 frames of context on either side)."""
    kw = dict(batch_max_steps=520, hop_size=HOP,
              aux_context_window=2 if "local" in mode else 0,
              use_aux_input=False,
              use_global_condition="global" in mode,
              use_local_condition="local" in mode)
    items = _items(mode, np.random.default_rng(4))
    if mode == "global":  # the JAX collater keeps every id: crop them all
        items = [b for b in items if len(b[0]) > 512]
    if mode == "audio":
        items = [b for b in items if len(b) > 512]
    ours = Collater(**kw, rng=np.random.default_rng(7))
    ref = JaxCollater(**kw, rng=np.random.default_rng(7))
    for _ in range(3):
        got, want = ours(items), ref(items)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["y"].shape[1:] == (512, 1)
    if "local" in mode:
        assert got["l"].shape[1:] == (32 + 4, 2)


@pytest.mark.parametrize("kind", ["AudioDataset", "AudioGlobalDataset",
                                  "AudioLocalDataset"])
def test_audio_datasets_match_jax(tmp_path, kind):
    """Items and utterance ids over npy dumps, the short ones filtered out,
    with and without utterance ids."""
    cond = {"AudioDataset": "none", "AudioGlobalDataset": "global",
            "AudioLocalDataset": "local"}[kind]
    root = str(tmp_path)
    _write_dumps(root, 4, np.random.default_rng(3), cond=cond)
    load = lambda name: (lambda f: np.load(  # noqa: E731
        f.replace("-wave.npy", f"-{name}.npy")))
    kw = dict(audio_query="*-wave.npy", audio_load_fn=np.load,
              audio_length_threshold=600)
    if kind == "AudioGlobalDataset":
        kw["global_load_fn"] = load("global")
    if kind == "AudioLocalDataset":
        kw.update(local_load_fn=load("local"), global_load_fn=load("global"))
    for utt in (False, True):
        ours = getattr(datasets, kind)(root, return_utt_id=utt, **kw)
        ref = getattr(jax_datasets, kind)(root, return_utt_id=utt, **kw)
        assert ours.utt_ids == ref.utt_ids == ["utt0", "utt1", "utt3"]
        assert len(ours) == len(ref) == 3
        for i in range(3):
            got, want = ours[i], ref[i]
            if kind == "AudioDataset" and not utt:
                got, want = (got,), (want,)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                if isinstance(b, (str, int)):
                    assert a == b and type(a) is type(b)
                else:
                    np.testing.assert_array_equal(a, b)
