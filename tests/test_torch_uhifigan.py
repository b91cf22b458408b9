"""UHiFiGAN (sine-excitation U-Net HiFi-GAN) in the port against the JAX
package on the CPU: ``sine_excitation`` on the same draws, the generator
(folded and trainable, with dropout off and on the same keep masks) at the
debug recipe's width on its own scales and on the opencpop recipe's
5 x 5 x 4 x 3, the reference ``.pkl`` both ways, the four F0 datasets and
the collater's f0 and excitation crops, ``InferenceModel.inference`` in
f32 and bf16, ``bin.decode`` over npy dumps, and ``chip_smoke``'s recipe
against its yaml.

flax's dropout draws its keep masks with ``flax.linen.stochastic.random.
bernoulli``; ``FlaxMasks`` stands in for that name and hands out the
port's masks in call order, so that nothing in the JAX package changes.
"""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import parallelwavegan_tpu.ops.sine as jax_sine
from parallelwavegan_tpu.datasets import audio_mel_dataset as jax_datasets
from parallelwavegan_tpu.datasets.collater import Collater as JaxCollater
from parallelwavegan_tpu.engine.checkpoint import (
    load_reference_checkpoint as jax_load_reference_checkpoint,
)
from parallelwavegan_tpu.models.uhifigan import (
    UHiFiGANGenerator as FlaxUHiFiGAN,
)
from parallelwavegan_tpu.utils import torch_export as jax_export
from parallelwavegan_tpu.utils import torch_import as jax_import
from parallelwavegan_tpu.utils.model_loader import (
    InferenceModel as JaxInferenceModel,
)
from parallelwavegan_torch.bin import decode as decode_cli
from parallelwavegan_torch.datasets import audio_mel_dataset as datasets
from parallelwavegan_torch.datasets.collater import Collater
from parallelwavegan_torch.engine.checkpoint import save_generator_checkpoint
from parallelwavegan_torch.models import UHiFiGANGenerator
from parallelwavegan_torch.ops.sine import sine_excitation
from parallelwavegan_torch.utils import torch_export, torch_import
from parallelwavegan_torch.utils.model_loader import InferenceModel, load_model
from parallelwavegan_torch.utils.params import convert_jax_params, nested
from tests.test_torch_reference_pkl import assert_trees_equal
from tests.torch_helpers import FlaxMasks, JaxDraws, perturbed

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEBUG_YAML = os.path.join(REPO, "egs/synthetic/voc1/conf/"
                          "uhifigan.v1.debug.yaml")
OPENCPOP_YAML = os.path.join(REPO, "egs/opencpop/voc1/conf/uhifigan.v1.yaml")
FOLD = pytest.mark.parametrize("fold", [True, False],
                               ids=["folded", "trainable"])


def _yaml(path):
    with open(path) as f:
        return yaml.safe_load(f)


def _case(name):
    """(generator params, hop, frames) of a case: the debug recipe
    ("debug", 8 channels, scales 4 x 4 x 2 x 2, one block of kernel 3),
    or the opencpop recipe's scales and blocks at the debug width
    ("opencpop": 8 channels, 5 x 5 x 4 x 3, three blocks)."""
    if name == "debug":
        return _yaml(DEBUG_YAML)["generator_params"], 64, 6
    return dict(_yaml(OPENCPOP_YAML)["generator_params"], channels=8), 300, 4


CASES = pytest.mark.parametrize("case", ["debug", "opencpop"])


def _inputs(case, B=2, seed=0):
    """(c (B, F, mels), excitation (B, F hop, 1)): a sine excitation of a
    seeded f0 contour with unvoiced frames."""
    gp, hop, frames = _case(case)
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((B, frames, gp["in_channels"])).astype(np.float32)
    f0 = np.where(rng.random((B, frames)) < 0.8,
                  150 + 250 * rng.random((B, frames)), 0.0)
    exc, _, _ = sine_excitation(
        torch.from_numpy(np.repeat(f0, hop, axis=1)[..., None]).float(),
        24000, generator=torch.Generator().manual_seed(seed))
    return c, exc.numpy()


def _flax_module(case):
    gp, _, _ = _case(case)
    return FlaxUHiFiGAN(**{k: tuple(map(tuple, v)) if k ==
                           "resblock_dilations" else v
                           for k, v in gp.items()})


@functools.lru_cache(maxsize=None)
def _flax(case):
    """(flax module, variables): the port's trainable init under the flax
    names (``test_flax_tree_is_the_ports`` holds them to flax's), moved off
    the init. flax's own init compiles every parameter's initializer (48 s
    under one jit at the opencpop scales)."""
    gen = UHiFiGANGenerator(**_case(case)[0], folded=False,
                            generator=torch.Generator().manual_seed(0))
    v = {"params": nested({k: t.detach().numpy()
                           for k, t in gen.state_dict().items()})}
    return _flax_module(case), perturbed(v, np.random.default_rng(1))


def _np_tree(v):
    return jax.tree.map(np.asarray, v)


def _port(case, fold=True):
    _, v = _flax(case)
    gen = UHiFiGANGenerator(**_case(case)[0], folded=fold)
    gen.load_state_dict(convert_jax_params(_np_tree(v["params"]), fold=fold),
                        strict=True)
    return gen


def assert_close(got, want, tol=1e-5):
    """|got - want| <= tol (1 + max |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(want).max() > 1e-2
    err = np.abs(got - want).max()
    assert err <= tol * (1 + np.abs(want).max()), err


# ----------------------------------------------------------------------
# sine excitation

@pytest.mark.parametrize("B, T, harmonic_num", [(2, 4096, 0), (1, 4096, 7),
                                                (3, 960, 2)])
def test_sine_excitation_matches_jax(monkeypatch, B, T, harmonic_num):
    """The same f0 (voiced contours with unvoiced frames) and draws (the
    port's, handed to the JAX function through ``JaxDraws``): uv and noise
    equal; the sines within 1e-5 of the JAX function's (1e-4 of the 0.1
    amplitude: both sum the phase in f32, the JAX package by an
    associative scan, the port in order) and within 5e-6 of a float64
    phase on the same draws (measured: 1.4e-6 at T 4,096 with 8
    harmonics, the JAX function 2.8e-6)."""
    rng = np.random.default_rng(T + harmonic_num)
    frames = T // 64
    f0_frames = np.where(rng.random((B, frames)) < 0.8,
                         100 + 300 * rng.random((B, frames)), 0.0)
    f0 = np.repeat(f0_frames, 64, axis=1)[..., None].astype(np.float32)
    dim = harmonic_num + 1
    sines, uv, noise = sine_excitation(
        torch.from_numpy(f0), 24000, harmonic_num,
        generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    phases = torch.rand((B, dim), generator=g)
    normals = torch.randn((B, T, dim), generator=g)
    monkeypatch.setattr(jax_sine, "jax", JaxDraws(
        normals=[normals.numpy()], uniforms=[phases.numpy()]))
    ref = [np.asarray(a) for a in jax_sine.sine_excitation(
        jax.random.key(0), jnp.asarray(f0), 24000, harmonic_num)]
    assert sines.shape == (B, T, dim) and uv.shape == (B, T, 1)
    np.testing.assert_array_equal(uv.numpy(), ref[1])
    np.testing.assert_array_equal(noise.numpy(), ref[2])
    np.testing.assert_allclose(sines.numpy(), ref[0], rtol=0, atol=1e-5)
    rad = (f0.astype(np.float64) * np.arange(1, dim + 1) / 24000) % 1.0
    rad[:, 0] += phases.numpy() * (np.arange(dim) > 0)
    want = (np.sin(2 * np.pi * np.cumsum(rad, axis=1)) * 0.1
            * (f0 > 0) + noise.numpy())
    np.testing.assert_allclose(sines.numpy(), want, rtol=0, atol=5e-6)


def test_sine_excitation_draws_on_the_generators_device():
    """The draws come from the generator given (a CPU one here), in the
    JAX function's order, and the fundamental's initial phase is 0: with
    the noise set to 0, a voiced 100 Hz f0 is sin(2 pi 100 t) * 0.1."""
    f0 = torch.full((1, 240, 1), 100.0)
    sines, uv, noise = sine_excitation(
        f0, 24000, noise_std=0.0, generator=torch.Generator().manual_seed(0))
    assert torch.equal(noise, torch.zeros_like(noise))
    t = torch.arange(1, 241, dtype=torch.float64) / 24000
    np.testing.assert_allclose(sines[0, :, 0].numpy(),
                               (0.1 * torch.sin(2 * torch.pi * 100 * t)
                                ).numpy(), atol=1e-6)
    assert torch.equal(uv, torch.ones_like(uv))
    with pytest.raises(ValueError, match=r"\(B, T, 1\)"):
        sine_excitation(f0[..., 0], 24000)


# ----------------------------------------------------------------------
# the generator

@CASES
def test_flax_tree_is_the_ports(case):
    """flax's parameter tree (its init's shapes, not run) has the port's
    trainable names and shapes: the flax paths of every conv, the MRF
    blocks numbered level by level, kernel_v / kernel_g / bias."""
    c, e = _inputs(case)
    shapes = jax.eval_shape(
        lambda k: _flax_module(case).init(k, c, None, e, True),
        jax.random.key(0))
    want = {k: tuple(v.shape) for k, v in convert_jax_params(
        jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                     shapes["params"]), fold=False).items()}
    gen = UHiFiGANGenerator(**_case(case)[0], folded=False)
    got = {k: tuple(v.shape) for k, v in gen.state_dict().items()}
    assert got == want
    assert "downsamples_mrf_0.convs1_0.kernel_v" in got
    assert "upsamples_3.kernel_g" in got


@CASES
@FOLD
def test_generator_matches_flax(case, fold):
    """deterministic=True: the port's forward within 1e-5 (1 + max) of
    flax's on the same converted weights; f0 is accepted and unused."""
    module, v = _flax(case)
    c, e = _inputs(case, seed=4)
    want = np.asarray(jax.jit(lambda v: module.apply(v, c, None, e, True))(v))
    gen = _port(case, fold)
    with torch.no_grad():
        got = gen(torch.from_numpy(c), excitation=torch.from_numpy(e))
        f0 = torch.ones((c.shape[0], c.shape[1], 1))
        assert torch.equal(gen(torch.from_numpy(c), f0,
                               torch.from_numpy(e)), got)
    assert got.shape == e.shape == want.shape
    assert_close(got.numpy(), want)


@CASES
def test_generator_with_dropout_matches_flax(case, monkeypatch):
    """deterministic=False with the port's keep masks handed to flax's
    five dropout layers in call order (``FlaxMasks``): within 1e-5
    (1 + max), and not the deterministic forward."""
    module, v = _flax(case)
    c, e = _inputs(case, seed=5)
    gen = _port(case, fold=False)
    masks = gen.draw_dropout_masks(c.shape[0], e.shape[1],
                                   torch.Generator().manual_seed(2))
    stand_in = FlaxMasks([m.numpy() for m in masks])
    monkeypatch.setattr("flax.linen.stochastic.random", stand_in)
    want = np.asarray(jax.jit(lambda v, k: module.apply(
        v, c, None, e, False, rngs={"dropout": k}))(v, jax.random.key(9)))
    assert not stand_in.masks  # each mask taken once
    with torch.no_grad():
        got = gen(torch.from_numpy(c), excitation=torch.from_numpy(e),
                  deterministic=False, masks=masks)
        plain = gen(torch.from_numpy(c), excitation=torch.from_numpy(e))
    assert_close(got.numpy(), want)
    assert np.abs(got.numpy() - plain.numpy()).max() > 1e-4


def test_dropout_masks_follow_the_rate_and_the_shapes():
    """Five masks, in call order, of the input conv's and each
    downsampling conv's output shape; keep share near 1 - dropout; kept
    entries scaled by 1 / keep; no masks, no dropout; dropout without
    masks raises; the masks' draws follow the generator's seed."""
    gen = UHiFiGANGenerator(**_case("opencpop")[0])
    shapes = gen.dropout_shapes(3, 1200)
    assert shapes == [(3, 1200, 8), (3, 240, 16), (3, 48, 32), (3, 12, 64),
                      (3, 4, 128)]
    masks = gen.draw_dropout_masks(3, 1200, torch.Generator().manual_seed(0))
    assert [tuple(m.shape) for m in masks] == shapes
    assert all(m.dtype == torch.bool for m in masks)
    keep = torch.cat([m.reshape(-1) for m in masks]).float().mean()
    assert abs(float(keep) - 0.9) < 0.01
    again = gen.draw_dropout_masks(3, 1200, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(masks, again))
    x = torch.ones(shapes[0])
    dropped = gen._drop(x, masks, 0)
    np.testing.assert_allclose(dropped[masks[0]].numpy(), 1 / 0.9, rtol=1e-6)
    assert (dropped[~masks[0]] == 0).all()
    c = torch.zeros((3, 4, 80))
    e = torch.zeros((3, 1200, 1))
    with pytest.raises(ValueError, match="masks"):
        gen(c, excitation=e, deterministic=False)
    with pytest.raises(ValueError, match="excitation"):
        gen(c)
    gen.dropout = 0.0
    assert gen.draw_dropout_masks(3, 1200) == []
    assert torch.equal(gen(c, excitation=e, deterministic=False),
                       gen(c, excitation=e))


def test_recipe_width_and_upsample_factor():
    """The opencpop recipe: about 25.6 M parameters, 300 samples a frame
    (the hop), and the bottleneck at the mel's frame rate."""
    config = _yaml(OPENCPOP_YAML)
    gen = UHiFiGANGenerator(**config["generator_params"])
    n = sum(p.numel() for p in gen.parameters())
    assert 25.5e6 < n < 25.7e6, n
    assert gen.upsample_factor == config["hop_size"] == 300
    assert gen.dropout_shapes(1, 3000)[-1] == (1, 10, 512)
    model = InferenceModel(config, {"params": nested(
        {k: v.numpy() for k, v in gen.state_dict().items()})}, device="cpu")
    assert model.upsample_factor == 300


# ----------------------------------------------------------------------
# the reference .pkl

@CASES
def test_pkl_both_ways_match_jax(tmp_path, case):
    """The JAX exporter's state_dict equals the port's (weight-normed,
    under the reference's Sequential indices); both importers give the
    same tree; a .pkl the port writes from its trainable module reads back
    through the JAX importer and serves through the port's load_model as
    the JAX InferenceModel does; the port's export of that tree equals the
    file bit for bit."""
    gp = _case(case)[0]
    config = {"generator_type": "UHiFiGANGenerator", "generator_params": gp,
              "sampling_rate": 24000}
    params = _np_tree(_flax(case)[1]["params"])
    state = jax_export.export_generator_state_dict(params,
                                                   "UHiFiGANGenerator", config)
    mine = torch_export.export_generator_state_dict(
        params, "UHiFiGANGenerator", config)
    assert sorted(mine) == sorted(state)
    for key in ("input_conv.0.weight_v", "hidden_conv.weight_g",
                "downsamples.3.0.bias", "upsamples.0.1.weight_v",
                "downsamples_mrf.0.convs1.1.1.weight_v",
                "upsamples_mrf.3.convs2.0.1.bias", "output_conv.1.weight_g"):
        assert key in state, key
    for key in state:
        np.testing.assert_array_equal(mine[key], state[key], err_msg=key)
    tensors = {k: torch.from_numpy(np.array(a)) for k, a in state.items()}
    got = torch_import.import_model_params(tensors, "UHiFiGANGenerator", gp)
    assert_trees_equal(got, jax_import.import_model_params(
        tensors, "UHiFiGANGenerator", gp))
    path = str(tmp_path / "checkpoint-7steps.pkl")
    torch_export.save_reference_checkpoint(
        path, nested(_port(case, fold=False).state_dict()), config, steps=7)
    back = jax_load_reference_checkpoint(path, config)
    assert back["steps"] == 7
    assert_trees_equal(back["generator"], got)
    written = torch.load(path, weights_only=True)["model"]["generator"]
    again = torch_export.export_generator_state_dict(
        back["generator"]["params"], "UHiFiGANGenerator", config)
    assert sorted(written) == sorted(again)
    for key, value in written.items():
        np.testing.assert_array_equal(value.numpy(), again[key],
                                      err_msg=key)
    model = load_model(path, config, device="cpu")
    ref = JaxInferenceModel(config, {"params": jax.tree.map(
        jnp.asarray, back["generator"]["params"])})
    c, e = _inputs(case, B=1, seed=6)
    assert_close(model.inference(c[0], excitation=e[0]),
                 ref.inference(c[0], excitation=e[0]))


# ----------------------------------------------------------------------
# serving

def _serving_pair(case, dtype):
    """(port InferenceModel on the CPU, JAX InferenceModel) of the case's
    weights in ``dtype``."""
    config = {"generator_type": "UHiFiGANGenerator",
              "generator_params": _case(case)[0]}
    v = _flax(case)[1]
    jdtype = {torch.float32: None, torch.bfloat16: jnp.bfloat16}[dtype]
    return (InferenceModel(config, _np_tree(v), dtype=dtype, device="cpu"),
            JaxInferenceModel(config, v, dtype=jdtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_inference_matches_jax(dtype):
    """InferenceModel.inference(c, f0=, excitation=) on one utterance at
    its exact length against the JAX InferenceModel's: f32 within 1e-5
    (1 + max); bf16 (c, f0 and the excitation cast to the parameters'
    dtype in both) within 2e-2 (1 + max); the excitation as (T,) or
    (frames, hop), f0 as (frames,) or (frames, 1)."""
    model, ref = _serving_pair("opencpop", dtype)
    c, e = _inputs("opencpop", B=1, seed=7)
    f0 = np.full((c.shape[1],), 200.0, np.float32)
    want = ref.inference(c[0], f0=f0, excitation=e[0, :, 0])
    got = model.inference(c[0], f0=f0[:, None],
                          excitation=e[0, :, 0].reshape(-1, 300))
    assert got.dtype == np.float32 and got.shape == (1200, 1)
    assert_close(got, want, 1e-5 if dtype == torch.float32 else 2e-2)
    with pytest.raises(ValueError, match="excitation"):
        model.inference(c[0], f0=f0)


def test_pcm16_is_ignored_on_the_single_utterance_path_as_in_jax():
    """The JAX package's single-utterance path (``_inference_special``)
    applies neither pcm16 nor normalize_before (ADVICE.md): the port's
    UHiFiGAN path keeps that behaviour, a float32 wave equal to the plain
    model's."""
    config = {"generator_type": "UHiFiGANGenerator",
              "generator_params": _case("debug")[0]}
    params = _np_tree(_flax("debug")[1])
    plain = InferenceModel(config, params, device="cpu")
    pcm = InferenceModel(config, params, pcm16=True, device="cpu")
    ref = JaxInferenceModel(config, _flax("debug")[1], pcm16=True)
    pcm.mean, pcm.scale = np.full(40, 5.0), np.full(40, 0.1)
    c, e = _inputs("debug", B=1, seed=8)
    got = pcm.inference(c[0], normalize_before=True, excitation=e[0])
    want = ref.inference(c[0], normalize_before=True, excitation=e[0])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, plain.inference(c[0], excitation=e[0]))
    assert_close(got, want)


def test_batched_and_chunked_serving_refuse_uhifigan():
    """UHiFiGAN serves one utterance a call: the bucketed batch and the
    chunked path (whose JAX list has no UHiFiGAN either) raise."""
    model, _ = _serving_pair("debug", torch.float32)
    c, _ = _inputs("debug", B=1)
    with pytest.raises(ValueError, match="one utterance"):
        model.synthesize_batch([c[0]])
    with pytest.raises(NotImplementedError, match="UHiFiGAN"):
        model.inference_chunked(c[0], chunk_frames=2, context_frames=1)


def _write_mel_dumps(root, case, n, rng, excitation_1d=False):
    """npy dumps of n utterances: -wave, -feats, -f0 (frames,) and
    -excitation ((frames, hop), or (frames hop,))."""
    gp, hop, _ = _case(case)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        frames = 9 + 3 * i
        f0 = np.where(rng.random(frames) < 0.8,
                      150 + 250 * rng.random(frames), 0.0).astype(np.float32)
        exc = sine_excitation(
            torch.from_numpy(np.repeat(f0, hop)[None, :, None]), 24000,
            generator=torch.Generator().manual_seed(i))[0][0, :, 0].numpy()
        np.save(os.path.join(root, f"utt{i}-wave.npy"),
                (0.3 * np.sin(0.05 * np.arange(frames * hop + 17))
                 ).astype(np.float32))
        np.save(os.path.join(root, f"utt{i}-feats.npy"), rng.standard_normal(
            (frames, gp["in_channels"])).astype(np.float32))
        np.save(os.path.join(root, f"utt{i}-f0.npy"), f0)
        np.save(os.path.join(root, f"utt{i}-excitation.npy"),
                exc if excitation_1d else exc.reshape(frames, hop))


def test_decode_cli_matches_the_jax_cli(tmp_path, monkeypatch):
    """bin.decode over -feats/-f0/-excitation.npy dumps: each wave is
    frames x hop samples and equals the JAX CLI's on the same .gckpt
    (16-bit, within one step); a feats.scp is refused for f0 and
    excitation."""
    from scipy.io import wavfile

    from parallelwavegan_tpu.bin import decode as jax_decode_cli

    config = {"generator_type": "UHiFiGANGenerator", "format": "npy",
              "generator_params": _case("debug")[0], "sampling_rate": 8000,
              "hop_size": 64}
    ckpt = str(tmp_path / "generator.gckpt")
    save_generator_checkpoint(ckpt, _port("debug"))
    conf = str(tmp_path / "config.json")
    with open(conf, "w") as f:
        json.dump(config, f)
    dump = str(tmp_path / "dump")
    _write_mel_dumps(dump, "debug", 3, np.random.default_rng(2))
    outs = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    decode_cli.main(["--dumpdir", dump, "--checkpoint", ckpt, "--config",
                     conf, "--outdir", outs["port"], "--device", "cpu"])
    monkeypatch.setenv("PARALLELWAVEGAN_TPU_CACHE_DIR", "")
    monkeypatch.setattr(sys, "argv", [
        "decode", "--dumpdir", dump, "--checkpoint", ckpt, "--config", conf,
        "--outdir", outs["jax"]])
    jax_decode_cli.main()
    for i in range(3):
        got, want = (wavfile.read(os.path.join(d, f"utt{i}_gen.wav"))[1]
                     for d in (outs["port"], outs["jax"]))
        assert got.shape == want.shape == ((9 + 3 * i) * 64,)
        assert np.abs(got.astype(np.int32) - want).max() <= 1
    with open(tmp_path / "feats.scp", "w") as f:
        f.write(f"utt0 {dump}/utt0-feats.npy\n")
    with pytest.raises(ValueError, match="f0 and excitation"):
        decode_cli.main(["--feats-scp", str(tmp_path / "feats.scp"),
                         "--checkpoint", ckpt, "--config", conf, "--outdir",
                         str(tmp_path / "scp"), "--device", "cpu"])


# ----------------------------------------------------------------------
# data

@pytest.mark.parametrize("kind", ["AudioMelF0Dataset",
                                  "AudioMelF0ExcitationDataset",
                                  "MelF0Dataset", "MelF0ExcitationDataset"])
def test_f0_datasets_match_jax(tmp_path, kind):
    """Items and utterance ids over npy dumps, with and without ids; the
    side inputs read by load functions of the audio (or mel) file's path,
    the short ones filtered out by the mel threshold."""
    root = str(tmp_path)
    _write_mel_dumps(root, "debug", 4, np.random.default_rng(3))
    audio = kind.startswith("Audio")
    suffix = "-wave.npy" if audio else "-feats.npy"

    def load(name):
        return lambda f: np.load(f.replace(suffix, f"-{name}.npy"))

    kw = dict(mel_query="*-feats.npy", mel_load_fn=np.load,
              f0_load_fn=load("f0"))
    if audio:
        kw.update(audio_query="*-wave.npy", audio_load_fn=np.load,
                  mel_length_threshold=12)
    if "Excitation" in kind:
        kw["excitation_load_fn"] = load("excitation")
    n = 2 if audio else 4
    for utt in (False, True):
        ours = getattr(datasets, kind)(root, return_utt_id=utt, **kw)
        ref = getattr(jax_datasets, kind)(root, return_utt_id=utt, **kw)
        assert ours.utt_ids == ref.utt_ids and len(ours) == len(ref) == n
        for i in range(n):
            got, want = ours[i], ref[i]
            assert len(got) == len(want) == 2 + utt + ("Excitation" in kind
                                                       ) + audio
            for a, b in zip(got, want):
                if isinstance(b, str):
                    assert a == b
                else:
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("excitation_1d", [False, True], ids=["2d", "1d"])
@pytest.mark.parametrize("context", [0, 2])
def test_collater_f0_and_excitation_crops_match_jax(excitation_1d, context):
    """The mel2wav batches of one seed with f0 and excitation (a
    (frames, hop) dump, or a 1-D one reshaped first), over three batches:
    f0 and the excitation cut on the frame window with its context, the
    excitation flattened; and f0 alone (use_f0)."""
    gp, hop, _ = _case("debug")
    rng = np.random.default_rng(4)
    items = []
    for i in range(4):
        frames = 20 + 5 * i
        exc = rng.standard_normal(frames * hop).astype(np.float32)
        items.append((rng.standard_normal(frames * hop - 3).astype(np.float32),
                      rng.standard_normal((frames, 40)).astype(np.float32),
                      rng.random(frames).astype(np.float32) * 300,
                      exc if excitation_1d else exc.reshape(frames, hop)))
    for flags in (dict(use_f0_and_excitation=True), dict(use_f0=True)):
        kw = dict(batch_max_steps=16 * hop + 5, hop_size=hop,
                  aux_context_window=context, **flags)
        batch = items if "use_f0_and_excitation" in flags else [
            b[:3] for b in items]
        ours = Collater(**kw, rng=np.random.default_rng(7))
        ref = JaxCollater(**kw, rng=np.random.default_rng(7))
        for _ in range(3):
            got, want = ours(batch), ref(batch)
            assert sorted(got) == sorted(want)
            for key in want:
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)
        assert got["f0"].shape[1:] == (16 + 2 * context, 1)
        if "excitation" in got:
            assert got["excitation"].shape[1:] == ((16 + 2 * context) * hop,
                                                   1)


def test_smoke_uhifigan_config_is_the_opencpop_yaml():
    """chip_smoke trains and serves the opencpop recipe at full width (the
    GPU machine has no yaml): every key says what the file says but the
    data format of a seeded npy corpus; every recipe key of the file is
    there; what the script cuts is named apart."""
    import chip_smoke

    want = _yaml(OPENCPOP_YAML)
    got = chip_smoke.UHIFIGAN_V1_TRAIN
    cuts = chip_smoke.UHIFIGAN_V1_TRAIN_CUT
    for key, value in got.items():
        if key != "format":
            assert want[key] == value, key
    recipe = [k for k in want if k.startswith((
        "generator_", "discriminator_", "lambda_", "use_", "stft_", "mel_",
        "batch_", "sampling_", "hop_", "feat_"))]
    assert not set(recipe) - set(got) - set(cuts)
    assert not set(cuts) & set(got)
    assert set(cuts) <= set(want)
    assert got["format"] == "npy"
