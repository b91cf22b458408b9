"""StyleMelGAN serving in the port against the JAX package on the CPU:
nearest-neighbour upsampling, instance norm, the TADE layer and residual
block (both gates), the generator on 1 and 3 noise frames (folded,
trainable, bf16), the random-window discriminator on the same window
starts, the weight transfer of both, ``InferenceModel`` batched serving
and chunked decode on the same noise, ``bin.decode``, and the reference
``.pkl`` both ways against the JAX importer and exporter."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallelwavegan_tpu.utils.model_loader as jax_model_loader
from parallelwavegan_tpu.engine.checkpoint import (
    load_reference_checkpoint as jax_load_reference_checkpoint,
)
from parallelwavegan_tpu.layers.common import (
    instance_norm_1d as jax_instance_norm_1d,
)
from parallelwavegan_tpu.layers.tade import TADELayer as FlaxTADELayer
from parallelwavegan_tpu.layers.tade import TADEResBlock as FlaxTADEResBlock
from parallelwavegan_tpu.models import get_model_class as jax_model_class
from parallelwavegan_tpu.ops.conv import (
    upsample_nearest_time as jax_upsample_nearest_time,
)
from parallelwavegan_tpu.utils import torch_export as jax_export
from parallelwavegan_tpu.utils import torch_import as jax_import
from parallelwavegan_tpu.utils.model_loader import (
    InferenceModel as JaxInferenceModel,
)
from parallelwavegan_torch.engine.checkpoint import load_reference_checkpoint
from parallelwavegan_torch.layers.common import instance_norm_1d
from parallelwavegan_torch.layers.tade import TADELayer, TADEResBlock
from parallelwavegan_torch.models import get_model_class
from parallelwavegan_torch.ops.conv import upsample_nearest_time
from parallelwavegan_torch.utils import torch_export, torch_import
from parallelwavegan_torch.utils.model_loader import (
    InferenceModel,
    load_model,
)
from parallelwavegan_torch.utils.params import convert_jax_params, nested
from tests.test_torch_reference_pkl import (
    _melgan_msd_name,
    assert_trees_equal,
    reference_state_dict,
)
from tests.torch_helpers import JaxDraws, melgan_perturbed, perturbed

torch.set_num_threads(2)

FOLD = pytest.mark.parametrize("fold", [True, False],
                               ids=["folded", "trainable"])
# tests/test_inference.py's chunked-synthesis generator (noise grid 16
# frames, hop 64) and tests/test_model_parity.py's (grid 8, hop 4)
GEN = dict(in_channels=16, aux_channels=16, channels=16, kernel_size=9,
           dilation=2, noise_upsample_scales=(4, 2, 2),
           upsample_scales=(2, 2, 2, 2, 2, 2, 1))
GEN_PARITY = dict(in_channels=32, aux_channels=20, channels=16,
                  noise_upsample_scales=(4, 2), upsample_scales=(2, 2, 1))
CONFIG = {"generator_type": "StyleMelGANGenerator",
          "generator_params": dict(GEN, use_weight_norm=True),
          "hop_size": 64}
DIS = dict(repeats=2, window_sizes=(128, 256, 512, 1024),
           discriminator_params=dict(channels=8, max_downsample_channels=32,
                                     downsample_scales=(4, 1)))


def assert_close(got, want, tol=1e-5):
    """|got - want| <= tol (1 + max |want|), on outputs of order one."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.02
    err = np.abs(got - want).max()
    assert err <= tol * (1 + np.abs(want).max()), err


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _flax_generator(kw, frames, seed=0):
    """(flax module, perturbed variables) of a StyleMelGAN generator. The
    perturbation is ``torch_helpers.perturbed``'s, 20 % of each leaf: with
    MelGAN's (every weight-norm g near 1) the deep generator's outputs
    lie 2e-5 to 4e-5 from its float64 forward in either package's f32,
    past what a 1e-5 comparison of the two can hold."""
    module = jax_model_class("StyleMelGANGenerator")(**kw)
    c = jnp.zeros((1, frames, kw["aux_channels"]))
    z = jnp.zeros((1, 1, kw["in_channels"]))
    v = module.init(jax.random.key(seed), c, z)
    return module, jax.tree.map(np.asarray, perturbed(
        v, np.random.default_rng(seed)))


def _port(name, kw, params, fold=True, dtype=torch.float32):
    module = get_model_class(name)(**kw, folded=fold)
    module.load_state_dict(convert_jax_params(params, fold=fold),
                           strict=True)
    return module.to(dtype)


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_upsample_nearest_time_matches_jax(scale):
    x = _rand((2, 7, 5), 0)
    got = upsample_nearest_time(torch.from_numpy(x), scale).numpy()
    want = np.asarray(jax_upsample_nearest_time(jnp.asarray(x), scale))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_matches_jax(dtype):
    """Over T with the biased variance and eps 1e-5; a bf16 input's
    statistics in f32 (jnp.mean accumulates bf16 in f32)."""
    x = _rand((2, 37, 6), 1) * 3 + 1
    tol = 1e-5 if dtype == "float32" else 2e-2
    got = instance_norm_1d(torch.from_numpy(x).to(getattr(torch, dtype)))
    want = jax_instance_norm_1d(jnp.asarray(x, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert_close(got.float().numpy(), np.asarray(want, np.float32), tol)
    np.testing.assert_allclose(got.float().mean(1).numpy(), 0, atol=tol)


@FOLD
@pytest.mark.parametrize("up", [1, 2])
def test_tade_layer_matches_flax(up, fold):
    """y and the conditioning it passes on, to 1e-5 (1 + max)."""
    x, c = _rand((2, 12, 8), 2), _rand((2, 12, 5), 3)
    module = FlaxTADELayer(in_channels=8, aux_channels=5, kernel_size=5,
                           upsample_factor=up)
    v = jax.tree.map(np.asarray, melgan_perturbed(module.init(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(c))))
    y_ref, c_ref = module.apply(v, jnp.asarray(x), jnp.asarray(c))
    port = TADELayer(8, 5, 5, upsample_factor=up, use_weight_norm=not fold)
    port.load_state_dict(convert_jax_params(v["params"], fold=fold),
                         strict=True)
    y, c_out = port(torch.from_numpy(x), torch.from_numpy(c))
    assert y.shape == (2, 12 * up, 8) and c_out.shape == (2, 12 * up, 8)
    assert_close(y.detach().numpy(), y_ref)
    assert_close(c_out.detach().numpy(), c_ref)


@FOLD
@pytest.mark.parametrize("gate", ["softmax", "sigmoid"])
def test_tade_res_block_matches_flax(gate, fold):
    """Both gates, upsampling by 2; in the training form also the
    gradients of a weighted sum of both outputs on every parameter."""
    x, c = _rand((2, 10, 8), 4), _rand((2, 10, 6), 5)
    kw = dict(in_channels=8, aux_channels=6, kernel_size=5, dilation=2,
              upsample_factor=2, gated_function=gate)
    module = FlaxTADEResBlock(**kw)
    v = jax.tree.map(np.asarray, melgan_perturbed(module.init(
        jax.random.key(1), jnp.asarray(x), jnp.asarray(c))))
    y_ref, c_ref = module.apply(v, jnp.asarray(x), jnp.asarray(c))
    port = TADEResBlock(**kw, use_weight_norm=not fold)
    port.load_state_dict(convert_jax_params(v["params"], fold=fold),
                         strict=True)
    y, c_out = port(torch.from_numpy(x), torch.from_numpy(c))
    assert_close(y.detach().numpy(), y_ref)
    assert_close(c_out.detach().numpy(), c_ref)
    if fold:
        return
    wy, wc = _rand(y.shape, 6), _rand(c_out.shape, 7)

    def loss_fn(params):
        a, b = module.apply({"params": params}, jnp.asarray(x),
                            jnp.asarray(c))
        return jnp.sum(wy * a) + jnp.sum(wc * b)

    want = convert_jax_params(jax.tree.map(
        np.asarray, jax.grad(loss_fn)(v["params"])), fold=False)
    loss = (torch.from_numpy(wy) * y).sum() + (torch.from_numpy(wc)
                                                * c_out).sum()
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        b = want[name].numpy()
        assert np.abs(g.numpy() - b).max() <= 1e-5 * (1 + np.abs(b).max()), \
            name


def test_tade_res_block_refuses_another_gate():
    with pytest.raises(ValueError, match="tanh"):
        TADEResBlock(gated_function="tanh")


@FOLD
@pytest.mark.parametrize("noise_frames", [1, 3])
def test_generator_matches_flax(noise_frames, fold):
    """tests/test_model_parity.py's generator (noise grid 8 frames) on a
    mel one frame short of the grid, which both edge-pad to it."""
    module, v = _flax_generator(GEN_PARITY, 8)
    frames = noise_frames * 8 - 1
    c = _rand((2, frames, 20), 8)
    z = _rand((2, noise_frames, 32), 9)
    want = module.apply(v, jnp.asarray(c), jnp.asarray(z))
    port = _port("StyleMelGANGenerator", GEN_PARITY, v["params"], fold)
    assert port.noise_frames(frames) == noise_frames
    got = port(torch.from_numpy(c), torch.from_numpy(z))
    assert got.shape == (2, noise_frames * 8 * 4, 1)
    assert_close(got.detach().numpy(), want)


def test_generator_bf16_matches_flax_bf16():
    """Both packages' bf16 forwards on the same bf16 weights, to 2e-2."""
    module, v = _flax_generator(GEN, 16)
    c, z = _rand((2, 30, 16), 10), _rand((2, 2, 16), 11)
    v16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
    want = module.apply(v16, jnp.asarray(c, jnp.bfloat16),
                        jnp.asarray(z, jnp.bfloat16))
    port = _port("StyleMelGANGenerator", GEN, v["params"],
                 dtype=torch.bfloat16)
    got = port(torch.from_numpy(c).bfloat16(), torch.from_numpy(z))
    assert got.dtype == torch.bfloat16
    assert_close(got.detach().float().numpy(), np.asarray(want, np.float32),
                 2e-2)


def test_generator_inference_and_options_follow_jax():
    """``inference`` edge-pads to the noise grid and crops to T' x hop as
    the JAX module's; the noise is drawn when z is None; upsample modes
    other than nearest raise (the JAX module would upsample by nearest
    neighbour anyway)."""
    module, v = _flax_generator(GEN, 16)
    port = _port("StyleMelGANGenerator", GEN, v["params"])
    c = _rand((21, 16), 12)
    z = _rand((1, 2, 16), 13)
    got = port.inference(torch.from_numpy(c), torch.from_numpy(z))
    want = module.apply(v, jnp.pad(jnp.asarray(c)[None], ((0, 0), (0, 11),
                                                           (0, 0)),
                                   mode="edge"), jnp.asarray(z))[0, :21 * 64]
    assert got.shape == (21 * 64, 1)
    assert_close(got.detach().numpy(), want)
    g1 = port(torch.from_numpy(c[None]),
              generator=torch.Generator().manual_seed(3))
    g2 = port(torch.from_numpy(c[None]), port.draw_noise(
        1, 21, torch.Generator().manual_seed(3)))
    assert torch.equal(g1, g2) and g1.shape == (1, 2 * 16 * 64, 1)
    with pytest.raises(NotImplementedError, match="linear"):
        get_model_class("StyleMelGANGenerator")(**GEN, upsample_mode="linear")


def _flax_discriminator(T=1100):
    module = jax_model_class("StyleMelGANDiscriminator")(**DIS)
    x = _rand((2, T, 1), 14)
    starts = [5, 100, 300, 70, 0, 844, 588, 76]
    v = module.init(jax.random.key(0), jnp.asarray(x), window_starts=starts)
    return module, jax.tree.map(np.asarray, melgan_perturbed(v)), x, starts


def _leaves(outs):
    if isinstance(outs, (list, tuple)):
        return [t for o in outs for t in _leaves(o)]
    return [outs]


@FOLD
def test_discriminator_matches_flax(fold):
    """Every feature map of the 8 windows (1, 2, 4 and 8 subbands through
    PQMF) on the same window starts, to 1e-5 (1 + max); in the training
    form also every parameter's gradient of a weighted sum of them."""
    module, v, x, starts = _flax_discriminator()
    want = module.apply(v, jnp.asarray(x), window_starts=starts)
    port = _port("StyleMelGANDiscriminator", DIS, v["params"], fold)
    got = port(torch.from_numpy(x), starts)
    assert len(got) == len(want) == 8
    assert got[3][0].shape[-1] == 8 and got[1][0].shape[-1] == 8
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.detach().numpy() - b).max() <= 1e-5 * (
            1 + np.abs(b).max())
    if fold:
        return
    weights = [_rand(np.shape(t), 20 + i) for i, t in enumerate(_leaves(want))]

    def loss_fn(params):
        outs = module.apply({"params": params}, jnp.asarray(x),
                            window_starts=starts)
        return sum(jnp.sum(w * t) for w, t in zip(weights, _leaves(outs)))

    grads_ref = convert_jax_params(jax.tree.map(
        np.asarray, jax.grad(loss_fn)(v["params"])), fold=False)
    loss = sum((torch.from_numpy(w) * t).sum()
               for w, t in zip(weights, _leaves(got)))
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    assert sorted(names) == sorted(grads_ref)
    for name, g in zip(names, grads):
        b = grads_ref[name].numpy()
        assert np.abs(g.numpy() - b).max() <= 1e-5 * (1 + np.abs(b).max()), \
            name


def test_window_starts_are_drawn_as_jax_draws_them():
    """One start per (repeat, window) in the order r * 4 + idx, uniform in
    [0, T - ws) as jax.random.randint(0, T - ws), 0 where T == ws; a
    signal shorter than a window raises; a given list is checked."""
    port = get_model_class("StyleMelGANDiscriminator")(**DIS)
    starts = port.draw_window_starts(1100, torch.Generator().manual_seed(0))
    assert len(starts) == 8
    for i, s in enumerate(starts):
        assert 0 <= s < 1100 - DIS["window_sizes"][i % 4]
    many = np.array([port.draw_window_starts(
        1100, torch.Generator().manual_seed(k)) for k in range(200)])
    assert many[:, 0].max() > 900 and many[:, 3].max() < 76
    jax_draws = [int(jax.random.randint(jax.random.key(k), (), 0, 0))
                 for k in range(3)]
    assert port.draw_window_starts(1024)[3::4] == [0, 0] and jax_draws == [
        0, 0, 0]
    with pytest.raises(ValueError, match="shorter"):
        port.draw_window_starts(1000)
    with pytest.raises(ValueError, match="8 window starts"):
        port(torch.zeros((1, 1100, 1)), [0] * 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_serving_matches_jax(dtype):
    """prepare_batch pads as the JAX package (bucket with edge frames, then
    the noise grid) and draws z of shape (B, ceil(bucket / 16), 16); on the
    JAX prepare_batch's fn and args with the test's z, the port gives the
    JAX waveform, cropped to each utterance's length."""
    module, v = _flax_generator(GEN, 16)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = getattr(torch, dtype)
    ref = JaxInferenceModel(CONFIG, v, dtype=jdt)
    model = InferenceModel(CONFIG, v, dtype=tdt, device="cpu")
    mels = [_rand((n, 16), 30 + n) for n in (40, 70, 33)]
    fn, args, lengths = ref.prepare_batch(mels)
    fn_t, (c, z), lengths_t = model.prepare_batch(mels)
    assert lengths == lengths_t
    np.testing.assert_array_equal(c.float().numpy(),
                                  np.asarray(args[1], np.float32))
    assert tuple(z.shape) == np.shape(args[2]) == (3, 8, 16)
    assert z.dtype == tdt
    zz = _rand(z.shape, 40)
    want = np.asarray(fn(args[0], args[1], jnp.asarray(zz, jdt)), np.float32)
    got = fn_t(c, torch.from_numpy(zz).to(tdt)).float().numpy()
    assert_close(got, want, 1e-5 if dtype == "float32" else 2e-2)
    waves = model.synthesize_batch(mels)
    assert [w.shape for w in waves] == [(n * 64, 1) for n in (40, 70, 33)]


@pytest.mark.parametrize("T", [700, 33])
def test_chunked_decode_matches_jax_chunks(monkeypatch, T):
    """inference_chunked on the noise grid (chunk 64 -> 64, context 20 ->
    32 frames): the same noise draw covering the utterance (the port's,
    from a generator seeded 7, handed to the JAX package through its
    jax.random.normal) gives the JAX chunks to 1e-5 (1 + max); the
    window-local instance norms keep them near, not equal to, the whole
    forward; one window equals the whole forward."""
    module, v = _flax_generator(GEN, 16)
    ref = JaxInferenceModel(CONFIG, v)
    model = InferenceModel(CONFIG, v, device="cpu")
    mel = _rand((T, 16), 50)
    z = torch.randn((1, -(-T // 16), 16),
                    generator=torch.Generator().manual_seed(7)).numpy()
    monkeypatch.setattr(jax_model_loader, "jax", JaxDraws(normals=[z]))
    want = ref.inference_chunked(mel, chunk_frames=64, context_frames=20)
    got = model.inference_chunked(mel, chunk_frames=64, context_frames=20,
                                  generator=torch.Generator().manual_seed(7))
    assert got.shape == want.shape == (T * 64, 1)
    assert_close(got, want)
    whole = model.inference(mel, generator=torch.Generator().manual_seed(7))
    diff = np.abs(got - whole).max()
    if T == 33:
        assert diff == 0
    else:
        assert 0 < diff < 0.5 * np.abs(whole).max()
    default = model.inference_chunked(mel, chunk_frames=64,
                                      context_frames=20)
    assert np.array_equal(default, model.inference_chunked(
        mel, chunk_frames=64, context_frames=20,
        generator=torch.Generator().manual_seed(0)))


def test_decode_cli_serves_style_melgan(tmp_path):
    """bin.decode from an npy dump dir, bucketed and chunked, equals
    synthesize_batch / inference_chunked on the default seed-0 noise."""
    from parallelwavegan_torch.bin import decode
    from parallelwavegan_torch.engine.checkpoint import (
        save_generator_checkpoint,
    )
    from scipy.io import wavfile

    _, v = _flax_generator(GEN, 16)
    model = InferenceModel(CONFIG, v, device="cpu")
    ckpt = str(tmp_path / "generator.gckpt")
    save_generator_checkpoint(ckpt, model.generator)
    conf = str(tmp_path / "config.json")
    with open(conf, "w") as f:
        json.dump(dict(CONFIG, format="npy", sampling_rate=16000), f)
    dump = tmp_path / "dump"
    dump.mkdir()
    mels = {"a": _rand((20, 16), 60), "b": _rand((45, 16), 61)}
    for name, mel in mels.items():
        np.save(dump / f"{name}-feats.npy", mel)
    for extra, want_fn in (
            ([], lambda m: model.synthesize_batch([m])[0]),
            (["--chunk-frames", "16"],
             lambda m: model.inference_chunked(m, chunk_frames=16))):
        out = tmp_path / f"out{len(extra)}"
        decode.main(["--dumpdir", str(dump), "--checkpoint", ckpt,
                     "--config", conf, "--outdir", str(out), "--device",
                     "cpu", "--batch-size", "1", *extra])
        for name, mel in mels.items():
            _, got = wavfile.read(os.path.join(out, f"{name}_gen.wav"))
            want = want_fn(mel)[:, 0]
            assert got.shape == want.shape == (len(mel) * 64,)
            want16 = (np.clip(want, -1, 1) * 32767).astype(np.int16)
            assert np.abs(got.astype(np.int32) - want16).max() <= 1


def _style_names(path):
    """The reference's name of a StyleMelGAN discriminator's conv."""
    return _melgan_msd_name(len(DIS["discriminator_params"][
        "downsample_scales"]) + 2)(path)


def test_pkl_import_and_export_match_jax(tmp_path):
    """The generator's reference state_dict from the JAX exporter equals
    the port's exporter's; both importers give the same trees for it and
    for a reference-named discriminator; the .pkl serves through the
    port's load_model as through the JAX one; a port-written .pkl reads
    back through the JAX importer exactly."""
    _, v = _flax_generator(GEN, 16)
    params = v["params"]
    state = jax_export.export_generator_state_dict(
        params, "StyleMelGANGenerator", CONFIG)
    mine = torch_export.export_generator_state_dict(
        params, "StyleMelGANGenerator", CONFIG)
    assert sorted(mine) == sorted(state)
    assert "noise_upsample.2.weight_g" in state
    assert "blocks.6.tade2.gated_conv.0.weight_v" in state
    for key in state:
        np.testing.assert_array_equal(mine[key], state[key], err_msg=key)
    tensors = {k: torch.from_numpy(np.array(a)) for k, a in state.items()}
    got = torch_import.import_model_params(tensors, "StyleMelGANGenerator",
                                           CONFIG["generator_params"])
    assert_trees_equal(got, jax_import.import_model_params(
        tensors, "StyleMelGANGenerator", CONFIG["generator_params"]))
    assert_trees_equal(got["params"], params)

    dmod, dv, x, starts = _flax_discriminator()
    config = dict(CONFIG, discriminator_type="StyleMelGANDiscriminator",
                  discriminator_params=DIS)
    path = str(tmp_path / "checkpoint-9steps.pkl")
    jax_export.save_reference_checkpoint(path, params, config, steps=9)
    pkl = torch.load(path, weights_only=True)
    pkl["model"]["discriminator"] = reference_state_dict(dv, _style_names)
    torch.save(pkl, path)
    tree = load_reference_checkpoint(path, config)
    assert tree["steps"] == 9
    assert_trees_equal(tree["discriminator"], jax_import.import_model_params(
        pkl["model"]["discriminator"], "StyleMelGANDiscriminator", DIS))
    assert_trees_equal(tree["discriminator"]["params"], dv["params"])
    port_d = _port("StyleMelGANDiscriminator", DIS,
                   tree["discriminator"]["params"], fold=False)
    want = dmod.apply(dv, jnp.asarray(x), window_starts=starts)
    for a, b in zip(_leaves(port_d(torch.from_numpy(x), starts)),
                    _leaves(want), strict=True):
        assert_close(a.detach().numpy(), b)

    ref = jax_model_loader.load_model(path, config)
    model = load_model(path, config, device="cpu")
    mel = _rand((21, 16), 70)
    fn, args, _ = ref.prepare_batch([mel], bucket_size=1)
    fn_t, (c, _), _ = model.prepare_batch([mel], bucket_size=1)
    zz = torch.from_numpy(np.array(args[2]))
    assert_close(fn_t(c, zz).numpy(), fn(*args))

    trainable = _port("StyleMelGANGenerator", GEN, params, fold=False)
    out = str(tmp_path / "port-checkpoint-1steps.pkl")
    torch_export.save_reference_checkpoint(
        out, nested(trainable.state_dict()), config, steps=1)
    back = jax_load_reference_checkpoint(out, config)
    assert_trees_equal(back["generator"]["params"], params)
