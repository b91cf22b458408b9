"""The port's serving path end to end on the CPU: load_model on a .gckpt
written by the JAX package, bucketed synthesize_batch against the JAX
InferenceModel on the same noise, the decode CLI, the import boundary."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from parallelwavegan_tpu.engine.checkpoint import (
    save_generator_checkpoint as jax_save_gckpt,
)
from parallelwavegan_tpu.models import (
    ParallelWaveGANGenerator as FlaxGenerator,
)
from parallelwavegan_tpu.utils.model_loader import (
    InferenceModel as JaxInferenceModel,
)
from parallelwavegan_torch import models as port_models
from parallelwavegan_torch.engine.checkpoint import (
    save_generator_checkpoint as port_save_gckpt,
)
from parallelwavegan_torch.utils import model_loader as port_loader
from parallelwavegan_torch.utils.model_loader import load_model, resolve_device
from tests.torch_helpers import flax_generator_kwargs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(fmt="npy"):
    kw = flax_generator_kwargs(layers=6, stacks=2)
    return {
        "sampling_rate": 8000, "format": fmt,
        "generator_type": "ParallelWaveGANGenerator",
        "generator_params": dict(kw, use_weight_norm=True),
    }


def _jax_checkpoint(tmp_path, config):
    g = FlaxGenerator(**config["generator_params"])
    v = g.init({"params": jax.random.key(0)}, jnp.zeros((1, 32, 1)),
               jnp.zeros((1, 12, 20)))
    rng = np.random.default_rng(0)
    # perturb: weight-norm g starts at ||v|| and biases at zero
    v = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) * (1 + 0.3 * rng.standard_normal(
            a.shape)) + 0.05 * rng.standard_normal(a.shape), a.dtype), v)
    path = str(tmp_path / "generator.gckpt")
    jax_save_gckpt(path, v)
    return path, v


def _mels(rng, lengths, A=20):
    return [rng.standard_normal((n, A)).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("normalize_before", [False, True])
def test_synthesize_batch_matches_jax_inference_model(tmp_path,
                                                      normalize_before):
    config = _config()
    path, v = _jax_checkpoint(tmp_path, config)
    rng = np.random.default_rng(1)
    stats = str(tmp_path / "stats.npy")
    np.save(stats, np.stack([rng.standard_normal(20),
                             rng.random(20) + 0.5]).astype(np.float32))
    mels = _mels(rng, [13, 9])
    ref = JaxInferenceModel(config, v)
    ref.register_stats(stats)
    fn, args, lengths = ref.prepare_batch(mels, normalize_before,
                                          bucket_size=8)
    y_ref = np.asarray(fn(*args), np.float32)

    model = load_model(path, config, stats=stats, device="cpu")
    fn_t, (c_t, z_t), lengths_t = model.prepare_batch(mels, normalize_before,
                                                      bucket_size=8)
    assert lengths_t == lengths and tuple(z_t.shape) == args[2].shape
    np.testing.assert_allclose(c_t.numpy(), np.asarray(args[1]), atol=1e-6)
    y = fn_t(c_t, torch.from_numpy(np.array(args[2]))).numpy()
    up = model.upsample_factor
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(y[i, : n * up], y_ref[i, : n * up],
                                   atol=1e-4)
    # the port's own noise: shapes and crop of synthesize_batch
    waves = model.synthesize_batch(mels, normalize_before, bucket_size=8)
    assert [w.shape for w in waves] == [(n * up, 1) for n in lengths]
    assert all(w.dtype == np.float32 for w in waves)


@pytest.mark.parametrize("setting", ["auto", True, False])
def test_inference_fused_wavenet_picks_the_path_like_jax(tmp_path,
                                                        monkeypatch, setting):
    """inference_fused_wavenet on the CPU: "auto" and false serve gen(z, c),
    true the fused forward (the stack's plain version); each against the
    JAX InferenceModel under the same config, whose Pallas stack runs in
    interpret mode as the JAX package's own CPU tests run it."""
    from parallelwavegan_tpu.ops.pallas import pwg_infer as jax_pwg

    stack = jax_pwg.wavenet_stack
    monkeypatch.setattr(jax_pwg, "wavenet_stack",
                        lambda *a, **k: stack(*a, **dict(k, interpret=True)))
    config = dict(_config(), inference_fused_wavenet=setting)
    path, v = _jax_checkpoint(tmp_path, config)
    mels = _mels(np.random.default_rng(4), [10, 7])
    ref = JaxInferenceModel(config, v)
    fn, args, lengths = ref.prepare_batch(mels, bucket_size=8)
    y_ref = np.asarray(fn(*args), np.float32)

    calls = []
    fused = port_loader.pwg_fused_forward
    monkeypatch.setattr(port_loader, "pwg_fused_forward",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    model = load_model(path, config, device="cpu")
    assert (model.stack_params is not None) == (setting is True)
    assert port_loader.fused_wavenet(config, torch.device("cpu")) == (
        setting is True)
    assert port_loader.fused_wavenet(config, torch.device("cuda")) == (
        setting is not False)
    fn_t, (c_t, _), _ = model.prepare_batch(mels, bucket_size=8)
    y = fn_t(c_t, torch.from_numpy(np.array(args[2]))).numpy()
    assert len(calls) == (1 if setting is True else 0)
    up = model.upsample_factor
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(y[i, : n * up], y_ref[i, : n * up],
                                   atol=1e-4)


def test_inference_fused_wavenet_rejects_what_the_fused_path_lacks(tmp_path):
    """true keeps the no-fallback rule on any device; false serves a
    generator the fused path lacks; other values are refused."""
    config = _config()
    config["generator_params"] = dict(config["generator_params"],
                                      kernel_size=5)
    path, _ = _jax_checkpoint(tmp_path, config)
    with pytest.raises(NotImplementedError, match="kernel_size=5"):
        load_model(path, dict(config, inference_fused_wavenet=True),
                   device="cpu")
    model = load_model(path, dict(config, inference_fused_wavenet=False),
                       device="cpu")
    assert model.stack_params is None
    wave = model.inference(_mels(np.random.default_rng(5), [6])[0])
    assert wave.shape == (6 * 4, 1) and np.isfinite(wave).all()
    with pytest.raises(ValueError, match="inference_fused_wavenet"):
        load_model(path, dict(config, inference_fused_wavenet="yes"),
                   device="cpu")


def test_pcm16_matches_jax_within_one_lsb(tmp_path):
    config = _config()
    path, v = _jax_checkpoint(tmp_path, config)
    mels = _mels(np.random.default_rng(2), [11])
    ref = JaxInferenceModel(config, v, pcm16=True)
    fn, args, _ = ref.prepare_batch(mels, bucket_size=4)
    y_ref = np.asarray(fn(*args))
    model = load_model(path, config, pcm16=True, device="cpu")
    fn_t, (c_t, _), _ = model.prepare_batch(mels, bucket_size=4)
    y = fn_t(c_t, torch.from_numpy(np.array(args[2]))).numpy()
    assert y.dtype == np.int16 and y_ref.dtype == np.int16
    assert np.abs(y.astype(np.int32) - y_ref.astype(np.int32)).max() <= 1
    wave = model.inference(mels[0])
    assert wave.dtype == np.int16 and wave.shape == (11 * 4, 1)


def test_load_model_rejects_what_the_slice_lacks(tmp_path):
    """What the port lacked before, a reference .pkl, the MelGAN family
    and the discrete-symbol families, now loads (a .pkl serves as the JAX
    load_model serves it); a family the port lacks raises
    NotImplementedError naming it."""
    from parallelwavegan_tpu.utils.model_loader import (
        load_model as jax_load_model,
    )
    from parallelwavegan_tpu.utils.torch_export import (
        save_reference_checkpoint,
    )

    config = _config()
    path, v = _jax_checkpoint(tmp_path, config)
    pkl = str(tmp_path / "checkpoint-10steps.pkl")
    save_reference_checkpoint(pkl, jax.tree.map(np.asarray, v["params"]),
                              config)
    mels = _mels(np.random.default_rng(4), [9])
    fn, args, _ = jax_load_model(pkl, config).prepare_batch(mels,
                                                            bucket_size=1)
    model = load_model(pkl, config, device="cpu")
    fn_t, (c, _), _ = model.prepare_batch(mels, bucket_size=1)
    got = fn_t(c, torch.from_numpy(np.array(args[2]))).numpy()
    want = np.asarray(fn(*args))
    assert np.abs(got - want).max() <= 1e-5 * (1 + np.abs(want).max())
    melgan = {"generator_type": "MelGANGenerator",
              "generator_params": {"in_channels": 20, "channels": 16,
                                   "upsample_scales": [2, 2], "stacks": 1}}
    gen = port_models.MelGANGenerator(**melgan["generator_params"])
    gpath = str(tmp_path / "melgan.gckpt")
    port_save_gckpt(gpath, gen)
    assert load_model(gpath, melgan, device="cpu").inference(
        mels[0]).shape == (9 * 4, 1)
    # the discrete-symbol families load as the JAX load_model loads them
    from parallelwavegan_tpu.models.discrete import (
        DiscreteSymbolHiFiGANGenerator,
    )

    gp = {"in_channels": 8, "channels": 16, "num_embs": 10,
          "num_spk_embs": 2, "spk_emb_dim": 8, "upsample_scales": (2, 2),
          "upsample_kernel_sizes": (4, 4), "resblock_kernel_sizes": (3,),
          "resblock_dilations": ((1,),)}
    token = {"generator_type": "DiscreteSymbolHiFiGANGenerator",
             "generator_params": gp}
    ids = np.array([[1, 0], [3, 0], [9, 1], [9, 1]])
    tv = DiscreteSymbolHiFiGANGenerator(**gp).init(jax.random.key(0),
                                                   ids[None])
    tpkl = str(tmp_path / "checkpoint-1steps.pkl")
    save_reference_checkpoint(tpkl, jax.tree.map(np.asarray, tv["params"]),
                              token)
    want = jax_load_model(tpkl, token).inference(ids.astype(np.float32))
    got = load_model(tpkl, token, device="cpu").inference(ids)
    assert got.shape == want.shape == (4 * 4, 1)
    assert np.abs(got - want).max() <= 1e-5 * (1 + np.abs(want).max())
    # a family the port lacks raises, naming it
    with pytest.raises(NotImplementedError, match="NoSuchGenerator"):
        load_model(path, dict(config, generator_type="NoSuchGenerator"),
                   device="cpu")


def test_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_decode_cli_writes_wavs(tmp_path):
    import yaml

    config = _config()
    path, _ = _jax_checkpoint(tmp_path, config)
    with open(tmp_path / "config.yml", "w") as f:
        yaml.safe_dump(config, f)
    dump = tmp_path / "dump"
    dump.mkdir()
    rng = np.random.default_rng(3)
    frames = {"utt1": 10, "utt2": 7}
    for utt, n in frames.items():
        np.save(dump / f"{utt}-feats.npy", _mels(rng, [n])[0])
    out = tmp_path / "wav"
    from parallelwavegan_torch.bin.decode import main

    main(["--dumpdir", str(dump), "--checkpoint", path, "--outdir", str(out),
          "--device", "cpu", "--batch-size", "2"])
    for utt, n in frames.items():
        sr, wave = wavfile.read(out / f"{utt}_gen.wav")
        assert sr == 8000 and wave.dtype == np.int16
        assert wave.shape == (n * 4,)


def test_port_imports_no_jax():
    """Every module of the port (the training modules included),
    chip_smoke.py and op_census_on_card.py beside it, imported in a fresh
    interpreter, load no jax, flax,
    optax or parallelwavegan_tpu module, and neither yaml nor h5py (the
    GPU machine has neither)."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import parallelwavegan_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke, op_census_on_card\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'parallelwavegan_tpu', "
        "'yaml', 'h5py')]\n"
        "assert not bad, bad\n"
        "want = ['bin.train', 'datasets.collater', 'datasets.loader', "
        "'engine.build', 'engine.criterion', 'engine.state', 'engine.step', "
        "'engine.trainer', 'losses.adversarial', 'losses.stft_loss', "
        "'ops.spectral', 'ops.cuda.wavenet_stack_train', 'optimizers', "
        "'models.hifigan', 'ops.hifigan_infer', 'ops.cuda.mrf_stage', "
        "'ops.cuda.matmul_bench', 'ops.eval_metrics', 'ops.audio', "
        "'tools.int8_stage_roofline', 'tools.int8_wavenet_experiment', "
        "'ops.cuda.wavenet_variant', 'ops.mel', 'losses.mel_loss', "
        "'losses.feat_match', 'tools.wavenet_stack_ablation', "
        "'tools.mrf_stage_ablation', 'ops.pqmf', 'layers.pqmf', "
        "'layers.causal_conv', 'layers.residual_stack', 'models.melgan', "
        "'utils.torch_import', 'utils.torch_export', 'utils.kaldiio_lite', "
        "'datasets.scp_dataset', 'layers.tade', 'models.style_melgan', "
        "'layers.vq', 'models.vqvae', 'ops.sine', 'models.uhifigan', "
        "'datasets.audio_mel_dataset', 'bin.decode', 'layers.duration', "
        "'losses.duration', 'models.discrete', 'bin.decode_from_text', "
        "'parallel.dist', 'distributed.launch', 'tools.dp_emulation', "
        "'utils.yaml_lite', 'utils.hdf5_lite', 'bin.preprocess', "
        "'bin.compute_statistics', 'bin.normalize', 'bin.preprocess_tokens', "
        "'bin.evaluate_mcd', 'bin.evaluate_f0', 'bin.convert_checkpoint', "
        "'datasets.native_loader', 'utils.export', 'utils.pretrained', "
        "'bin.run_stages', 'tools.op_census']\n"
        "missing = [w for w in want if 'parallelwavegan_torch.' + w "
        "not in names]\n"
        "assert not missing, missing\n"
        "assert len(names) >= 60, names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

