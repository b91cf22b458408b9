"""The HiFi-GAN serving slice as a whole on the CPU: the shipped trained
checkpoint (assets/quality/) through the JAX InferenceModel and the port's
on a 40-frame cut, the decode CLI with and without --int8, the serving
modes of InferenceModel, the evaluation metrics, the matmul bench's plain
version, and the files the GPU smoke test reads."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

import chip_smoke
from parallelwavegan_tpu.engine.checkpoint import (
    load_generator_checkpoint as jax_load_gckpt,
)
from parallelwavegan_tpu.ops import eval_metrics as jax_metrics
from parallelwavegan_tpu.ops.audio import yin_f0 as jax_yin_f0
from parallelwavegan_tpu.utils.io import read_wav as jax_read_wav
from parallelwavegan_tpu.utils.model_loader import (
    InferenceModel as JaxInferenceModel,
)
from parallelwavegan_torch.bin.decode import main as decode_main
from parallelwavegan_torch.ops import eval_metrics, hifigan_infer
from parallelwavegan_torch.ops.audio import yin_f0
from parallelwavegan_torch.ops.cuda.matmul_bench import (
    MRF_SHAPES,
    matmul_bench,
    matmul_bench_reference,
)
from parallelwavegan_torch.utils.io import read_wav
from parallelwavegan_torch.utils.model_loader import load_model

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "quality")
CKPT = os.path.join(ASSETS, "generator.gckpt")


def asset_config():
    with open(os.path.join(ASSETS, "config.yml")) as f:
        return yaml.safe_load(f)


def asset_mel(utt=0, start=100, frames=40):
    return np.load(os.path.join(ASSETS, f"eval_utt{utt}-feats.npy"))[
        start: start + frames]


@pytest.fixture(scope="module")
def asset_model():
    return load_model(CKPT, device="cpu")


def test_smoke_config_is_the_assets_config():
    """chip_smoke.py carries the generator's parameters as a dict (the GPU
    machine has no yaml); it must say what assets/quality/config.yml says."""
    config = asset_config()
    for key in ("sampling_rate", "hop_size", "num_mels", "generator_type"):
        assert chip_smoke.HIFIGAN_V1[key] == config[key], key
    assert chip_smoke.HIFIGAN_V1["generator_params"] == \
        config["generator_params"]
    # the training recipe: every key but the data format (a seeded npy
    # corpus) says what the file says; the file's other keys are the
    # corpus, the run's length and intervals (which the script cuts and
    # names in HIFIGAN_V1_TRAIN_CUT), feature extraction and bookkeeping
    train = chip_smoke.HIFIGAN_V1_TRAIN
    for key, value in train.items():
        if key != "format":
            assert config[key] == value, key
    assert train["format"] == "npy"
    recipe = [k for k in config if k.startswith((
        "generator_", "discriminator_", "lambda_", "use_", "mel_loss",
        "feat_match", "batch_", "mixed_", "fuse_"))]
    assert sorted(set(recipe) - set(train)) == ["use_f0"]
    assert not set(chip_smoke.HIFIGAN_V1_TRAIN_CUT) & set(train)
    assert set(chip_smoke.HIFIGAN_V1_TRAIN_CUT) <= set(config)


def test_shipped_asset_matches_jax_on_a_40_frame_cut(asset_model):
    """The whole slice: bf16-stored weights folded in bf16 as the JAX
    package folds them, cast to f32, full width. Waveform in [-1, 1]; f32
    convs sum in another order through stages whose activations reach 1e8,
    so the waveform is held to 2e-4."""
    mel = asset_mel()
    ref = JaxInferenceModel(asset_config(), jax_load_gckpt(CKPT))
    want = ref.synthesize_batch([mel], bucket_size=1)[0]
    got = asset_model.synthesize_batch([mel], bucket_size=1)[0]
    assert got.shape == want.shape == (40 * 256, 1)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=2e-4)
    # the same through inference(), and bucketed with a second utterance
    np.testing.assert_array_equal(asset_model.inference(mel), got)
    both = asset_model.synthesize_batch([mel, mel[:25]], bucket_size=8)
    assert [w.shape for w in both] == [(40 * 256, 1), (25 * 256, 1)]
    np.testing.assert_allclose(both[0], got, atol=1e-5)


def test_serving_modes_on_the_asset(asset_model):
    """quantize_int8 and use_mrf_kernel on trained weights. The fused
    stage multiplies by 1/sx where the conv chain divides by sx: with the
    chain's rounding swapped for the stage's the two are bit-equal, which
    shows that rounding borders are all that separates them; as they are,
    they differ by a small part of the int8 mode's own error."""
    mel = asset_mel(1, 50, 24)
    model = load_model(CKPT, device="cpu")
    exact = model.inference(mel)
    np.testing.assert_allclose(
        exact, asset_model.synthesize_batch([mel], bucket_size=1)[0],
        atol=1e-6)
    model.use_mrf_kernel(quant=False)
    np.testing.assert_allclose(model.inference(mel), exact, atol=1e-5)
    model.use_mrf_kernel(quant=False, stages=[0, 3])
    assert sorted(model._mrf_packs) == [0, 3]
    np.testing.assert_allclose(model.inference(mel), exact, atol=1e-5)
    model.use_mrf_kernel(quant=True, calib_mels=[mel])
    fused = model.inference(mel)
    chain = load_model(CKPT, device="cpu")
    chain.quantize_int8([mel], schedule="all")
    assert len(chain._int8_scales) == 4 + 72
    chain._int8_scales = {k: v for k, v in chain._int8_scales.items()
                          if not k.endswith("_up")}
    y_chain = chain.inference(mel)
    noise = np.abs(y_chain - exact).mean()
    assert 0 < noise < 0.01
    assert np.abs(fused - y_chain).mean() < 0.1 * noise
    original = hifigan_infer._quant_x
    hifigan_infer._quant_x = lambda x, s: torch.clamp(
        torch.round(x * (1.0 / s)), -127, 127).to(torch.int8)
    try:
        np.testing.assert_array_equal(chain.inference(mel), fused)
    finally:
        hifigan_infer._quant_x = original
    with pytest.raises(ValueError, match="calib_mels"):
        model.use_mrf_kernel(quant=True)


def test_int8_schedules_match_jax_on_the_asset():
    """quantize_int8 through both InferenceModels, schedule auto: the same
    key set and scales to f32 rounding. One trained conv gives the same
    integers in both packages, and on a small generator the whole chains
    agree to 2e-6 (test_torch_hifigan_infer.py). Through 40 quantised convs
    of the trained model they cannot: a chain of quantisers turns a
    perturbation of delta into sparse errors of a whole step (energy
    delta * step instead of delta^2), so f32 rounding differences between
    the frameworks grow, layer by layer, to a fraction of the
    quantisation error itself. Held: the two decodes are as far from the
    exact one as each other, and closer to each other than to it."""
    mel = asset_mel(2, 30, 16)
    ref = JaxInferenceModel(asset_config(), jax_load_gckpt(CKPT))
    ref.quantize_int8([mel])
    model = load_model(CKPT, device="cpu")
    exact = model.inference(mel)
    model.quantize_int8([mel])
    assert sorted(model._int8_scales) == sorted(ref._int8_scales)
    assert len(model._int8_scales) == 4 + 2 * 18
    for key, want in ref._int8_scales.items():
        np.testing.assert_allclose(model._int8_scales[key], want, rtol=1e-4,
                                   err_msg=key)
    want = ref.synthesize_batch([mel], bucket_size=1)[0]
    got = model.inference(mel)
    noise = np.abs(want - exact).mean()
    assert 0 < noise < 0.01
    assert np.abs(got - exact).mean() == pytest.approx(noise, rel=0.25)
    assert np.abs(got - want).mean() < 0.6 * noise


def test_int8_refusals(tmp_path):
    from parallelwavegan_torch.engine.checkpoint import (
        save_generator_checkpoint,
    )
    from parallelwavegan_torch.models import ParallelWaveGANGenerator
    from tests.torch_helpers import flax_generator_kwargs

    kw = flax_generator_kwargs(layers=4, stacks=2)
    path = str(tmp_path / "pwg.gckpt")
    save_generator_checkpoint(path, ParallelWaveGANGenerator(**kw))
    pwg = load_model(path, {"generator_type": "ParallelWaveGANGenerator",
                            "generator_params": kw}, device="cpu")
    with pytest.raises(ValueError, match="HiFiGANGenerator, not Parallel"):
        pwg.quantize_int8([np.zeros((4, 20), np.float32)])
    with pytest.raises(ValueError, match="HiFiGANGenerator, not Parallel"):
        pwg.use_mrf_kernel(quant=False)
    # multi-band HiFi-GAN serves with PQMF synthesis, as the JAX exact
    # forward does; the int8 and fused-stage modes refuse it
    from parallelwavegan_tpu.engine.checkpoint import (
        save_generator_checkpoint as jax_save_gckpt,
    )
    from parallelwavegan_tpu.models import HiFiGANGenerator as FlaxHiFiGAN
    from tests.torch_helpers import melgan_perturbed

    gp = dict(in_channels=12, out_channels=4, channels=32,
              upsample_scales=(4, 2), upsample_kernel_sizes=(8, 4),
              resblock_kernel_sizes=(3, 5), resblock_dilations=((1, 3),) * 2)
    mb = {"generator_type": "HiFiGANGenerator", "generator_params": gp}
    flax_kw = {k: a for k, a in gp.items() if k != "in_channels"}
    v = melgan_perturbed(FlaxHiFiGAN(**flax_kw).init(
        jax.random.key(0), jnp.zeros((1, 6, 12))))
    mb_path = str(tmp_path / "mb.gckpt")
    jax_save_gckpt(mb_path, v)
    mel = np.random.default_rng(6).standard_normal((14, 12)).astype(
        np.float32)
    want = JaxInferenceModel(mb, v).inference(mel)
    model = load_model(mb_path, mb, device="cpu")
    got = model.inference(mel)
    assert got.shape == want.shape == (14 * 8 * 4, 1)
    assert np.abs(got - want).max() <= 1e-5 * (1 + np.abs(want).max())
    with pytest.raises(ValueError, match="multi-band"):
        model.quantize_int8([mel])
    with pytest.raises(ValueError, match="multi-band"):
        model.use_mrf_kernel(quant=False)
    # a causal HiFi-GAN serves by its module forward; the int8 mode
    # refuses it, as in the JAX package
    from parallelwavegan_torch.models import HiFiGANGenerator

    causal_gp = dict(gp, out_channels=1, use_causal_conv=True)
    causal_path = str(tmp_path / "causal.gckpt")
    save_generator_checkpoint(causal_path, HiFiGANGenerator(**causal_gp))
    causal = load_model(causal_path, {"generator_type": "HiFiGANGenerator",
                                      "generator_params": causal_gp},
                        device="cpu")
    assert causal.inference(mel).shape == (14 * 8, 1)
    with pytest.raises(ValueError, match="non-causal"):
        causal.quantize_int8([mel])


@pytest.mark.parametrize("int8", [False, True], ids=["exact", "int8"])
def test_decode_cli_on_the_asset(tmp_path, int8):
    dump = tmp_path / "dump"
    dump.mkdir()
    frames = {"a": 40, "b": 28}
    for utt, n in frames.items():
        np.save(dump / f"{utt}-feats.npy", asset_mel(3, 10, n))
    config = dict(asset_config(), format="npy")
    with open(tmp_path / "config.yml", "w") as f:
        yaml.safe_dump(config, f)
    out = tmp_path / "wav"
    argv = ["--dumpdir", str(dump), "--checkpoint", CKPT, "--config",
            str(tmp_path / "config.yml"), "--outdir", str(out), "--device",
            "cpu", "--batch-size", "2"]
    if int8:
        argv += ["--int8", "--int8-calib-utts", "1", "--int8-schedule",
                 "all"]
    decode_main(argv)
    model = load_model(CKPT, config, device="cpu")
    for utt, n in frames.items():
        sr, wave = wavfile.read(out / f"{utt}_gen.wav")
        assert sr == 22050 and wave.dtype == np.int16
        assert wave.shape == (n * 256,)
        want = model.synthesize_batch([asset_mel(3, 10, n)])[0][:, 0]
        tol = 0.05 if int8 else 2e-4  # of full scale; int8 is a lossy mode
        assert np.abs(wave / 32767.0 - want).max() < tol
        assert np.abs(wave).max() > 1000


def test_decode_cli_int8_fails_fast(tmp_path, capsys):
    from tests.torch_helpers import flax_generator_kwargs

    config = {"generator_type": "ParallelWaveGANGenerator", "format": "npy",
              "generator_params": flax_generator_kwargs()}
    with open(tmp_path / "config.yml", "w") as f:
        yaml.safe_dump(config, f)
    base = ["--dumpdir", str(tmp_path), "--outdir", str(tmp_path / "o"),
            "--device", "cpu", "--config", str(tmp_path / "config.yml"),
            "--checkpoint", str(tmp_path / "none.gckpt"), "--int8"]
    with pytest.raises(SystemExit):
        decode_main(base)
    assert "HiFiGANGenerator checkpoints only" in capsys.readouterr().err
    with open(tmp_path / "config.yml", "w") as f:
        yaml.safe_dump(dict(asset_config(), format="npy"), f)
    with pytest.raises(SystemExit):
        decode_main(base + ["--int8-calib-utts", "0"])
    assert "--int8-calib-utts must be >= 1" in capsys.readouterr().err
    # an empty dump is refused by the dataset, before any model is built
    with pytest.raises(Exception, match="No mel files"):
        decode_main(base[:-3] + ["--checkpoint", CKPT, "--int8"])


def test_eval_metrics_match_the_jax_package():
    """The port's copies of the numpy metrics give the JAX package's
    numbers on two short waveforms (a ground truth and a decode of it)."""
    gt, sr = read_wav(os.path.join(ASSETS, "eval_utt4-gt.wav"))
    gt_j, sr_j = jax_read_wav(os.path.join(ASSETS, "eval_utt4-gt.wav"))
    assert sr == sr_j == 22050
    np.testing.assert_array_equal(gt, gt_j)
    gt = gt[20000:36000]
    rng = np.random.default_rng(0)
    gen = np.roll(gt, 37) * 0.9 + 0.002 * rng.standard_normal(len(gt)).astype(
        np.float32)
    assert eval_metrics.mel_cepstral_distortion(gen, gt, sr) == \
        jax_metrics.mel_cepstral_distortion(gen, gt, sr)
    assert eval_metrics.log_f0_rmse(gen, gt, sr) == \
        jax_metrics.log_f0_rmse(gen, gt, sr)
    np.testing.assert_array_equal(yin_f0(gt, sr, 110, 40.0, 800.0),
                                  jax_yin_f0(gt, sr, 110, 40.0, 800.0))
    np.testing.assert_array_equal(eval_metrics.mcep(gt, sr),
                                  jax_metrics.mcep(gt, sr))
    assert eval_metrics.semitone_accuracy(gen, gt, sr) == \
        jax_metrics.semitone_accuracy(gen, gt, sr)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_matmul_bench_plain_version_matches_numpy(mode):
    rng = np.random.default_rng(1)
    for M, K, N in [(m // 512, k, n) for m, k, n in MRF_SHAPES] + [(7, 50, 24)]:
        if mode == "int8":
            a = rng.integers(-127, 128, (M, K)).astype(np.int8)
            b = rng.integers(-127, 128, (K, N)).astype(np.int8)
            got = matmul_bench(torch.from_numpy(a), torch.from_numpy(b))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(
                got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
        else:
            a = torch.from_numpy(rng.standard_normal((M, K)).astype(
                np.float32)).to(torch.bfloat16)
            b = torch.from_numpy(rng.standard_normal((K, N)).astype(
                np.float32)).to(torch.bfloat16)
            got = matmul_bench_reference(a, b)
            assert got.dtype == torch.float32
            want = a.double().numpy() @ b.double().numpy()
            # f32 accumulation of K exact products
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-4)
    with pytest.raises(TypeError, match="dtypes"):
        matmul_bench(torch.zeros(2, 8), torch.zeros(8, 8))
    with pytest.raises(ValueError, match="shapes"):
        matmul_bench(torch.zeros(2, 8, dtype=torch.int8),
                     torch.zeros(9, 8, dtype=torch.int8))


def test_stage_roofline_tool_on_the_cpu():
    """The tool's four modes on one tiny stage agree with each other as
    far as their numerics allow; its bounds count what they say."""
    from parallelwavegan_torch.tools import int8_stage_roofline as tool

    tool.STAGES[9] = (8, 50)
    try:
        _, fns = tool.stage_functions(9, 2, device="cpu",
                                      dtype=torch.float32)
        out = {mode: fn() for mode, fn in fns.items()}
    finally:
        del tool.STAGES[9]
    assert sorted(out) == sorted(tool.MODES)
    np.testing.assert_allclose(out["kernel_bf16"].numpy(),
                               out["bf16"].numpy(), atol=1e-5)
    np.testing.assert_allclose(out["kernel_int8"].numpy(),
                               out["int8"].numpy(), atol=1e-5)
    assert 0 < (out["int8"] - out["bf16"]).abs().max() < 0.05
    ms, by = tool.stage_bound_ms(256, 32 * 4096, "kernel_bf16")
    assert by == "operations"
    assert ms == pytest.approx(2 * 32 * 4096 * 2 * 3 * 21 * 256 ** 2
                               / 989e12 * 1e3)
    ms, by = tool.matmul_bound_ms(131072, 352, 32, "int8")
    assert by == "bytes"
    assert ms == pytest.approx((131072 * 352 + 352 * 32 + 131072 * 32 * 4)
                               / 3.35e12 * 1e3)
    with pytest.raises(SystemExit):
        if not torch.cuda.is_available():
            tool.main(["--stages", "3"])
        else:
            raise SystemExit


def test_quality_reference_file():
    """The committed per-utterance reference the GPU smoke test holds the
    port's decode to: every evaluation utterance, made by the JAX package
    on the CPU in f32 (tests/make_torch_hifigan_quality_reference.py)."""
    with open(chip_smoke.QUALITY_REFERENCE) as f:
        ref = json.load(f)
    mels = sorted(glob.glob(os.path.join(ASSETS, "*-feats.npy")))
    assert [os.path.join(ASSETS, n) for n in ref["batch_files"]] == mels
    assert sorted(ref["utterances"]) == sorted(
        os.path.basename(m)[: -len("-feats.npy")] for m in mels)
    assert len(ref["utterances"]) == 24
    for name, utt in ref["utterances"].items():
        assert utt["frames"] == len(np.load(
            os.path.join(ASSETS, f"{name}-feats.npy")))
        assert 3.5 < utt["mcd"] < 6.0
    assert sum(u["frames"] for u in ref["utterances"].values()) == 7200
    # the published numbers of this checkpoint (a run of bench.py's quality
    # mode on another device): MCD 4.503 dB, log-F0 RMSE 0.032, V/UV 0.074
    assert ref["mean"]["mcd"] == pytest.approx(4.503, abs=0.06)
    assert ref["mean"]["log_f0_rmse"] == pytest.approx(0.032, abs=0.001)
    assert ref["mean"]["vuv_error"] == pytest.approx(0.074, abs=0.001)
    assert chip_smoke.N_SCORED <= 24 and chip_smoke.N_CALIB <= 24


def test_asset_tree_strict_loads_in_both_forms():
    """The shipped tree (conv, transposed conv, 12 blocks x 6 convs, all
    bf16, kernel_v / kernel_g / bias) converts and strict-loads folded and
    unfolded; nothing beyond the fold repair was needed."""
    from parallelwavegan_torch.engine.checkpoint import (
        load_generator_checkpoint,
    )
    from parallelwavegan_torch.models import HiFiGANGenerator
    from parallelwavegan_torch.utils.params import convert_jax_params

    tree = load_generator_checkpoint(CKPT)["params"]
    assert tree["upsamples_0"]["kernel_g"].shape == (1, 512, 1)
    assert str(tree["upsamples_0"]["kernel_g"].dtype).endswith("bfloat16")
    n_convs = 2 + 4 + 12 * 6
    kw = chip_smoke.HIFIGAN_V1["generator_params"]
    for fold in (True, False):
        state = convert_jax_params(tree, fold=fold)
        assert len(state) == n_convs * (2 if fold else 3)
        assert all(t.dtype == torch.float32 for t in state.values())
        HiFiGANGenerator(**kw, folded=fold).load_state_dict(state,
                                                            strict=True)
    jax_tree = jax_load_gckpt(CKPT)["params"]
    assert jnp.asarray(jax_tree["input_conv"]["bias"]).dtype == jnp.bfloat16
