"""The port's recipe front end against the JAX package's, on the CPU.

``parallelwavegan_torch/bin/{preprocess, compute_statistics, normalize,
preprocess_tokens, evaluate_mcd, evaluate_f0, convert_checkpoint}.py`` and
the preprocessing DSP of ``ops/audio.py`` / ``ops/spectral.py`` against the
JAX CLIs (run in-process on the same files) on a small corpus of noisy
sines at 8 kHz (the yesno debug recipe's 256-point FFT, hop 64, 40 mels).
Waves, f0, the local features, speaker ids and token dumps are held bit
for bit; the log-mel to 4e-6 (both take a float64 FFT and log of the same
float32 frames: a few float32 roundings at |log10 mel| <= 10); the
statistics and normalized features to what that moves (1e-5 and 5e-5);
the excitation to 1e-5 on the same draws (the sine test's bound: both sum
the phase in float32, in another order). Last, a subprocess with ``yaml``
and ``h5py`` blocked runs the whole recipe from its yaml through hdf5
dumps, ``bin.train`` and ``bin.decode``.
"""

import os
import subprocess
import sys
import zlib

import h5py
import numpy as np
import pytest
import torch
import yaml

import parallelwavegan_tpu.ops.audio as jax_audio
import parallelwavegan_tpu.ops.sine as jax_sine
from parallelwavegan_torch.bin import (
    compute_statistics as port_stats,
    convert_checkpoint as port_convert,
    evaluate_f0 as port_f0,
    evaluate_mcd as port_mcd,
    normalize as port_normalize,
    preprocess as port_preprocess,
    preprocess_tokens as port_tokens,
)
from parallelwavegan_torch.ops import audio as port_audio
from parallelwavegan_torch.ops.spectral import preprocess_log_mel
from parallelwavegan_torch.utils.io import read_wav, write_wav
from parallelwavegan_tpu.bin import (
    compute_statistics as jax_stats,
    convert_checkpoint as jax_convert,
    evaluate_f0 as jax_f0,
    evaluate_mcd as jax_mcd,
    normalize as jax_normalize,
    preprocess as jax_preprocess,
    preprocess_tokens as jax_tokens,
)
from parallelwavegan_tpu.ops.spectral import log_mel_spectrogram_numpy
from tests.torch_helpers import JaxDraws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEBUG_YAML = os.path.join(REPO, "egs", "yesno", "voc1", "conf",
                          "parallel_wavegan.v1.debug.yaml")
SR, HOP = 8000, 64
N_UTTS = 6
MEL_TOL, STATS_TOL, NORM_TOL, EXCITATION_TOL = 4e-6, 1e-5, 5e-5, 1e-5


def _sine(i: int, rng) -> np.ndarray:
    """0.75 s: 0.1 s of silence, a noisy sine, 0.1 s of faint noise."""
    t = np.arange(int(0.55 * SR)) / SR
    voiced = 0.4 * np.sin(2 * np.pi * (110 + 35 * i) * t)
    voiced += 0.01 * rng.standard_normal(len(t))
    return np.concatenate([np.zeros(int(0.1 * SR)), voiced,
                           1e-4 * rng.standard_normal(int(0.1 * SR))]
                          ).astype(np.float32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipe")
    rng = np.random.default_rng(0)
    wav_dir = root / "wavs"
    lines, utt2spk = [], []
    for i in range(N_UTTS):
        path = str(wav_dir / f"utt{i}.wav")
        write_wav(path, _sine(i, rng), SR)
        lines.append(f"utt{i} {path}\n")
        utt2spk.append(f"utt{i} spk{'AB'[i % 2]}\n")
    (root / "wav.scp").write_text("".join(lines))
    (root / "utt2spk").write_text("".join(utt2spk))
    (root / "spk2idx").write_text("spkA 0\n")  # spkB takes 1
    return root


def _config(root, name: str, **overrides) -> str:
    with open(DEBUG_YAML) as f:
        config = yaml.safe_load(f)
    config.update(overrides)
    path = str(root / f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def _run_jax(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    module.main()


def _excitation_draws(utt_ids, n_samples):
    """The port's draws for each utterance (a CPU generator seeded by the
    id's CRC-32): the phase, then the noise."""
    uniforms, normals = [], []
    for utt, n in zip(utt_ids, n_samples):
        g = torch.Generator().manual_seed(zlib.crc32(utt.encode()))
        uniforms.append(torch.rand((1, 1), generator=g).numpy())
        normals.append(torch.randn((1, n, 1), generator=g).numpy())
    return uniforms, normals


def _read_dump(dumpdir, fmt):
    """{utt: {key: array}} of a dump directory."""
    out = {}
    for name in sorted(os.listdir(dumpdir)):
        path = os.path.join(dumpdir, name)
        if fmt == "hdf5" and name.endswith(".h5"):
            with h5py.File(path, "r") as f:
                out[name[:-3]] = {k: f[k][()] for k in f}
        elif fmt == "npy" and name.endswith(".npy"):
            utt, key = name[:-4].rsplit("-", 1)
            out.setdefault(utt, {})[key] = np.load(path)
    return out


CASES = {
    # format, config overrides, preprocess flags
    "hdf5": ("hdf5", dict(trim_silence=True, trim_frame_size=256,
                          trim_hop_size=64, trim_threshold_in_db=40,
                          use_f0=True, use_excitation=True), True),
    "npy": ("npy", dict(trim_silence=True, trim_frame_size=256,
                        trim_hop_size=64, trim_threshold_in_db=40), True),
    "hdf5_dual_rate": ("hdf5", dict(sampling_rate_for_feats=4000, fmax=None,
                                    fft_size=128, use_f0=True), False),
}


@pytest.fixture(scope="module", params=list(CASES))
def pipelines(request, corpus, tmp_path_factory):
    """Both packages' preprocess -> compute_statistics (feats, per speaker;
    local) -> normalize (feats; local) on the corpus."""
    fmt, overrides, extract = CASES[request.param]
    root = tmp_path_factory.mktemp(request.param)
    conf = _config(root, "conf", format=fmt, **overrides)
    mp = pytest.MonkeyPatch()
    out = {"fmt": fmt, "extract": extract, "overrides": overrides}
    try:
        for tag in ("jax", "port"):
            d = root / tag
            raw, stats, norm, lnorm = (str(d / x) for x in
                                       ("raw", "stats", "norm", "lnorm"))
            argv = ["--wav-scp", str(corpus / "wav.scp"), "--dumpdir", raw,
                    "--config", conf, "--utt2spk", str(corpus / "utt2spk"),
                    "--spk2idx", str(corpus / "spk2idx"), "--verbose", "0"]
            if extract:
                argv.append("--extract-f0")
            stats_argv = ["--rootdir", raw, "--dumpdir", stats, "--config",
                          conf, "--verbose", "0"]
            ext = "h5" if fmt == "hdf5" else "npy"
            norm_argv = ["--rootdir", raw, "--dumpdir", norm, "--stats",
                         f"{stats}/stats.{ext}", "--config", conf,
                         "--verbose", "0"]
            lnorm_argv = ["--rootdir", raw, "--dumpdir", lnorm, "--stats",
                          f"{stats}/stats-local.{ext}", "--config", conf,
                          "--target-feats", "local", "--verbose", "0"]
            if tag == "jax":
                if overrides.get("use_excitation"):
                    # the JAX CLI takes the port's draws (it would seed
                    # from Python's salted hash of the id)
                    lengths = _excitation_lengths(corpus, conf)
                    uniforms, normals = _excitation_draws(
                        [f"utt{i}" for i in range(N_UTTS)], lengths)
                    mp.setattr(jax_sine, "jax", JaxDraws(
                        normals=normals, uniforms=uniforms))
                _run_jax(jax_preprocess, argv, mp)
                _run_jax(jax_stats, stats_argv + ["--utt2spk",
                                                  str(corpus / "utt2spk")],
                         mp)
                _run_jax(jax_normalize, norm_argv, mp)
                if extract:
                    _run_jax(jax_stats, stats_argv + ["--target-feats",
                                                      "local"], mp)
                    _run_jax(jax_normalize, lnorm_argv, mp)
            else:
                port_preprocess.main(argv + ["--device", "cpu"])
                port_stats.main(stats_argv + ["--utt2spk",
                                              str(corpus / "utt2spk")])
                port_normalize.main(norm_argv)
                if extract:
                    port_stats.main(stats_argv + ["--target-feats", "local"])
                    port_normalize.main(lnorm_argv)
            out[tag] = {k: str(d / k) for k in ("raw", "stats", "norm",
                                                 "lnorm")}
    finally:
        mp.undo()
    return out


def _excitation_lengths(corpus, conf) -> list:
    """Each utterance's excitation draw length: the tiled log-f0 contour's
    (frames x hop), from a port run without excitation."""
    tmp = os.path.join(os.path.dirname(conf), "lengths")
    with open(conf) as f:
        config = yaml.safe_load(f)
    config.update(use_excitation=False, use_f0=False, format="npy")
    path = os.path.join(os.path.dirname(conf), "lengths.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    port_preprocess.main(["--wav-scp", str(corpus / "wav.scp"), "--dumpdir",
                          tmp, "--config", path, "--device", "cpu",
                          "--verbose", "0"])
    return [len(np.load(os.path.join(tmp, f"utt{i}-feats.npy"))) * HOP
            for i in range(N_UTTS)]


def test_preprocess_matches_jax(pipelines):
    """Waves, f0, local and global bit for bit, the log-mel within
    MEL_TOL, the excitation within EXCITATION_TOL on the same draws, the
    same files and keys, and len(wave) == len(feats) * hop."""
    fmt = pipelines["fmt"]
    want = _read_dump(pipelines["jax"]["raw"], fmt)
    got = _read_dump(pipelines["port"]["raw"], fmt)
    assert sorted(got) == sorted(want) and len(got) == N_UTTS
    for utt in want:
        assert sorted(got[utt]) == sorted(want[utt]), utt
        for key, value in want[utt].items():
            assert got[utt][key].dtype == value.dtype, (utt, key)
            assert got[utt][key].shape == value.shape, (utt, key)
            if key == "feats":
                np.testing.assert_allclose(got[utt][key], value, rtol=0,
                                           atol=MEL_TOL)
            elif key == "excitation":
                np.testing.assert_allclose(got[utt][key], value, rtol=0,
                                           atol=EXCITATION_TOL)
            else:
                np.testing.assert_array_equal(got[utt][key], value,
                                              err_msg=f"{utt} {key}")
        assert len(got[utt]["wave"]) == len(got[utt]["feats"]) * HOP
    keys = set(next(iter(got.values())))
    if fmt == "hdf5":
        assert {"wave", "feats", "local", "global"} <= keys or \
            not pipelines["extract"]
        assert ("excitation" in keys) == bool(
            pipelines["overrides"].get("use_excitation"))
    # the trim cut the leading silence: fewer samples than the wavs
    if pipelines["overrides"].get("trim_silence"):
        assert all(len(v["wave"]) < 0.75 * SR for v in got.values())


def test_statistics_and_normalize_match_jax(pipelines):
    fmt = pipelines["fmt"]
    jax_dir, port_dir = pipelines["jax"], pipelines["port"]
    names = sorted(os.listdir(jax_dir["stats"]))
    assert names == sorted(os.listdir(port_dir["stats"]))
    assert len(names) == (3 if not pipelines["extract"] else 4)
    for name in names:  # stats, stats-spkA, stats-spkB (, stats-local)
        a, b = (os.path.join(d["stats"], name) for d in (jax_dir, port_dir))
        if fmt == "hdf5":
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                assert sorted(fa) == sorted(fb) == ["mean", "scale"]
                for k in fa:
                    np.testing.assert_allclose(fb[k][()], fa[k][()], rtol=0,
                                               atol=STATS_TOL)
        else:
            np.testing.assert_allclose(np.load(b), np.load(a), rtol=0,
                                       atol=STATS_TOL)
    for key, target in (("norm", "feats"), ("lnorm", "local")):
        if key == "lnorm" and not pipelines["extract"]:
            continue
        want = _read_dump(jax_dir[key], fmt)
        got = _read_dump(port_dir[key], fmt)
        assert sorted(got) == sorted(want)
        for utt in want:
            if fmt == "npy" and target == "local":
                # the JAX CLI copies "-local.npy" as the "-global.npy" it
                # looks for beside "-feats.npy"; the port copies the
                # "-global.npy" beside "-local.npy"
                assert sorted(got[utt]) == ["global", "local", "wave"]
                raw = _read_dump(port_dir["raw"], fmt)[utt]
                np.testing.assert_array_equal(got[utt]["global"],
                                              raw["global"])
                keys = ["local", "wave"]
            else:
                assert sorted(got[utt]) == sorted(want[utt])
                keys = list(want[utt])
            for k in keys:
                if k == target:
                    np.testing.assert_allclose(got[utt][k], want[utt][k],
                                               rtol=0, atol=NORM_TOL)
                elif k == "excitation":
                    np.testing.assert_allclose(got[utt][k], want[utt][k],
                                               rtol=0, atol=EXCITATION_TOL)
                else:
                    np.testing.assert_array_equal(got[utt][k], want[utt][k])
            if target == "local":  # V/UV passes through unnormalized
                assert set(np.unique(got[utt]["local"][:, 1])) <= {0.0, 1.0}


@pytest.mark.parametrize("n", [1, 100, 300, 513, 6000])
def test_preprocess_log_mel_matches_jax(n):
    rng = np.random.default_rng(n)
    x = (0.1 * rng.standard_normal(n)).astype(np.float32)
    x[: n // 3] = 0.0  # digital silence: mel at the 1e-10 clamp
    want = log_mel_spectrogram_numpy(x, 22050, 1024, 256, None, "hann", 80,
                                     80, 7600).astype(np.float32)
    got = preprocess_log_mel(x, 22050, 1024, 256, None, "hann", 80, 80,
                             7600, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_TOL)


def test_preprocess_log_mel_refuses_an_empty_wave_as_jax():
    with pytest.raises(ValueError) as want:
        log_mel_spectrogram_numpy(np.zeros(0, np.float32), 8000, 256, 64)
    with pytest.raises(ValueError) as got:
        preprocess_log_mel(np.zeros(0, np.float32), 8000, 256, 64,
                           device="cpu")
    assert str(got.value) == str(want.value)


def _audio_case(name):
    rng = np.random.default_rng(1)
    x = _sine(3, rng)
    f0 = jax_audio.yin_f0(x, SR, HOP)
    return {
        "trim_silence": lambda m: m.trim_silence(x, 40, 256, 64),
        "resample": lambda m: m.resample(x, SR, 22050),
        "log_f0": lambda m: m.log_f0(x, SR, HOP, frame_length=256),
        "interpolate_continuous_f0": lambda m: m.interpolate_continuous_f0(
            f0),
        "logf0_and_vuv": lambda m: m.logf0_and_vuv(x, SR, HOP),
        "logf0_and_vuv_unvoiced": lambda m: m.logf0_and_vuv(
            np.zeros(4000, np.float32), SR, HOP),
    }[name]


@pytest.mark.parametrize("name", ["trim_silence", "resample", "log_f0",
                                  "interpolate_continuous_f0",
                                  "logf0_and_vuv", "logf0_and_vuv_unvoiced"])
def test_audio_ops_match_jax(name):
    case = _audio_case(name)
    want, got = case(jax_audio), case(port_audio)
    if want is None:
        assert got is None
        return
    for a, b in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("fmt", ["hdf5", "npy"])
def test_preprocess_tokens_matches_jax(corpus, tmp_path, monkeypatch, fmt):
    rng = np.random.default_rng(2)
    text = "".join(f"utt{i} " + " ".join(str(t) for t in rng.integers(
        0, 100, 60 + 10 * i)) + "\n" for i in range(N_UTTS - 1))
    (tmp_path / "text").write_text(text)  # utt5 has no tokens: skipped
    conf = _config(tmp_path, "conf", format=fmt, sampling_rate=16000,
                   trim_silence=True, trim_frame_size=256, trim_hop_size=64,
                   trim_threshold_in_db=40)
    dumps = {}
    for tag in ("jax", "port"):
        dumps[tag] = str(tmp_path / tag)
        argv = ["--wav-scp", str(corpus / "wav.scp"), "--text",
                str(tmp_path / "text"), "--utt2spk", str(corpus / "utt2spk"),
                "--spk2idx", str(corpus / "spk2idx"), "--use-f0",
                "--dumpdir", dumps[tag], "--config", conf, "--verbose", "0"]
        if tag == "jax":
            _run_jax(jax_tokens, argv, monkeypatch)
        else:
            port_tokens.main(argv)
    want, got = _read_dump(dumps["jax"], fmt), _read_dump(dumps["port"], fmt)
    assert sorted(got) == sorted(want) == [f"utt{i}" for i in range(5)]
    for utt in want:
        assert sorted(got[utt]) == sorted(want[utt]) == ["f0", "feats",
                                                          "wave"]
        for k in want[utt]:
            np.testing.assert_array_equal(got[utt][k], want[utt][k])
        assert got[utt]["feats"].shape[1] == 2  # the speaker column
        assert len(got[utt]["wave"]) == len(got[utt]["feats"]) * HOP


def test_evaluate_mcd_and_f0_match_jax(corpus, tmp_path, monkeypatch):
    """The same scores in the same files; the port's run in 2 processes,
    the JAX CLI's in one."""
    rng = np.random.default_rng(3)
    gen = tmp_path / "gen"
    for i in range(3):
        wave, sr = read_wav(str(corpus / "wavs" / f"utt{i}.wav"))
        noisy = wave + 0.02 * rng.standard_normal(len(wave))
        write_wav(str(gen / f"utt{i}_gen.wav"), noisy.astype(np.float32), sr)
    write_wav(str(gen / "orphan_gen.wav"), np.zeros(800, np.float32), SR)
    argv = ["--outdir", str(gen), "--gt-wavdir", str(corpus / "wavs"),
            "--verbose", "0"]
    outputs = {}
    for tag in ("jax", "port"):
        if tag == "jax":
            _run_jax(jax_mcd, argv + ["--n-jobs", "1"], monkeypatch)
            _run_jax(jax_f0, argv + ["--n-jobs", "1"], monkeypatch)
        else:
            mcd = port_mcd.main(argv + ["--n-jobs", "2"])
            rmse, vuv = port_f0.main(argv + ["--n-jobs", "1"])
            assert np.isfinite(mcd) and 0 <= vuv <= 1
        outputs[tag] = [(gen / name).read_text()
                        for name in ("utt2mcd", "utt2logf0rmse")]
    assert outputs["port"] == outputs["jax"]
    assert len(outputs["port"][0].splitlines()) == 3


def test_convert_checkpoint_both_ways_matches_jax(tmp_path, monkeypatch):
    """A reference .pkl -> .ckpt by both CLIs: the same generator and
    steps; then the port's .ckpt -> .pkl by both: the same state dict,
    bit-equal to the .pkl it came from."""
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.engine.checkpoint import load_checkpoint
    from parallelwavegan_torch.utils.params import nested
    from parallelwavegan_torch.utils.torch_export import (
        save_reference_checkpoint,
    )

    conf = _config(tmp_path, "config", fused_wavenet=False)
    with open(conf) as f:
        config = yaml.safe_load(f)
    source = init_train_state(config, 5, "cpu")[0]
    os.makedirs(tmp_path / "ref")
    pkl = str(tmp_path / "ref" / "checkpoint-7steps.pkl")
    save_reference_checkpoint(pkl, nested(source.params_g), config, steps=7)
    ckpts = {}
    for tag in ("jax", "port"):
        argv = ["--checkpoint", pkl, "--config", conf, "--outdir",
                str(tmp_path / tag), "--verbose", "0"]
        if tag == "jax":
            _run_jax(jax_convert, argv, monkeypatch)
        else:
            port_convert.main(argv + ["--device", "cpu"])
        ckpts[tag] = str(tmp_path / tag / "checkpoint-7steps.ckpt")
        state = load_checkpoint(ckpts[tag], init_train_state(config, 0,
                                                             "cpu")[0])
        assert state.steps == 7
        for k, v in source.params_g.items():
            torch.testing.assert_close(state.params_g[k], v, rtol=0, atol=0)
        with open(tmp_path / tag / "config.yml") as f:
            assert yaml.safe_load(f) == config
    pkls = {}
    for tag in ("jax", "port"):
        argv = ["--checkpoint", ckpts["port"], "--config", conf, "--outdir",
                str(tmp_path / f"{tag}_back"), "--to-reference",
                "--verbose", "0"]
        if tag == "jax":
            _run_jax(jax_convert, argv, monkeypatch)
        else:
            port_convert.main(argv + ["--device", "cpu"])
        pkls[tag] = torch.load(
            str(tmp_path / f"{tag}_back" / "checkpoint-7steps.pkl"),
            weights_only=False)
    original = torch.load(pkl, weights_only=False)
    for tag in ("jax", "port"):
        got = pkls[tag]["model"]["generator"]
        want = original["model"]["generator"]
        assert sorted(got) == sorted(want) and pkls[tag]["steps"] == 7
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


BLOCKED_RECIPE = """
import sys
sys.modules["yaml"] = None
sys.modules["h5py"] = None
import glob, os
import numpy as np
from parallelwavegan_torch.bin import (compute_statistics, decode, normalize,
                                       preprocess, train)
from parallelwavegan_torch.utils import yaml_lite
from parallelwavegan_torch.utils.io import read_hdf5

root, conf = sys.argv[1], sys.argv[2]
raw, stats, norm, exp, out = (os.path.join(root, d) for d in
                              ("raw", "stats", "norm", "exp", "out"))
common = ["--config", conf, "--verbose", "0"]
preprocess.main(["--wav-scp", os.path.join(root, "wav.scp"), "--dumpdir", raw,
                 "--device", "cpu"] + common)
compute_statistics.main(["--rootdir", raw, "--dumpdir", stats] + common)
normalize.main(["--rootdir", raw, "--dumpdir", norm, "--stats",
                os.path.join(stats, "stats.h5")] + common)
trainer = train.main(["--train-dumpdir", norm, "--dev-dumpdir", norm,
                      "--outdir", exp, "--device", "cpu"] + common)
assert trainer.steps == 2
saved = yaml_lite.load_file(os.path.join(exp, "config.yml"))
assert saved["train_max_steps"] == 2 and saved["format"] == "hdf5"
decode.main(["--dumpdir", norm, "--checkpoint",
             os.path.join(exp, "checkpoint-2steps.ckpt"), "--outdir", out,
             "--device", "cpu", "--verbose", "0"])
wavs = sorted(glob.glob(os.path.join(out, "*_gen.wav")))
assert len(wavs) == len(glob.glob(os.path.join(norm, "*.h5"))) > 0
for name in ("yaml", "h5py"):
    assert sys.modules[name] is None, name
print("recipe ok", len(wavs))
"""


def test_the_recipe_runs_without_yaml_and_h5py(corpus, tmp_path):
    """preprocess -> compute_statistics -> normalize -> bin.train (2 steps)
    -> bin.decode from the yesno recipe's yaml (cut by yaml_lite) and hdf5
    dumps, in a process where ``import yaml`` and ``import h5py`` fail, as
    on the GPU machine."""
    from parallelwavegan_torch.utils import yaml_lite

    config = yaml_lite.load_file(DEBUG_YAML)
    config.update(batch_size=2, train_max_steps=2, save_interval_steps=2,
                  eval_interval_steps=2, log_interval_steps=1,
                  fused_wavenet=False)
    conf = str(tmp_path / "conf.yaml")
    with open(conf, "w") as f:
        f.write(yaml_lite.dump(config))
    (tmp_path / "wav.scp").write_text((corpus / "wav.scp").read_text())
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED_RECIPE, str(tmp_path), conf],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert f"recipe ok {N_UTTS}" in out.stdout
