"""The port's spectral products in full float32 whatever the process set.

The JAX package asks for ``Precision.HIGHEST`` in its STFT and mel
products, which no global setting lowers. The port's products run through
``ops/spectral._full_f32``: on the CPU a "medium" float32 matmul precision
or oneDNN's bf16 matmul would otherwise take them to bf16 (1.27e-3 of the
largest magnitude on a CPU with AMX-BF16), on the card TF32 would. Each
test sets one switch, holds the port to the JAX package with the tolerance
of its test in ``tests/test_torch_losses.py``, checks that the switch reads
as before after the call, and restores it."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelwavegan_tpu.losses import STFTLoss as JaxSTFTLoss
from parallelwavegan_tpu.ops import spectral as jax_spectral
from parallelwavegan_torch.losses import STFTLoss
from parallelwavegan_torch.ops import spectral

torch.set_num_threads(2)


def _signals(seed, B=3, T=700):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 8000.0
    y = np.stack([0.4 * np.sin(2 * np.pi * (200 + 150 * i) * t)
                  for i in range(B)])
    y = y + 0.05 * rng.standard_normal((B, T))
    x = y + 0.1 * rng.standard_normal((B, T))
    return x.astype(np.float32), y.astype(np.float32)


def _precisions():
    return (torch.backends.cuda.matmul.fp32_precision,
            torch.backends.mkldnn.matmul.fp32_precision)


class _Lowered:
    """One process-wide switch that lowers float32 products, set on entry
    and put back on exit; ``reads`` is what it reads while set."""

    def __init__(self, switch):
        self.switch = switch

    def __enter__(self):
        self.saved = (torch.get_float32_matmul_precision(), _precisions())
        if self.switch == "medium":
            torch.set_float32_matmul_precision("medium")
        else:
            torch.backends.mkldnn.matmul.fp32_precision = "bf16"
        return self

    def reads(self):
        if self.switch == "medium":
            return torch.get_float32_matmul_precision()
        return torch.backends.mkldnn.matmul.fp32_precision

    def __exit__(self, *exc):
        torch.set_float32_matmul_precision(self.saved[0])
        torch.backends.cuda.matmul.fp32_precision = self.saved[1][0]
        torch.backends.mkldnn.matmul.fp32_precision = self.saved[1][1]


SWITCHES = ["medium", "mkldnn_bf16"]
WANT = {"medium": "medium", "mkldnn_bf16": "bf16"}


@pytest.mark.parametrize("switch", SWITCHES)
def test_stft_magnitude_is_full_f32_under_lowered_precision(switch):
    """``test_stft_magnitude_matches_jax``'s 2e-5 of the largest
    magnitude, the matmul method at its failing shape."""
    x, _ = _signals(0)
    ref = np.asarray(jax_spectral.stft_magnitude(
        jnp.asarray(x), 128, 32, 64, method="matmul"))
    with _Lowered(switch) as lowered:
        got = spectral.stft_magnitude(torch.from_numpy(x), 128, 32, 64,
                                      method="matmul")
        assert lowered.reads() == WANT[switch]
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5 * ref.max())


@pytest.mark.parametrize("switch", SWITCHES)
def test_log_mel_is_full_f32_under_lowered_precision(switch):
    """``test_log_mel_spectrogram_matches_jax``'s 2e-5 absolute, through
    both products (the STFT's and the mel's)."""
    x, _ = _signals(5)
    kwargs = dict(fft_size=128, hop_size=32, win_length=96, num_mels=16,
                  fmin=50, fmax=3800, log_base=10.0, clamp_amplitude=True,
                  method="matmul")
    want = jax_spectral.log_mel_spectrogram(jnp.asarray(x), 8000, **kwargs)
    with _Lowered(switch) as lowered:
        got = spectral.log_mel_spectrogram(torch.from_numpy(x), 8000,
                                           **kwargs)
        assert lowered.reads() == WANT[switch]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("switch", SWITCHES)
def test_stft_loss_gradient_is_full_f32_under_lowered_precision(switch):
    """``test_stft_loss_and_its_gradient_match_jax``'s tolerances: the
    loss to 1e-5 relative, the gradient (the product's backward) to 1e-4
    of its largest entry."""
    x, y = _signals(1)
    jloss = JaxSTFTLoss(128, 32, 64, "hann", "matmul")
    sc_r, mag_r = jloss(jnp.asarray(x), jnp.asarray(y))
    g_ref = np.asarray(jax.grad(lambda a: sum(jloss(a, jnp.asarray(y))))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    with _Lowered(switch) as lowered:
        sc, mag = STFTLoss(128, 32, 64, "hann", "matmul")(
            xt, torch.from_numpy(y))
        (grad,) = torch.autograd.grad(sc + mag, xt)
        assert lowered.reads() == WANT[switch]
    np.testing.assert_allclose(sc.item(), float(sc_r), rtol=1e-5)
    np.testing.assert_allclose(mag.item(), float(mag_r), rtol=1e-5)
    assert np.abs(grad.numpy() - g_ref).max() <= 1e-4 * np.abs(g_ref).max()


@pytest.mark.parametrize("cuda, mkldnn", [("none", "none"), ("tf32", "bf16"),
                                          ("ieee", "tf32")])
def test_full_f32_sets_both_backends_and_restores_them(cuda, mkldnn):
    """Inside the block cuBLAS and oneDNN products are "ieee" (the card's
    TF32 switch is the first); after it both read as before."""
    saved = _precisions()
    try:
        torch.backends.cuda.matmul.fp32_precision = cuda
        torch.backends.mkldnn.matmul.fp32_precision = mkldnn
        with spectral._full_f32():
            assert _precisions() == ("ieee", "ieee")
            with spectral._full_f32():
                assert _precisions() == ("ieee", "ieee")
            assert _precisions() == ("ieee", "ieee")
        assert _precisions() == (cuda, mkldnn)
    finally:
        torch.backends.cuda.matmul.fp32_precision = saved[0]
        torch.backends.mkldnn.matmul.fp32_precision = saved[1]


def _reads(read):
    try:
        return read()
    except RuntimeError:
        return "raises"


def _settings():
    """What the process's float32 matmul settings read: the legacy
    precision and cuBLAS's TF32 check (each may raise where the two APIs
    were mixed), both backends' values, and the legacy value as it reads
    with both backends at "ieee", where its getter never raises."""
    backends = _precisions()
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.mkldnn.matmul.fp32_precision = "ieee"
    legacy = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.fp32_precision = backends[0]
    torch.backends.mkldnn.matmul.fp32_precision = backends[1]
    return (_reads(torch.get_float32_matmul_precision),
            _reads(torch._C._get_cublas_allow_tf32), backends, legacy)


@pytest.mark.parametrize("mkldnn", [None, "ieee", "bf16", "tf32"])
@pytest.mark.parametrize("cuda", [None, "ieee", "tf32"])
@pytest.mark.parametrize("legacy", [None, "high", "medium"])
def test_full_f32_under_any_mix_of_the_two_apis(legacy, cuda, mkldnn):
    """The process sets the legacy precision, then (or only) a backend's:
    inside the block both APIs agree on full f32, so that cuBLAS's TF32
    check, which raises where they disagree, reads False; after it every
    setting reads as before, the legacy value too."""
    saved = (torch.get_float32_matmul_precision(), _precisions())
    try:
        if legacy:
            torch.set_float32_matmul_precision(legacy)
        if cuda:
            torch.backends.cuda.matmul.fp32_precision = cuda
        if mkldnn:
            torch.backends.mkldnn.matmul.fp32_precision = mkldnn
        before = _settings()
        with spectral._full_f32():
            inside = (torch.get_float32_matmul_precision(),
                      torch._C._get_cublas_allow_tf32(), _precisions())
        assert inside == ("highest", False, ("ieee", "ieee"))
        assert _settings() == before
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.fp32_precision = saved[1][0]
        torch.backends.mkldnn.matmul.fp32_precision = saved[1][1]


def test_full_f32_holds_while_any_thread_is_inside():
    """Ranks as threads (``tools/dp_emulation.py``): a thread that leaves
    its block while another is inside leaves the products full f32, and
    the last to leave restores the process's setting."""
    saved = _precisions()
    inside, release = threading.Event(), threading.Event()
    seen = []

    def rank():
        with spectral._full_f32():
            inside.set()
            release.wait(10)
            seen.append(_precisions())

    try:
        torch.backends.mkldnn.matmul.fp32_precision = "bf16"
        other = threading.Thread(target=rank)
        other.start()
        assert inside.wait(10)
        with spectral._full_f32():
            pass
        assert _precisions()[1] == "ieee"
        release.set()
        other.join(10)
        assert seen == [("ieee", "ieee")]
        assert _precisions()[1] == "bf16"
    finally:
        release.set()
        torch.backends.cuda.matmul.fp32_precision = saved[0]
        torch.backends.mkldnn.matmul.fp32_precision = saved[1]


def test_full_f32_under_many_threads_never_leaves_a_block_lowered():
    """More threads than cores enter and leave the block at a short switch
    interval: inside it every thread reads "ieee" for both backends, and
    after the last leaves the process's setting is back."""
    import os
    import sys

    saved, interval = _precisions(), sys.getswitchinterval()
    lowered, finished = [], []

    def rank():
        for _ in range(200):
            with spectral._full_f32():
                if _precisions() != ("ieee", "ieee"):
                    lowered.append(_precisions())
        finished.append(True)

    threads = [threading.Thread(target=rank)
               for _ in range(2 * (os.cpu_count() or 4))]
    try:
        torch.backends.mkldnn.matmul.fp32_precision = "bf16"
        sys.setswitchinterval(1e-6)
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert len(finished) == len(threads) and not lowered
        assert _precisions()[1] == "bf16"
    finally:
        sys.setswitchinterval(interval)
        torch.backends.cuda.matmul.fp32_precision = saved[0]
        torch.backends.mkldnn.matmul.fp32_precision = saved[1]


def test_first_cpu_sqrt_of_a_process_is_serial():
    """C-7's workaround: the first float32 elementwise op that a process
    ran across its threads after an earlier parallel op (the STFT's reflect
    pad) returned values off by up to 3e-4 of themselves on one thread's
    share (2 to 6 % of fresh processes under load on a CPU with AVX-512
    and AMX, none after a serial op). Importing the port makes, once, a
    sqrt of one element."""
    import os
    import subprocess
    import sys

    code = ("import torch\n"
            "calls, sqrt = [], torch.sqrt\n"
            "def spy(t, *a, **k):\n"
            "    calls.append(t.numel())\n"
            "    return sqrt(t, *a, **k)\n"
            "torch.sqrt = spy\n"
            "import parallelwavegan_torch\n"
            "import parallelwavegan_torch.ops.spectral\n"
            "print(calls)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "[1]"


def test_first_sqrt_probe_counts_fresh_processes(capsys):
    """``first_sqrt_probe.py`` beside chip_smoke.py (the numbers of
    ROADMAP.md C-7): one fresh process a mode, each line naming its
    runs."""
    import first_sqrt_probe

    assert first_sqrt_probe.main(["--runs", "3", "--jobs", "4"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == list(
        first_sqrt_probe.MODES)
    assert all(" 3 runs, " in line for line in lines)
    # the port's own STFT, with the workaround, is never off
    assert lines[0].startswith("port: 3 runs, 0 off")
    assert lines[-1].startswith("port_import_after_add_tanh: 3 runs, 0 off")
    assert first_sqrt_probe.child("port") < 1e-6
