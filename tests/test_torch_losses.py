"""The port's STFT, mel-spectrogram, feature-matching and adversarial losses
and the Parallel WaveGAN discriminator against the JAX package's, on the
same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelwavegan_tpu.losses import (
    DiscriminatorAdversarialLoss as JaxDisAdv,
    FeatureMatchLoss as JaxFeatureMatchLoss,
    GeneratorAdversarialLoss as JaxGenAdv,
    MelSpectrogramLoss as JaxMelSpectrogramLoss,
    MultiResolutionSTFTLoss as JaxMRSTFT,
    STFTLoss as JaxSTFTLoss,
)
from parallelwavegan_tpu.models import (
    ParallelWaveGANDiscriminator as FlaxDiscriminator,
)
from parallelwavegan_tpu.ops import mel as jax_mel
from parallelwavegan_tpu.ops import spectral as jax_spectral
from parallelwavegan_torch.losses import (
    DiscriminatorAdversarialLoss,
    FeatureMatchLoss,
    GeneratorAdversarialLoss,
    MelSpectrogramLoss,
    MultiResolutionSTFTLoss,
    STFTLoss,
)
from parallelwavegan_torch.models import (
    ParallelWaveGANDiscriminator,
    get_model_class,
)
from parallelwavegan_torch.ops import mel, spectral
from parallelwavegan_torch.utils.params import convert_jax_params

torch.set_num_threads(2)


def _signals(seed, B=3, T=700):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 8000.0
    y = np.stack([0.4 * np.sin(2 * np.pi * (200 + 150 * i) * t)
                  for i in range(B)])
    y = y + 0.05 * rng.standard_normal((B, T))
    x = y + 0.1 * rng.standard_normal((B, T))
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("window", ["hann", "hamming_window", "blackman",
                                    "rect"])
def test_windows_and_basis_match_jax(window):
    np.testing.assert_array_equal(spectral.get_window(window, 48),
                                  jax_spectral.get_window(window, 48))
    np.testing.assert_array_equal(
        spectral.pad_center(spectral.get_window(window, 48), 64),
        jax_spectral.pad_center(jax_spectral.get_window(window, 48), 64))
    np.testing.assert_array_equal(spectral._rdft_basis(64, 48, window),
                                  jax_spectral._rdft_basis(64, 48, window))
    with pytest.raises(ValueError, match="window"):
        spectral.get_window("kaiser", 8)


@pytest.mark.parametrize("method", ["matmul", "fft"])
@pytest.mark.parametrize("fft_size,hop,win", [(128, 32, 64), (256, 50, None),
                                              (64, 16, 64)])
def test_stft_magnitude_matches_jax(method, fft_size, hop, win):
    """Same frames, window and clamp; f32 sums in another order: 2e-5
    relative to the largest magnitude."""
    x, _ = _signals(0)
    ref = np.asarray(jax_spectral.stft_magnitude(
        jnp.asarray(x), fft_size, hop, win, method=method))
    got = spectral.stft_magnitude(torch.from_numpy(x), fft_size, hop, win,
                                  method=method)
    assert tuple(got.shape) == ref.shape == (3, 1 + 700 // hop,
                                             fft_size // 2 + 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5 * ref.max())
    # both methods are one function; "auto" is the fft on the CPU
    other = spectral.stft_magnitude(torch.from_numpy(x), fft_size, hop, win)
    np.testing.assert_allclose(other.numpy(), got.numpy(),
                               atol=2e-5 * ref.max())
    frames = spectral.frame_signal(torch.from_numpy(x), fft_size, hop)
    np.testing.assert_array_equal(
        frames.numpy(),
        np.asarray(jax_spectral.frame_signal(jnp.asarray(x), fft_size, hop)))


def test_stft_magnitude_clamps_and_takes_leading_axes():
    x = torch.zeros((2, 2, 300))
    mag = spectral.stft_magnitude(x, 64, 16, method="matmul")
    assert tuple(mag.shape) == (2, 2, 19, 33)
    np.testing.assert_allclose(mag.numpy(), np.sqrt(1e-7), rtol=1e-6)
    with pytest.raises(ValueError, match="method"):
        spectral.stft_magnitude(x, 64, 16, method="dct")


@pytest.mark.parametrize("method", ["matmul", "fft"])
def test_stft_loss_and_its_gradient_match_jax(method):
    """Loss values to 1e-5 relative; the gradient with respect to the
    generated signal to 1e-4 of its largest entry (log and division by
    small magnitudes amplify the last bits)."""
    x, y = _signals(1)
    jloss = JaxSTFTLoss(128, 32, 64, "hann", method)
    sc_r, mag_r = jloss(jnp.asarray(x), jnp.asarray(y))
    g_ref = jax.grad(lambda a: sum(jloss(a, jnp.asarray(y))))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    sc, mag = STFTLoss(128, 32, 64, "hann", method)(xt, torch.from_numpy(y))
    np.testing.assert_allclose(sc.item(), float(sc_r), rtol=1e-5)
    np.testing.assert_allclose(mag.item(), float(mag_r), rtol=1e-5)
    (grad,) = torch.autograd.grad(sc + mag, xt)
    g_ref = np.asarray(g_ref)
    assert np.abs(grad.numpy() - g_ref).max() <= 1e-4 * np.abs(g_ref).max()


def test_multi_resolution_stft_loss_matches_jax():
    x, y = _signals(2)
    params = dict(fft_sizes=(128, 256, 64), hop_sizes=(16, 32, 8),
                  win_lengths=(64, 128, 32), window="hann")
    sc_r, mag_r = JaxMRSTFT(**params)(jnp.asarray(x), jnp.asarray(y))
    loss = MultiResolutionSTFTLoss(**params)
    sc, mag = loss(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(sc.item(), float(sc_r), rtol=1e-5)
    np.testing.assert_allclose(mag.item(), float(mag_r), rtol=1e-5)
    # (B, C, T) is flattened to (B*C, T)
    x3, y3 = x[None].repeat(2, 0), y[None].repeat(2, 0)
    sc3_r, mag3_r = JaxMRSTFT(**params)(jnp.asarray(x3), jnp.asarray(y3))
    sc3, mag3 = loss(torch.from_numpy(x3), torch.from_numpy(y3))
    np.testing.assert_allclose(sc3.item(), float(sc3_r), rtol=1e-5)
    np.testing.assert_allclose(mag3.item(), float(mag3_r), rtol=1e-5)
    with pytest.raises(ValueError, match="length"):
        MultiResolutionSTFTLoss(fft_sizes=(64,), hop_sizes=(16, 8))


@pytest.mark.parametrize("loss_type", ["mse", "hinge"])
@pytest.mark.parametrize("shape", ["tensor", "list", "feature_maps"])
def test_adversarial_losses_match_jax(loss_type, shape):
    rng = np.random.default_rng(3)
    a, b, c, d = (rng.standard_normal((2, 50, 1)).astype(np.float32) * 2
                  for _ in range(4))
    if shape == "tensor":
        fake, real = a, b
    elif shape == "list":
        fake, real = [a, c], [b, d]
    else:
        fake, real = [[c, a], [a, c]], [[d, b], [b, d]]
    as_jax = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    as_torch = lambda t: jax.tree.map(torch.from_numpy, t)  # noqa: E731
    for average in (True, False):
        g_ref = JaxGenAdv(average, loss_type)(as_jax(fake))
        g = GeneratorAdversarialLoss(average, loss_type)(as_torch(fake))
        np.testing.assert_allclose(float(g), float(g_ref), rtol=1e-6)
        r_ref, f_ref = JaxDisAdv(average, loss_type)(as_jax(fake),
                                                     as_jax(real))
        r, f = DiscriminatorAdversarialLoss(average, loss_type)(
            as_torch(fake), as_torch(real))
        np.testing.assert_allclose(float(r), float(r_ref), rtol=1e-6)
        np.testing.assert_allclose(float(f), float(f_ref), rtol=1e-6)
    with pytest.raises(ValueError, match="loss_type"):
        GeneratorAdversarialLoss(loss_type="wasserstein")


@pytest.mark.parametrize("kwargs", [
    dict(layers=5, conv_channels=16),
    dict(layers=4, conv_channels=8, dilation_factor=2, kernel_size=5,
         bias=False, nonlinear_activation_params={"negative_slope": 0.1}),
], ids=["debug_config", "dilation_factor_2"])
def test_discriminator_matches_flax(kwargs):
    """Logits to 1e-5 and the gradients on kernel_v, kernel_g and bias to
    2e-5 relative to the largest entry, on perturbed parameters."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 200, 1)).astype(np.float32)
    u = rng.standard_normal((2, 200, 1)).astype(np.float32)
    d = FlaxDiscriminator(**kwargs)
    v = d.init({"params": jax.random.key(0)}, jnp.asarray(x))
    v = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) * (1 + 0.3 * rng.standard_normal(
            a.shape)) + 0.05 * rng.standard_normal(a.shape), a.dtype), v)
    port = ParallelWaveGANDiscriminator(**kwargs, folded=False)
    port.load_state_dict(
        convert_jax_params(jax.tree.map(np.asarray, v["params"]), fold=False),
        strict=True)
    y_ref, g_ref = jax.value_and_grad(
        lambda v: jnp.sum(d.apply(v, jnp.asarray(x)) * u))(v)
    y = port(torch.from_numpy(x))
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(d.apply(v, jnp.asarray(x))), atol=1e-5)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad((y * torch.from_numpy(u)).sum(),
                                list(port.parameters()))
    want = convert_jax_params(jax.tree.map(np.asarray, g_ref["params"]),
                              fold=False)
    assert sorted(want) == sorted(names)
    for name, grad in zip(names, grads):
        b = want[name].numpy()
        err = np.abs(grad.numpy() - b).max()
        assert err <= 2e-5 * (1 + np.abs(b).max()), (name, err)
    # the folded (serving) form loads the folded tree and gives the same
    folded = get_model_class("ParallelWaveGANDiscriminator")(**kwargs)
    folded.load_state_dict(
        convert_jax_params(jax.tree.map(np.asarray, v["params"])), strict=True)
    np.testing.assert_allclose(folded(torch.from_numpy(x)).detach().numpy(),
                               y.detach().numpy(), atol=1e-5)


@pytest.mark.parametrize("args", [(22050, 1024, 80, 0.0, 11025.0),
                                  (16000, 128, 16, 80.0, 7600.0),
                                  (24000, 2048, 80, 0.0, None)])
def test_mel_filter_bank_is_the_jax_packages(args):
    np.testing.assert_array_equal(mel.mel_filter_bank(*args),
                                  jax_mel.mel_filter_bank(*args))


@pytest.mark.parametrize("method", ["fft", "matmul"])
@pytest.mark.parametrize("clamp,log_base", [(True, None), (False, 10.0),
                                            (True, 2.0)])
def test_log_mel_spectrogram_matches_jax(method, clamp, log_base):
    """Log-mel to 2e-5 absolute (natural log of energies down to the clamp;
    the f32 FFTs of the two packages differ in the last bits)."""
    x, _ = _signals(5)
    kwargs = dict(fft_size=128, hop_size=32, win_length=96, num_mels=16,
                  fmin=50, fmax=3800, log_base=log_base,
                  clamp_amplitude=clamp, method=method)
    want = jax_spectral.log_mel_spectrogram(jnp.asarray(x), 8000, **kwargs)
    got = spectral.log_mel_spectrogram(torch.from_numpy(x), 8000, **kwargs)
    assert got.shape == want.shape == (3, 700 // 32 + 1, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_mel_loss_and_its_gradient_match_jax():
    """The loss to 1e-5 relative, its gradient with respect to the
    generated signal to 1e-4 of the largest entry (an L1 of logs: the
    gradient divides by the mel energy)."""
    x, y = _signals(6)
    kwargs = dict(fs=8000, fft_size=128, hop_size=32, win_length=128,
                  num_mels=16, fmin=0, fmax=4000, log_base=None)
    ref_loss, ref_grad = jax.value_and_grad(
        lambda x: JaxMelSpectrogramLoss(**kwargs)(x, jnp.asarray(y)))(
            jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    loss = MelSpectrogramLoss(**kwargs)(xt, torch.from_numpy(y))
    (grad,) = torch.autograd.grad(loss, xt)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref_grad = np.asarray(ref_grad)
    assert np.abs(grad.numpy() - ref_grad).max() <= 1e-4 * np.abs(
        ref_grad).max()
    # (B, C, T) flattens to (B * C, T)
    m3 = MelSpectrogramLoss(**kwargs).mel(torch.from_numpy(x)[:, None])
    assert m3.shape == (3, 700 // 32 + 1, 16)
    with pytest.raises(ValueError, match="one-sided"):
        MelSpectrogramLoss(normalized=True)


@pytest.mark.parametrize("by_layers", [True, False])
@pytest.mark.parametrize("by_discriminators", [True, False])
@pytest.mark.parametrize("include_final", [True, False])
def test_feature_match_loss_matches_jax(by_layers, by_discriminators,
                                        include_final):
    rng = np.random.default_rng(7)
    shapes = [[(2, 40, 4), (2, 20, 8), (2, 20, 1)],
              [(2, 13, 3, 4), (2, 5, 3, 8), (2, 15)]]
    fake = [[rng.standard_normal(s).astype(np.float32) for s in d]
            for d in shapes]
    real = [[rng.standard_normal(s).astype(np.float32) for s in d]
            for d in shapes]
    flags = (by_layers, by_discriminators, include_final)
    ref, ref_grads = jax.value_and_grad(
        lambda f, r: JaxFeatureMatchLoss(*flags)(f, r), argnums=(0, 1))(
            jax.tree.map(jnp.asarray, fake), jax.tree.map(jnp.asarray, real))
    t_fake = [[torch.from_numpy(a).requires_grad_() for a in d] for d in fake]
    t_real = [[torch.from_numpy(a).requires_grad_() for a in d] for d in real]
    loss = FeatureMatchLoss(*flags)(t_fake, t_real)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
    loss.backward()
    # the real features are constants: no gradient reaches them
    assert all(a.grad is None for d in t_real for a in d)
    assert all(not np.asarray(g).any() for d in ref_grads[1] for g in d)
    for d, d_ref in zip(t_fake, ref_grads[0]):
        for a, g in zip(d, d_ref):
            if a.grad is None:  # the logits, when they are left out
                assert not include_final and not np.asarray(g).any()
            else:
                np.testing.assert_allclose(a.grad.numpy(), np.asarray(g),
                                           atol=1e-7)
