"""PQMF in the port against the JAX package on the CPU: the prototype and
filter banks (to 1e-6), the polyphase kernels, analysis and synthesis in
f32 and bf16, the PQMF object, and the InferenceModel's choice of PQMF
(the <= 0.4.2 prototype switch, ``pqmf_params``) and upsample factor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelwavegan_tpu.layers import PQMF as JaxPQMF
from parallelwavegan_tpu.models import MelGANGenerator as FlaxMelGAN
from parallelwavegan_tpu.ops import pqmf as jax_pqmf
from parallelwavegan_tpu.utils.model_loader import (
    InferenceModel as JaxInferenceModel,
)
from parallelwavegan_tpu.utils.model_loader import (
    _version_leq as jax_version_leq,
)
from parallelwavegan_torch.layers.pqmf import PQMF
from parallelwavegan_torch.ops import pqmf
from parallelwavegan_torch.utils.model_loader import (
    InferenceModel,
    _version_leq,
    pqmf_for,
)
from tests.torch_helpers import melgan_perturbed

torch.set_num_threads(2)

BANKS = [(4, 62, 0.142, 9.0), (4, 62, 0.15, 9.0), (3, 48, 0.2, 8.0),
         (2, 30, 0.25, 7.0)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("bank", BANKS, ids=lambda b: "-".join(map(str, b)))
def test_filters_match_jax(bank):
    S, taps, cutoff, beta = bank
    np.testing.assert_allclose(
        pqmf.design_prototype_filter(taps, cutoff, beta),
        jax_pqmf.design_prototype_filter(taps, cutoff, beta), atol=1e-6)
    for got, want in zip(pqmf.pqmf_filters(*bank),
                         jax_pqmf.pqmf_filters(*bank)):
        assert got.shape == want.shape == (S, taps + 1)
        np.testing.assert_allclose(got, want, atol=1e-6)
    for mine, theirs in ((pqmf._polyphase_analysis_kernel,
                          jax_pqmf._polyphase_analysis_kernel),
                         (pqmf._polyphase_synthesis_kernel,
                          jax_pqmf._polyphase_synthesis_kernel)):
        (k1, p1), (k2, p2) = mine(*bank), theirs(*bank)
        assert p1 == p2
        np.testing.assert_allclose(k1, k2, atol=1e-6)


def test_prototype_refuses_what_jax_asserts():
    with pytest.raises(ValueError, match="even"):
        pqmf.design_prototype_filter(61)
    with pytest.raises(ValueError, match="cutoff"):
        pqmf.design_prototype_filter(62, 1.2)


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.1
    err = np.abs(got - want).max()
    assert err <= TOL[dtype] * (1 + np.abs(want).max()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bank", BANKS[1:3], ids=["mb_v2", "three_bands"])
def test_analysis_and_synthesis_match_jax(bank, dtype):
    """Both directions in the input's dtype, T not a multiple of the
    subband count for the analysis."""
    S = bank[0]
    rng = np.random.default_rng(0)
    wave = rng.standard_normal((2, 301, 1)).astype(np.float32)
    sub = rng.standard_normal((2, 77, S)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = pqmf.pqmf_analysis(torch.from_numpy(wave).to(tdt), *bank)
    want = jax_pqmf.pqmf_analysis(jnp.asarray(wave, jdt), *bank)
    assert got.dtype == tdt and got.shape == (2, -(-301 // S), S)
    _close(got.float(), want, dtype)
    got = pqmf.pqmf_synthesis(torch.from_numpy(sub).to(tdt), *bank)
    want = jax_pqmf.pqmf_synthesis(jnp.asarray(sub, jdt), *bank)
    assert got.dtype == tdt and got.shape == (2, 77 * S, 1)
    _close(got.float(), want, dtype)


@pytest.mark.parametrize("cutoff,tol", [(0.142, 1e-3), (0.15, 0.1)],
                         ids=["current", "old_prototype"])
def test_pqmf_object_matches_jax_and_reconstructs(cutoff, tol):
    """The object's two directions against the JAX object's; analysis then
    synthesis gives the input back, to 1e-3 of an amplitude of 0.5 with the
    current prototype and to 0.1 with the old one (whose aliasing is why
    the reference changed it after 0.4.2)."""
    t = np.arange(4096) / 22050.0
    wave = (0.5 * np.sin(2 * np.pi * 3000 * t)).astype(np.float32)[None, :,
                                                                    None]
    mine, theirs = PQMF(4, 62, cutoff, 9.0), JaxPQMF(4, 62, cutoff, 9.0)
    sub = mine.analysis(torch.from_numpy(wave))
    _close(sub, theirs.analysis(jnp.asarray(wave)), "float32")
    back = mine.synthesis(sub)
    _close(back, theirs.synthesis(jnp.asarray(sub.numpy())), "float32")
    inner = slice(200, -200)
    err = np.abs(back.numpy()[0, inner, 0] - wave[0, inner, 0]).max()
    assert err < tol


@pytest.mark.parametrize("a,b", [
    ("0.1.0", "0.4.2"), ("0.4.2", "0.4.2"), ("0.4.3", "0.4.2"),
    ("0.5.0rc1", "0.4.2"), ("0.4", "0.4.2"), ("1.0", "0.4.2"),
    ("0.4.2-1", "0.4.2"),
])
def test_version_leq_matches_jax(a, b):
    assert _version_leq(a, b) == jax_version_leq(a, b)


def _melgan_config(**extra):
    return dict({
        "generator_type": "MelGANGenerator",
        "generator_params": {"in_channels": 6, "out_channels": 4,
                             "channels": 16, "upsample_scales": [2, 2],
                             "stacks": 1},
    }, **extra)


@pytest.mark.parametrize("extra", [
    {}, {"version": "0.4.2"}, {"version": "0.5.3"},
    {"version": "0.5.3", "pqmf_params": {"taps": 48, "cutoff_ratio": 0.2,
                                         "beta": 8.0}},
    {"pqmf_params": {"taps": 62, "cutoff_ratio": 0.142, "beta": 9.0}},
], ids=["no_version", "0.4.2", "0.5.3", "params", "params_no_version"])
def test_inference_model_picks_pqmf_and_upsample_factor_like_jax(extra):
    """The prototype switch and pqmf_params as the JAX InferenceModel reads
    them; the upsample factor counts the subbands (2 * 2 * 4)."""
    config = _melgan_config(**extra)
    gp = dict(config["generator_params"])
    v = melgan_perturbed(FlaxMelGAN(
        **{k: a for k, a in gp.items() if k != "in_channels"}
    ).init(jax.random.key(0), jnp.zeros((1, 5, 6))))
    ref = JaxInferenceModel(config, v)
    model = InferenceModel(config, v, device="cpu")
    assert model.pqmf == pqmf_for(config) == PQMF(**vars(ref.pqmf))
    assert model.upsample_factor == ref.upsample_factor == 16
    c = np.random.default_rng(1).standard_normal((9, 6)).astype(np.float32)
    got, want = model.inference(c), ref.inference(c)
    assert got.shape == want.shape == (9 * 16, 1)
    _close(got, want, "float32")
