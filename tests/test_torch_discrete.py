"""The discrete-symbol (token) generators in the port against the JAX
package on the CPU, at small widths: ``Dense``, ``ChannelLayerNorm``, the
duration predictor (deterministic and on the port's dropout masks, handed
to flax by ``FlaxMasks``), the length regulator, the variance predictor,
the duration loss, the four generators folded and trainable (speakers
added and concatenated, float features, the F0 generator's layer sum with
learned and fixed weights and its plain input conv), the reference
``.pkl`` both ways, ``InferenceModel`` per family (the duration cut
included), ``bin.decode`` and ``bin.decode_from_text`` against the JAX
CLIs, and ``chip_smoke``'s recipes against their yaml.

Known JAX behaviours held here beside the port's: ids pass its bf16
serving as floats (257 is read as 256), and its token StyleMelGAN serving
draws one noise frame, so an utterance longer than one noise frame fails.
"""

import functools
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from parallelwavegan_tpu.bin import decode as jax_decode_cli
from parallelwavegan_tpu.engine.checkpoint import (
    load_reference_checkpoint as jax_load_reference_checkpoint,
)
from parallelwavegan_tpu.layers import common as jax_common
from parallelwavegan_tpu.layers import duration as jax_duration
from parallelwavegan_tpu.losses.duration import (
    DurationPredictorLoss as JaxDurationLoss,
)
from parallelwavegan_tpu.models import discrete as jax_discrete
from parallelwavegan_tpu.utils import torch_export as jax_export
from parallelwavegan_tpu.utils import torch_import as jax_import
from parallelwavegan_tpu.utils.model_loader import (
    InferenceModel as JaxInferenceModel,
)
from parallelwavegan_torch.bin import decode as decode_cli
from parallelwavegan_torch.bin import decode_from_text
from parallelwavegan_torch.engine.checkpoint import save_generator_checkpoint
from parallelwavegan_torch.engine.trainer import Trainer
from parallelwavegan_torch.layers.common import ChannelLayerNorm, Dense
from parallelwavegan_torch.layers.duration import (
    DurationPredictor,
    VariancePredictor,
    length_regulator,
    length_regulator_np,
)
from parallelwavegan_torch.losses import DurationPredictorLoss
from parallelwavegan_torch.models import get_model_class
from parallelwavegan_torch.utils import torch_export, torch_import
from parallelwavegan_torch.utils.model_loader import InferenceModel, load_model
from parallelwavegan_torch.utils.params import convert_jax_params, nested
from tests.test_torch_reference_pkl import assert_trees_equal
from tests.torch_helpers import FlaxMasks, perturbed

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOLD = pytest.mark.parametrize("fold", [True, False],
                               ids=["folded", "trainable"])
TRUNK = dict(in_channels=16, channels=32, kernel_size=7,
             upsample_scales=(4, 4), upsample_kernel_sizes=(8, 8),
             resblock_kernel_sizes=(3, 5),
             resblock_dilations=((1, 3), (1, 3)), num_embs=300)
HOP = 16
# name -> (generator type, generator params); ids up to 299, speakers 4
CASES = {
    "token": ("DiscreteSymbolHiFiGANGenerator",
              dict(TRUNK, num_spk_embs=4, spk_emb_dim=16)),
    "token_concat": ("DiscreteSymbolHiFiGANGenerator",
                     dict(TRUNK, num_spk_embs=4, spk_emb_dim=8,
                          concat_spk_emb=True)),
    "feats": ("DiscreteSymbolHiFiGANGenerator",
              dict(TRUNK, num_spk_embs=0, use_embedding_feats=True)),
    "duration": ("DiscreteSymbolDurationGenerator",
                 dict(TRUNK, num_spk_embs=0, duration_chans=24,
                      max_reg_len=40)),
    "f0": ("DiscreteSymbolF0Generator",
           dict(TRUNK, num_spk_embs=0, linear_channel=8)),
    "f0_sum": ("DiscreteSymbolF0Generator",
               dict(TRUNK, num_spk_embs=0, linear_channel=8,
                    use_weight_sum=True, layer_num=3)),
    "f0_fix": ("DiscreteSymbolF0Generator",
               dict(TRUNK, num_spk_embs=0, linear_channel=8,
                    use_weight_sum=True, layer_num=3, use_fix_weight=True)),
    "style": ("DiscreteSymbolStyleMelGANGenerator",
              dict(in_channels=8, aux_channels=16, channels=16, num_embs=300,
                   num_spk_embs=4, spk_emb_dim=16,
                   noise_upsample_scales=(2, 2), upsample_scales=(2, 2, 1))),
}
GENERATOR_CASES = pytest.mark.parametrize("case", sorted(CASES))


def _config(case):
    gen_type, gp = CASES[case]
    return {"generator_type": gen_type, "generator_params": dict(gp),
            "sampling_rate": 8000, "hop_size": HOP, "format": "npy"}


def _flax_module(case):
    gen_type, gp = CASES[case]
    return getattr(jax_discrete, gen_type)(**gp)


@functools.lru_cache(maxsize=None)
def _flax(case):
    """(flax module, variables): the port's trainable init under the flax
    names (``test_flax_tree_is_the_ports`` holds them to flax's), every
    weight-norm g set to 1 (kernels of unit norm a channel: at the init's
    N(0, 0.01) the wave hardly depends on the ids), the duration
    predictor's output bias to 1.2, moved off the init."""
    gen_type, gp = CASES[case]
    gen = get_model_class(gen_type)(**gp, folded=False,
                                    generator=torch.Generator().manual_seed(0))
    state = {k: np.ones_like(t.numpy()) if k.endswith("kernel_g")
             else t.detach().numpy() for k, t in gen.state_dict().items()}
    if "duration_predictor.linear.bias" in state:
        # predicted durations of about 2 (exp(1.2) - 1)
        state["duration_predictor.linear.bias"] = np.array([1.2], np.float32)
    v = {"params": nested(state)}
    return _flax_module(case), perturbed(v, np.random.default_rng(1))


def _np_tree(v):
    return jax.tree.map(np.asarray, v)


def _port(case, fold=True):
    gen_type, gp = CASES[case]
    gen = get_model_class(gen_type)(**gp, folded=fold)
    gen.load_state_dict(convert_jax_params(_np_tree(_flax(case)[1]["params"]),
                                           fold=fold), strict=True)
    return gen.eval()


def _inputs(case, B=2, T=7, seed=0):
    """The case's positional inputs after c, as numpy: c (B, T, .) (ids
    with a speaker column that changes after the first frame, layer ids
    or float features), and ds (B, T) for a duration generator (one row
    all zero, one past max_reg_len), f0 (B, T, 1), or z (B, nf, C)."""
    gen_type, gp = CASES[case]
    rng = np.random.default_rng(seed)
    if gp.get("use_embedding_feats"):
        c = rng.standard_normal((B, T, gp["in_channels"])).astype(np.float32)
    elif gp.get("use_weight_sum"):
        c = rng.integers(0, gp["num_embs"], (B, T, gp["layer_num"]))
    else:
        c = rng.integers(0, gp["num_embs"], (B, T, 1))
        if gp["num_spk_embs"] > 0:
            spk = rng.integers(0, gp["num_spk_embs"], (B, T, 1))
            c = np.concatenate([c, spk], axis=-1)
    if gen_type.endswith("DurationGenerator"):
        ds = rng.integers(0, 4, (B, T))
        ds[0] = 0
        ds[-1, :] = 9  # sums past max_reg_len
        return c, (ds,)
    if gen_type.endswith("F0Generator"):
        return c, (np.abs(150 * rng.standard_normal((B, T, 1))).astype(
            np.float32) / 100,)
    if gen_type.endswith("StyleMelGANGenerator"):
        nf = -(-T // 4)
        return c, (rng.standard_normal((B, nf, gp["in_channels"])).astype(
            np.float32),)
    return c, ()


def _torch_args(c, rest):
    return (torch.from_numpy(np.asarray(c)),) + tuple(
        torch.from_numpy(np.asarray(a)) for a in rest)


def assert_close(got, want, tol=1e-5):
    """|got - want| <= tol (1 + max |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(want).max() > 1e-3
    err = np.abs(got - want).max()
    assert err <= tol * (1 + np.abs(want).max()), err


# ----------------------------------------------------------------------
# layers

def test_dense_and_channel_layer_norm_match_flax():
    """Dense (kernel (in, out), bias) and ChannelLayerNorm (scale, bias,
    eps 1e-12) on perturbed flax parameters: f32 within 1e-6, bf16 (the
    statistics taken in f32 in both) within 2e-2."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32) * 3 + 1
    for flax_mod, port in ((jax_common.Dense(7), Dense(12, 7)),
                           (jax_common.ChannelLayerNorm(12),
                            ChannelLayerNorm(12))):
        v = perturbed(flax_mod.init(jax.random.key(0), x), rng)
        port.load_state_dict(convert_jax_params(_np_tree(v["params"])),
                             strict=True)
        want = np.asarray(flax_mod.apply(v, x))
        got = port(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        vb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), v)
        want16 = np.asarray(flax_mod.apply(vb, jnp.asarray(
            x, jnp.bfloat16)), np.float32)
        got16 = port.to(torch.bfloat16)(torch.from_numpy(x).to(
            torch.bfloat16)).float().detach().numpy()
        assert_close(got16, want16, 2e-2)


@pytest.mark.parametrize("which", ["duration", "variance"])
def test_predictors_match_flax(which, monkeypatch):
    """The duration and the variance predictor, deterministic and with
    dropout on the port's keep masks (handed to flax by ``FlaxMasks``):
    within 1e-5 (1 + max); the duration predictor's integer durations
    equal the JAX ``inference``'s."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    if which == "duration":
        flax_mod = jax_duration.DurationPredictor(
            n_layers=2, n_chans=16, kernel_size=3, dropout_rate=0.5)
        port = DurationPredictor(12, 2, 16, 3, 0.5)
    else:
        flax_mod = jax_duration.VariancePredictor(
            n_layers=3, n_chans=16, kernel_size=5, dropout_rate=0.25)
        port = VariancePredictor(12, 3, 16, 5, dropout_rate=0.25)
    v = perturbed(flax_mod.init(jax.random.key(0), x, True), rng)
    port.load_state_dict(convert_jax_params(_np_tree(v["params"])),
                         strict=True)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        assert_close(port(xt), flax_mod.apply(v, x, True))
        masks = port.draw_dropout_masks(2, 9, torch.Generator().manual_seed(3))
        stand_in = FlaxMasks([m.numpy() for m in masks])
        monkeypatch.setattr("flax.linen.stochastic.random", stand_in)
        want = flax_mod.apply(v, x, False, rngs={"dropout": jax.random.key(1)})
        assert not stand_in.masks
        assert_close(port(xt, False, masks), want)
        with pytest.raises(ValueError, match="masks"):
            port(xt, False)
    assert len(masks) == port.n_layers and masks[0].shape == (2, 9, 16)
    if which == "duration":
        got = port.inference(xt).numpy()
        want = np.asarray(flax_mod.apply(v, x, method="inference"))
        np.testing.assert_array_equal(got, want)
        assert got.max() > 0


def test_length_regulator_matches_jax():
    """Random durations, an all-zero row (duration 1 each), sums past
    max_len (the frames past the last symbol read it, clamped) and short
    of it (zero fill), and the mask: equal to the JAX package's; the
    gradient reaches x; the host version repeats rows."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 6, 3)).astype(np.float32)
    ds = rng.integers(0, 4, (4, 6))
    ds[1] = 0
    ds[2] = 5
    for max_len in (7, 16, 40):
        got, mask = length_regulator(torch.from_numpy(x),
                                     torch.from_numpy(ds), max_len)
        want, want_mask = jax_duration.length_regulator(
            jnp.asarray(x), jnp.asarray(ds), max_len)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert (got[0, ds[0].sum():] == 0).all() and (got[1, 6:] == 0).all()
    xt = torch.from_numpy(x).requires_grad_()
    length_regulator(xt, torch.from_numpy(ds), 16)[0].sum().backward()
    assert xt.grad.abs().sum() > 0
    np.testing.assert_array_equal(
        length_regulator_np(x[0], ds[0]),
        jax_duration.length_regulator_np(x[0], ds[0]))
    np.testing.assert_array_equal(length_regulator_np(x[1], ds[1]), x[1])


def test_duration_loss_matches_jax():
    """MSE against log(ds + offset), plain and masked, as the JAX loss;
    the CVSS-C 24k recipe's ``reduction`` key fails in both criterions."""
    from parallelwavegan_tpu.engine.criterion import (
        build_criterion as jax_build_criterion,
    )
    from parallelwavegan_torch.engine.criterion import build_criterion

    rng = np.random.default_rng(3)
    out = rng.standard_normal((3, 8)).astype(np.float32)
    ds = rng.integers(0, 6, (3, 8))
    mask = rng.random((3, 8)) < 0.6
    for offset in (1.0, 0.5):
        for m in (None, mask):
            got = DurationPredictorLoss(offset)(
                torch.from_numpy(out), torch.from_numpy(ds),
                None if m is None else torch.from_numpy(m))
            want = JaxDurationLoss(offset)(jnp.asarray(out), jnp.asarray(ds),
                                           None if m is None else
                                           jnp.asarray(m))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    path = os.path.join(REPO, "egs/cvss_c/hubert_voc1/conf/"
                        "hifigan_hubert_duration_24k.v1.yaml")
    with open(path) as f:
        config = yaml.safe_load(f)
    assert config["duration_loss_params"] == {"offset": 1.0,
                                              "reduction": "mean"}
    for build in (build_criterion, jax_build_criterion):
        with pytest.raises(TypeError, match="reduction"):
            build(config)
    config["duration_loss_params"] = {"offset": 0.5}
    assert build_criterion(config)["duration"].offset == 0.5


# ----------------------------------------------------------------------
# generators

def _flax_apply(case, v, c, rest, deterministic=True, rngs=None):
    module = _flax_module(case)
    gen_type = CASES[case][0]
    if gen_type.endswith("DurationGenerator"):
        return module.apply(v, c, rest[0], deterministic, rngs=rngs)
    return module.apply(v, c, *rest)


@GENERATOR_CASES
@FOLD
def test_generator_matches_flax(case, fold):
    """Each generator on the same weights and inputs, folded and trainable:
    within 1e-5 (1 + max); a duration generator's predicted log-durations
    too, and its wave at max_reg_len x the hop."""
    c, rest = _inputs(case)
    want = _flax_apply(case, _flax(case)[1], c, rest)
    with torch.no_grad():
        got = _port(case, fold)(*_torch_args(c, rest))
    if isinstance(want, tuple):
        assert got[0].shape == (2, 40 * HOP, 1)
        for g, w in zip(got, want):
            assert_close(g.numpy(), np.asarray(w))
    else:
        assert_close(got.numpy(), np.asarray(want))


def test_duration_generator_with_dropout_and_predicted_durations(
        monkeypatch):
    """deterministic=False on the port's masks (``batch_dropout_masks``),
    handed to flax: within 1e-5; with ds None both packages synthesize
    from the predicted durations."""
    case = "duration"
    c, (ds,) = _inputs(case, seed=4)
    gen = _port(case, fold=False)
    masks = gen.batch_dropout_masks({"c": torch.from_numpy(c)},
                                    torch.Generator().manual_seed(5))
    assert [tuple(m.shape) for m in masks] == [(2, 7, 24)] * 2
    monkeypatch.setattr("flax.linen.stochastic.random",
                        FlaxMasks([m.numpy() for m in masks]))
    want = _flax_apply(case, _flax(case)[1], c, (ds,), False,
                       {"dropout": jax.random.key(0)})
    with torch.no_grad():
        got = gen(torch.from_numpy(c), torch.from_numpy(ds), False, masks)
        for g, w in zip(got, want):
            assert_close(g.numpy(), np.asarray(w))
        free = gen(torch.from_numpy(c))
    want_free = _flax_module(case).apply(_flax(case)[1], c, None, True)
    for g, w in zip(free, want_free):
        assert_close(g.numpy(), np.asarray(w))


@GENERATOR_CASES
def test_flax_tree_is_the_ports(case):
    """flax's own init (shapes by ``jax.eval_shape``) has the trainable
    port module's names and shapes: the F0 generator's input conv plain,
    the duration table num_embs + 1 rows."""
    c, rest = _inputs(case)
    module = _flax_module(case)
    args = (c,) + rest
    if CASES[case][0].endswith("DurationGenerator"):
        args = args + (True,)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)}, *args))
    want = {k: tuple(v.shape) for k, v in convert_jax_params(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                     shapes["params"]), fold=False).items()}
    gen = get_model_class(CASES[case][0])(**CASES[case][1], folded=False)
    assert {k: tuple(v.shape) for k, v in gen.state_dict().items()} == want
    if case == "f0":
        assert "trunk.input_conv.kernel" in want
    if case == "duration":
        assert want["emb.embedding"] == (301, 16)


def test_ids_outside_the_table_raise_before_the_lookup():
    """An id at or past the table (or a negative one, or a speaker past
    spk_emb, or a layer id past its table) raises ValueError on the host,
    before anything goes to the device: in the generator's check_ids, in
    InferenceModel.inference and in the trainer's copy of a batch to the
    device; the JAX lookup returns NaN rows there (a deviation)."""
    model, _ = _serving_pair("token", torch.float32)
    c, _ = _inputs("token")
    trainer = types.SimpleNamespace(generator=model.generator,
                                    device=torch.device("cpu"))
    for bad, where in ((300, 0), (-1, 0), (4, 1)):
        c2 = c.copy()
        c2[0, 0, where] = bad
        for call in (model.generator.check_ids, lambda x: model.inference(
                x[0]), lambda x: Trainer._to_device(trainer, {"c": x})):
            with pytest.raises(ValueError, match="token ids"):
                call(c2)
    model.generator.check_ids(c.astype(np.float32))  # a mel2wav batch
    layers, _ = _inputs("f0_sum")
    _port("f0_sum").check_ids(layers)
    layers[1, 3, 2] = 300
    with pytest.raises(ValueError, match="token ids"):
        _port("f0_sum").check_ids(layers)
    c2 = c.copy()
    c2[0, 2, 0] = 300
    want = np.asarray(_flax_module("token").apply(_flax("token")[1], c2))
    assert np.isnan(want[0]).any() and not np.isnan(want[1]).any()


def test_recipe_scales_and_widths():
    """The upsample factor is the scales' product (320 for the token
    recipes); the token recipe's generator holds about 13 M parameters,
    the duration recipe's predictor 2 x 384 over 1,025 rows."""
    config = chip_smoke.DISCRETE_RECIPES["duration"]
    gen = get_model_class(config["generator_type"])(
        **config["generator_params"])
    assert gen.upsample_factor == 320
    assert gen.emb.embedding.shape == (1025, 512)
    assert gen.duration_predictor.linear.kernel.shape == (384, 1)
    assert gen.max_reg_len == 2048


# ----------------------------------------------------------------------
# the reference .pkl

@pytest.mark.parametrize("case", ["token", "duration", "f0_sum", "style"])
def test_pkl_both_ways_match_jax(tmp_path, case):
    """The JAX exporter's state_dict equals the port's (the duration
    predictor's Sequential indices, LayerNorm weight, Linear weight (O, I),
    the F0 generator's bare ``weights``, its plain input conv ``weight``);
    both importers give the same tree; a .pkl the port writes reads back
    through the JAX importer and serves through load_model as the JAX
    InferenceModel does; the port's export of that tree equals the file."""
    config = _config(case)
    gp = config["generator_params"]
    gen_type = config["generator_type"]
    params = _np_tree(_flax(case)[1]["params"])
    state = jax_export.export_generator_state_dict(params, gen_type, config)
    mine = torch_export.export_generator_state_dict(params, gen_type, config)
    assert sorted(mine) == sorted(state)
    expect = {"token": ("emb.weight", "spk_emb.weight",
                        "input_conv.weight_v", "upsamples.1.1.weight_g"),
              "duration": ("duration_predictor.conv.1.0.weight_v",
                           "duration_predictor.conv.0.2.weight",
                           "duration_predictor.linear.weight"),
              "f0_sum": ("weights", "emb.2.weight", "input_conv.weight",
                         "f0_embedding.weight"),
              "style": ("emb.weight", "noise_upsample.2.weight_v",
                        "blocks.1.tade2.gated_conv.0.weight_g")}[case]
    for key in expect:
        assert key in state, key
    for key in state:
        np.testing.assert_array_equal(mine[key], state[key], err_msg=key)
    tensors = {k: torch.from_numpy(np.array(a)) for k, a in state.items()}
    got = torch_import.import_model_params(tensors, gen_type, gp)
    assert_trees_equal(got, jax_import.import_model_params(
        tensors, gen_type, gp))
    path = str(tmp_path / "checkpoint-3steps.pkl")
    torch_export.save_reference_checkpoint(
        path, nested(_port(case, fold=False).state_dict()), config, steps=3)
    back = jax_load_reference_checkpoint(path, config)
    assert_trees_equal(back["generator"], got)
    written = torch.load(path, weights_only=True)["model"]["generator"]
    again = torch_export.export_generator_state_dict(
        back["generator"]["params"], gen_type, config)
    assert sorted(written) == sorted(again)
    for key, value in written.items():
        np.testing.assert_array_equal(value.numpy(), again[key], err_msg=key)
    model = load_model(path, config, device="cpu")
    ref = JaxInferenceModel(config, {"params": jax.tree.map(
        jnp.asarray, back["generator"]["params"])})
    c, rest = _inputs(case, B=1, T=4)
    if case == "style":  # on one noise frame, given to both
        with torch.no_grad():
            got = model.generator(*_torch_args(c, rest)).numpy()
        assert_close(got, ref.generator.apply(ref.variables, c, *rest))
        return
    f0 = rest[0][0] if case.startswith("f0") else None
    assert_close(model.inference(c[0], f0=f0), ref.inference(c[0], f0=f0))


# ----------------------------------------------------------------------
# serving

def _serving_pair(case, dtype):
    config = _config(case)
    v = _flax(case)[1]
    jdtype = {torch.float32: None, torch.bfloat16: jnp.bfloat16}[dtype]
    return (InferenceModel(config, _np_tree(v), dtype=dtype, device="cpu"),
            JaxInferenceModel(config, v, dtype=jdtype))


@pytest.mark.parametrize("case", ["token", "duration", "f0", "style"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_inference_matches_jax(case, dtype):
    """InferenceModel.inference on one utterance (ids <= 256, which bf16
    holds exactly; see test_bf16_serving_reads_ids_above_256_as_jax_cannot)
    against the JAX InferenceModel's: f32 within 1e-5 (1 + max), bf16
    within 2e-2; a duration generator's wave cut to sum(predicted ds) x
    hop, equal in length to the JAX one's; the token StyleMelGAN on the
    JAX path's one noise frame (z drawn from a generator seeded 0, handed
    to the JAX module)."""
    model, ref = _serving_pair(case, dtype)
    c, rest = _inputs(case, B=1, T=4 if case == "style" else 7, seed=9)
    c = np.where(np.arange(c.shape[-1]) == 0, c % 257, c)
    f0 = rest[0][0] if case == "f0" else None
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    if case == "style":
        g = torch.Generator().manual_seed(0)
        got = model.inference(c[0], generator=g)
        z = torch.randn((1, 1, 8), generator=torch.Generator().manual_seed(
            0)).to(dtype).float().numpy()
        jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        want = np.asarray(ref.generator.apply(
            ref.variables, jnp.asarray(c), jnp.asarray(z, jdtype)),
            np.float32)[0]
        assert_close(got, want, tol)
        assert got.shape == (4 * 4, 1)
        return
    got = model.inference(c[0], f0=f0)
    want = ref.inference(c[0].astype(np.float32), f0=f0)
    assert got.dtype == np.float32
    assert_close(got, want, tol)
    if case == "duration":
        log_d = model.predicted_log_durations(c[0])
        ds = np.clip(np.round(np.exp(log_d) - 1.0), 0, None)
        assert got.shape == (int(ds.sum()) * HOP, 1)


def test_bf16_serving_reads_ids_above_256_as_jax_cannot():
    """The JAX serving path casts float ids to the serving dtype, so in
    bf16 the id 257 reads as 256 (and 299 as 300, past the table: NaN);
    the port keeps ids int64 in every dtype: its bf16 wave for 257 is the
    bf16 wave of 257 (the f32 one within 2e-2), not of 256."""
    v = jax.tree.map(np.array, _flax("token")[1])
    table = v["params"]["emb"]["embedding"]
    table[256], table[257] = 3.0, -3.0  # rows whose waves differ
    config = _config("token")
    model = InferenceModel(config, v, dtype=torch.bfloat16, device="cpu")
    ref = JaxInferenceModel(config, jax.tree.map(jnp.asarray, v),
                            dtype=jnp.bfloat16)
    c = np.array([[257, 1]] * 5)
    c256 = np.array([[256, 1]] * 5)
    j257 = ref.inference(c.astype(np.float32))
    j256 = ref.inference(c256.astype(np.float32))
    np.testing.assert_array_equal(j257, j256)
    got, got256 = model.inference(c), model.inference(c256)
    assert np.abs(got - got256).max() > 0.1 * np.abs(got256).max()
    exact = InferenceModel(config, v, device="cpu").inference(c)
    assert_close(got, exact, 2e-2)


def test_token_style_melgan_serving_past_one_noise_frame():
    """The JAX path draws one noise frame (1, 1, C): an utterance longer
    than one noise frame (here 4 ids) fails its shapes there. The port
    draws noise_frames(T') frames: 9 ids pad to 12 (3 frames), the wave is
    cut to 9 x 4 samples and equals the module's forward on those ids and
    that noise."""
    model, ref = _serving_pair("style", torch.float32)
    c, _ = _inputs("style", B=1, T=9, seed=3)
    with pytest.raises(Exception):
        ref.inference(c[0].astype(np.float32))
    got = model.inference(c[0], generator=torch.Generator().manual_seed(2))
    z = torch.randn((1, 3, 8), generator=torch.Generator().manual_seed(2))
    padded = np.concatenate([c[0], np.repeat(c[0, -1:], 3, 0)])[None]
    with torch.no_grad():
        want = model.generator(torch.from_numpy(padded), z)[0, :36].numpy()
    np.testing.assert_array_equal(got, want)


def test_batched_serving_refuses_the_discrete_families():
    model, _ = _serving_pair("token", torch.float32)
    c, _ = _inputs("token", B=1)
    with pytest.raises(ValueError, match="one utterance"):
        model.synthesize_batch([c[0]])
    with pytest.raises(NotImplementedError, match="DiscreteSymbol"):
        model.inference_chunked(c[0], chunk_frames=2, context_frames=1)
    with pytest.raises(ValueError, match="durations"):
        model.predicted_log_durations(c[0])


# ----------------------------------------------------------------------
# the CLIs

def _write_token_dumps(root, case, n, rng):
    """-feats.npy of ids (frames, 1|2) and, for the F0 generator,
    -f0.npy (frames,)."""
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        c, rest = _inputs(case, B=1, T=5 + 2 * i, seed=int(rng.integers(99)))
        c = np.where(np.arange(c.shape[-1]) == 0, c % 257, c)
        np.save(os.path.join(root, f"utt{i}-feats.npy"), c[0])
        if case == "f0":
            np.save(os.path.join(root, f"utt{i}-f0.npy"), rest[0][0, :, 0])


def _run_jax_cli(monkeypatch, module, argv):
    monkeypatch.setenv("PARALLELWAVEGAN_TPU_CACHE_DIR", "")
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


@pytest.mark.parametrize("case", ["token", "duration", "f0"])
def test_decode_cli_matches_the_jax_cli(tmp_path, monkeypatch, case):
    """bin.decode over npy token dumps (with -f0.npy for the F0 generator,
    read by default): each wave equals the JAX CLI's on the same .gckpt
    (16-bit, within one step), frames x hop samples but for a duration
    generator, whose length its predicted durations decide."""
    from scipy.io import wavfile

    config = _config(case)
    ckpt = str(tmp_path / "generator.gckpt")
    save_generator_checkpoint(ckpt, _port(case))
    conf = str(tmp_path / "config.json")
    with open(conf, "w") as f:
        json.dump(config, f)
    dump = str(tmp_path / "dump")
    _write_token_dumps(dump, case, 3, np.random.default_rng(4))
    outs = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    decode_cli.main(["--dumpdir", dump, "--checkpoint", ckpt, "--config",
                     conf, "--outdir", outs["port"], "--device", "cpu"])
    _run_jax_cli(monkeypatch, jax_decode_cli, [
        "--dumpdir", dump, "--checkpoint", ckpt, "--config", conf,
        "--outdir", outs["jax"]])
    for i in range(3):
        got, want = (wavfile.read(os.path.join(d, f"utt{i}_gen.wav"))[1]
                     for d in (outs["port"], outs["jax"]))
        assert got.shape == want.shape
        if case != "duration":
            assert got.shape == ((5 + 2 * i) * HOP,)
        assert np.abs(got.astype(np.int32) - want).max() <= 1


@pytest.mark.parametrize("case", ["token", "duration"])
def test_decode_from_text_matches_the_jax_cli(tmp_path, monkeypatch, case):
    """bin.decode_from_text with --unique (and --spk-idx where the model
    has speakers) against the JAX CLI on the same .pkl: the same waves
    (16-bit, within one step)."""
    from scipy.io import wavfile

    from parallelwavegan_tpu.bin import decode_from_text as jax_cli

    config = _config(case)
    path = str(tmp_path / "checkpoint-1steps.pkl")
    torch_export.save_reference_checkpoint(
        path, nested(_port(case, fold=False).state_dict()), config)
    conf = str(tmp_path / "config.json")
    with open(conf, "w") as f:
        json.dump(config, f)
    text = str(tmp_path / "text")
    rng = np.random.default_rng(6)
    with open(text, "w") as f:
        for i in range(2):
            toks = np.repeat(rng.integers(0, 257, 4), rng.integers(1, 4, 4))
            f.write(f"utt{i} " + " ".join(map(str, toks)) + "\n")
    extra = ["--unique"] + (["--spk-idx", "3"] if case == "token" else [])
    argv = ["--text", text, "--checkpoint", path, "--config", conf] + extra
    decode_from_text.main(argv + ["--outdir", str(tmp_path / "port"),
                                  "--device", "cpu"])
    _run_jax_cli(monkeypatch, jax_cli, argv + ["--outdir",
                                                str(tmp_path / "jax")])
    for i in range(2):
        got, want = (wavfile.read(str(tmp_path / d / f"utt{i}_gen.wav"))[1]
                     for d in ("port", "jax"))
        assert got.shape == want.shape and len(got) > 0
        assert np.abs(got.astype(np.int32) - want).max() <= 1
    lines = decode_from_text.token_lines(text, True, 3)
    assert lines[0][1].shape[1] == 2 and (lines[0][1][:, 1] == 3).all()
    assert (np.diff(lines[0][1][:, 0]) != 0).all()


# ----------------------------------------------------------------------
# chip_smoke's recipes

@pytest.mark.parametrize("name, path", [
    ("token", "egs/vctk/hubert_voc1/conf/hifigan_hubert.v1.yaml"),
    ("duration", "egs/opencpop/token_voc1/conf/"
                 "hifigan_token_16k_duration.v1.yaml"),
    ("f0", "egs/opencpop/token_voc1/conf/hifigan_token_24k_nodp_f0.v1.yaml"),
    ("style", "egs/vctk/hubert_voc1/conf/style_melgan_hubert.v1.yaml"),
])
def test_smoke_discrete_recipes_are_the_yaml(name, path):
    """chip_smoke.DISCRETE_RECIPES hold the four recipes as their yaml
    says (format npy for the smoke's dumps, the StyleMelGAN
    discriminator's pqmf "None" strings as None)."""
    with open(os.path.join(REPO, path)) as f:
        want = yaml.safe_load(f)
    want["format"] = "npy"
    got = json.loads(json.dumps(chip_smoke.DISCRETE_RECIPES[name]))
    if name == "style":
        pq = want["discriminator_params"]["pqmf_params"]
        want["discriminator_params"]["pqmf_params"] = [
            [None if v == "None" else v for v in row] for row in pq]
    assert got == json.loads(json.dumps(want))
