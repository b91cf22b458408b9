"""Reference PyTorch checkpoints (``checkpoint-<N>steps.pkl``) in the port
against the JAX package on the CPU: files written by the JAX exporter
serve through the port's load_model as through the JAX one (Parallel
WaveGAN, HiFi-GAN, MelGAN, multi-band MelGAN); the port's importer gives
the JAX importer's trees exactly, the discriminators' included (built here
as reference-named state dicts); the port's exporter writes what the JAX
importer reads back exactly; unported families raise."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelwavegan_tpu.engine.checkpoint import (
    load_reference_checkpoint as jax_load_reference_checkpoint,
)
from parallelwavegan_tpu.models import get_model_class as jax_model_class
from parallelwavegan_tpu.utils import torch_export as jax_export
from parallelwavegan_tpu.utils import torch_import as jax_import
from parallelwavegan_tpu.utils.model_loader import load_model as jax_load_model
from parallelwavegan_tpu.utils.params import (
    fold_weight_norm as jax_fold_weight_norm,
)
from parallelwavegan_torch.engine.checkpoint import load_reference_checkpoint
from parallelwavegan_torch.models import get_model_class
from parallelwavegan_torch.utils import torch_export, torch_import
from parallelwavegan_torch.utils.model_loader import load_model
from parallelwavegan_torch.utils.params import (
    convert_jax_params,
    folded_state_dict,
    nested,
)
from tests.torch_helpers import (
    flax_generator_kwargs,
    melgan_perturbed,
    small_hifigan_train_config,
)

torch.set_num_threads(2)

MELGAN = dict(in_channels=10, channels=32, upsample_scales=(4, 2), stacks=2)
HIFIGAN = dict(in_channels=10, channels=32, upsample_scales=(4, 2),
               upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3, 5),
               resblock_dilations=((1, 3), (1, 3)))
GENERATORS = {
    "pwg": ("ParallelWaveGANGenerator",
            dict(flax_generator_kwargs(layers=4, stacks=2, aux_channels=10))),
    "hifigan": ("HiFiGANGenerator", HIFIGAN),
    "melgan": ("MelGANGenerator", MELGAN),
    "mb_melgan": ("MelGANGenerator", dict(MELGAN, out_channels=4)),
}


def _flax_init(name, kw, x):
    """(flax module, perturbed variables) for a port-style kwargs dict."""
    flax_kw = {k: v for k, v in kw.items() if k != "in_channels"}
    module = jax_model_class(name)(**flax_kw)
    return module, melgan_perturbed(module.init(jax.random.key(0), *x))


def _generator(which):
    name, kw = GENERATORS[which]
    c = jnp.zeros((1, 12, 10))
    if name == "ParallelWaveGANGenerator":
        _, v = _flax_init(name, kw, (jnp.zeros((1, 32, 1)), c))
    else:
        _, v = _flax_init(name, kw, (c,))
    config = {"generator_type": name,
              "generator_params": dict(kw, use_weight_norm=True)}
    return config, v


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key, a in got.items():
        assert a.dtype == want[key].dtype and a.shape == want[key].shape, key
        np.testing.assert_array_equal(a, want[key], err_msg=key)


@pytest.mark.parametrize("which", sorted(GENERATORS))
def test_jax_written_pkl_serves_like_jax(tmp_path, which):
    """A .pkl from the JAX exporter: the port's load_model and the JAX one
    give the same waveform (a Parallel WaveGAN on the same noise)."""
    config, v = _generator(which)
    path = str(tmp_path / "checkpoint-100steps.pkl")
    jax_export.save_reference_checkpoint(path, v["params"], config, steps=100)
    ref = jax_load_model(path, config)
    model = load_model(path, config, device="cpu")
    mel = np.random.default_rng(1).standard_normal((13, 10)).astype(
        np.float32)
    fn, args, _ = ref.prepare_batch([mel], bucket_size=1)
    want = np.asarray(fn(*args), np.float32)
    fn_t, (c, _), _ = model.prepare_batch([mel], bucket_size=1)
    z = None if args[2] is None else torch.from_numpy(np.array(args[2]))
    got = fn_t(c, z).numpy()
    assert got.shape == want.shape
    assert model.upsample_factor == ref.upsample_factor
    assert np.abs(want).max() > 0.05
    assert np.abs(got - want).max() <= 1e-5 * (1 + np.abs(want).max())
    steps = load_reference_checkpoint(path, config)["steps"]
    assert steps == jax_load_reference_checkpoint(path, config)["steps"] == 100
    with pytest.raises(ValueError, match="EMA"):
        load_model(path, config, device="cpu", use_ema=True)


@pytest.mark.parametrize("which", sorted(GENERATORS))
def test_generator_import_and_export_match_jax(which):
    """The reference state_dict the JAX exporter writes imports to the
    same tree through both importers, and the port's exporter writes the
    JAX exporter's state_dict."""
    config, v = _generator(which)
    params = jax.tree.map(np.asarray, v["params"])
    state = jax_export.export_generator_state_dict(
        params, config["generator_type"], config)
    mine = torch_export.export_generator_state_dict(
        params, config["generator_type"], config)
    assert sorted(mine) == sorted(state)
    for key in state:
        np.testing.assert_array_equal(mine[key], state[key], err_msg=key)
    tensors = {k: torch.from_numpy(np.array(a))
               for k, a in state.items()}
    got = torch_import.import_model_params(
        tensors, config["generator_type"], config["generator_params"])
    want = jax_import.import_model_params(
        tensors, config["generator_type"], config["generator_params"])
    assert_trees_equal(got, want)
    assert_trees_equal(got["params"], params)


# --- reference-named state dicts of the discriminators ----------------------
def _pwg_d_names(layers):
    def name(path):
        m = re.match(r"^conv_(\d+)$", path)
        return (f"conv_layers.{2 * int(m.group(1))}" if m
                else f"conv_layers.{2 * (layers - 1)}")

    return name


def _rpwg_d_name(path):
    if path == "first_conv":
        return "first_conv.0"
    m = re.match(r"^last_conv_(\d+)$", path)
    if m:
        return f"last_conv_layers.{2 * int(m.group(1)) + 1}"
    return path.replace("conv_layers_", "conv_layers.").replace("/", ".")


def _msmpd_name(last_msd_layer):
    def name(path):
        m = re.match(r"^msd/discriminators_(\d+)/layer_(\d+)$", path)
        if m:
            tail = "" if int(m.group(2)) == last_msd_layer else ".0"
            return f"msd.discriminators.{m.group(1)}.layers.{m.group(2)}{tail}"
        m = re.match(r"^mpd/discriminators_(\d+)/convs_(\d+)$", path)
        if m:
            return f"mpd.discriminators.{m.group(1)}.convs.{m.group(2)}.0"
        m = re.match(r"^mpd/discriminators_(\d+)/output_conv$", path)
        return f"mpd.discriminators.{m.group(1)}.output_conv"

    return name


def _melgan_msd_name(last_layer):
    def name(path):
        m = re.match(r"^discriminators_(\d+)/layer_(\d+)$", path)
        j = int(m.group(2))
        tail = ".1" if j == 0 else "" if j == last_layer else ".0"
        return f"discriminators.{m.group(1)}.layers.{j}{tail}"

    return name


def reference_state_dict(variables, name_of):
    """A flax discriminator's variables as the reference's state_dict:
    weight norm as weight_v / weight_g, spectral norm as weight_orig with
    its power-iteration vectors weight_u / weight_v."""
    spectral = _flat(variables.get("spectral", {}))
    paths = {}
    for key, a in _flat(variables["params"]).items():
        path, leaf = key.rsplit("/", 1)
        paths.setdefault(path, {})[leaf] = a
    rng = np.random.default_rng(0)
    state = {}
    for path, leaves in paths.items():
        prefix = name_of(path)
        k = leaves.get("kernel", leaves.get("kernel_v"))
        perm = (3, 2, 0, 1) if k.ndim == 4 else (2, 1, 0)
        if "kernel_v" in leaves:
            state[f"{prefix}.weight_v"] = k.transpose(perm)
            g = leaves["kernel_g"].reshape(-1)
            state[f"{prefix}.weight_g"] = g.reshape((-1,) + (1,) * (k.ndim - 1))
        elif f"{path}/u" in spectral:
            state[f"{prefix}.weight_orig"] = k.transpose(perm)
            state[f"{prefix}.weight_u"] = spectral[f"{path}/u"]
            state[f"{prefix}.weight_v"] = rng.standard_normal(
                int(np.prod(k.shape[:-1]))).astype(np.float32)
        else:
            state[f"{prefix}.weight"] = k.transpose(perm)
        if "bias" in leaves:
            state[f"{prefix}.bias"] = leaves["bias"]
    return {k: torch.from_numpy(np.array(a))
            for k, a in state.items()}


def _discriminator(which):
    x = jnp.zeros((1, 512, 1))
    if which == "pwg":
        kw = dict(layers=5, conv_channels=8)
        name, names = "ParallelWaveGANDiscriminator", _pwg_d_names(5)
    elif which == "residual_pwg":
        kw = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
                  skip_channels=8)
        name, names = "ResidualParallelWaveGANDiscriminator", _rpwg_d_name
    elif which == "hifigan_msmpd":
        kw = small_hifigan_train_config()["discriminator_params"]
        name = "HiFiGANMultiScaleMultiPeriodDiscriminator"
        n_msd = len(kw["scale_discriminator_params"]["downsample_scales"]) + 3
        names = _msmpd_name(n_msd - 1)
    else:
        kw = dict(scales=2, channels=4, downsample_scales=(4, 4),
                  max_downsample_channels=16)
        name = "MelGANMultiScaleDiscriminator"
        names = _melgan_msd_name(len(kw["downsample_scales"]) + 2)
    module = jax_model_class(name)(**kw)
    v = melgan_perturbed(module.init({"params": jax.random.key(0)}, x))
    return name, kw, jax.tree.map(np.asarray, v), names


@pytest.mark.parametrize("which", ["pwg", "residual_pwg", "hifigan_msmpd",
                                   "melgan_msd"])
def test_discriminator_import_matches_jax(which):
    """The port's importer gives the JAX importer's tree, which loads into
    the port's module of that discriminator (training form, strictly) and
    computes the flax module's outputs to 1e-5 (1 + max)."""
    name, kw, v, names = _discriminator(which)
    state = reference_state_dict(v, names)
    got = torch_import.import_model_params(state, name, kw)
    want = jax_import.import_model_params(state, name, kw)
    assert_trees_equal(got, want)
    assert_trees_equal(got["params"], v["params"])
    if "spectral" in v:
        assert_trees_equal(got["spectral"], v["spectral"])
    port = get_model_class(name)(**kw, folded=False)
    port.load_state_dict(convert_jax_params(
        got["params"], fold=False, spectral=got.get("spectral")), strict=True)
    port.eval()
    x = np.random.default_rng(2).standard_normal((1, 512, 1)).astype(
        np.float32)
    ref = jax_model_class(name)(**kw).apply(v, jnp.asarray(x))
    outs = port(torch.from_numpy(x))
    flat = lambda o: [t for a in o for t in flat(a)] if isinstance(  # noqa: E731
        o, (list, tuple)) else [o]
    assert len(flat(outs)) == len(flat(ref))
    for a, b in zip(flat(outs), flat(ref)):
        b = np.asarray(b)
        assert np.abs(a.detach().numpy() - b).max() <= 1e-5 * (
            1 + np.abs(b).max())


def test_mb_melgan_pkl_with_its_discriminator_loads(tmp_path):
    """A multi-band MelGAN .pkl as the reference trainer writes it, with
    the multi-scale discriminator beside the generator: it serves, and its
    discriminator tree converts as the JAX package converts it."""
    config, v = _generator("mb_melgan")
    name, kw, dv, names = _discriminator("melgan_msd")
    config = dict(config, discriminator_type=name, discriminator_params=kw)
    path = str(tmp_path / "checkpoint-7steps.pkl")
    jax_export.save_reference_checkpoint(path, v["params"], config, steps=7)
    ckpt = torch.load(path, weights_only=True)
    ckpt["model"]["discriminator"] = reference_state_dict(dv, names)
    torch.save(ckpt, path)
    got = load_reference_checkpoint(path, config)
    want = jax_load_reference_checkpoint(path, config)
    assert_trees_equal(got["discriminator"], want["discriminator"])
    assert_trees_equal(got["generator"], want["generator"])
    model = load_model(path, config, device="cpu")
    mel = np.zeros((5, 10), np.float32)
    assert model.inference(mel).shape == (5 * 8 * 4, 1)


@pytest.mark.parametrize("which", sorted(GENERATORS))
def test_port_written_pkl_reads_back_through_jax(tmp_path, which):
    """A trainable port module (kernel_v / kernel_g) written by the port's
    exporter: the JAX importer gives its parameters back exactly, and a
    folded module's kernels within f32 rounding (exported as v = w,
    g = ||w||)."""
    name, kw = GENERATORS[which]
    config = {"generator_type": name,
              "generator_params": dict(kw, use_weight_norm=True)}
    gen = get_model_class(name)(**kw, folded=False,
                                generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "checkpoint-1steps.pkl")
    torch_export.save_reference_checkpoint(path, nested(gen.state_dict()),
                                           config, steps=1)
    back = jax_load_reference_checkpoint(path, config)
    want = {k: t.numpy() for k, t in gen.state_dict().items()}
    assert_trees_equal(back["generator"]["params"], nested(want))
    assert back["steps"] == 1
    folded = get_model_class(name)(**kw)
    folded.load_state_dict(folded_state_dict(gen))
    torch_export.save_reference_checkpoint(path, nested(folded.state_dict()),
                                           config)
    back = _flat(jax_fold_weight_norm(
        jax_load_reference_checkpoint(path, config)["generator"]["params"]))
    for key, t in folded.state_dict().items():
        np.testing.assert_allclose(back[key.replace(".", "/")], t.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=key)


_DISCRETE_TRUNK = {"in_channels": 8, "channels": 16, "num_embs": 10,
                   "upsample_scales": (2, 2), "upsample_kernel_sizes": (4, 4),
                   "resblock_kernel_sizes": (3,), "resblock_dilations": ((1,),)}
_DISCRETE = {
    "DiscreteSymbolStyleMelGANGenerator": {
        "in_channels": 4, "aux_channels": 8, "channels": 8, "num_embs": 10,
        "num_spk_embs": 2, "spk_emb_dim": 8, "noise_upsample_scales": (2,),
        "upsample_scales": (2, 1)},
    "DiscreteSymbolHiFiGANGenerator": dict(_DISCRETE_TRUNK, num_spk_embs=2,
                                           spk_emb_dim=8),
    "DiscreteSymbolF0Generator": dict(_DISCRETE_TRUNK, num_spk_embs=0,
                                      linear_channel=4, use_weight_sum=True,
                                      layer_num=2),
    "DiscreteSymbolDurationGenerator": dict(_DISCRETE_TRUNK, num_spk_embs=0,
                                            duration_chans=8, max_reg_len=8),
}


@pytest.mark.parametrize("family", sorted(_DISCRETE))
def test_unported_family_raises_naming_it(tmp_path, family):
    """The discrete-symbol families, once unported, now carry across: the
    port's exporter gives the JAX exporter's state_dict, the port's
    importer the JAX importer's tree, and load_model builds from a .pkl;
    a family neither package knows still raises naming it."""
    gp = _DISCRETE[family]
    config = {"generator_type": family, "generator_params": gp}
    gen = get_model_class(family)(**gp, folded=False,
                                  generator=torch.Generator().manual_seed(0))
    params = nested({k: v.detach().numpy()
                     for k, v in gen.state_dict().items()})
    state = torch_export.export_generator_state_dict(params, family, config)
    want = jax_export.export_generator_state_dict(params, family, config)
    assert sorted(state) == sorted(want)
    for key in state:
        np.testing.assert_array_equal(state[key], want[key], err_msg=key)
    tensors = {k: torch.from_numpy(v) for k, v in state.items()}
    assert_trees_equal(torch_import.import_model_params(tensors, family, gp),
                       jax_import.import_model_params(tensors, family, gp))
    path = str(tmp_path / "checkpoint-1steps.pkl")
    torch_export.save_reference_checkpoint(path, params, config, steps=1)
    model = load_model(path, config, device="cpu")
    assert type(model.generator).__name__ == family
    with pytest.raises(KeyError, match="NoSuchGenerator"):
        torch_import.import_model_params({}, "NoSuchGenerator", {})
    with pytest.raises(NotImplementedError, match="NoSuchGenerator"):
        torch_export.export_generator_state_dict({}, "NoSuchGenerator", {})
