"""The port's serving export (``utils/export.py``, ``torch.export``) against
``InferenceModel`` and against the JAX package's ``export_generator`` /
``load_exported`` (StableHLO) on the same weights, for each family that
the JAX function exports; the refusal of the others."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelwavegan_tpu.models import get_model_class as jax_model_class
from parallelwavegan_tpu.utils.export import (
    export_generator as jax_export_generator,
    load_exported as jax_load_exported,
)
from parallelwavegan_tpu.utils.model_loader import (
    InferenceModel as JaxInferenceModel,
)
from parallelwavegan_torch.utils.export import (
    NOT_EXPORTABLE,
    export_generator,
    load_exported,
)
from parallelwavegan_torch.utils.model_loader import InferenceModel
from tests.torch_helpers import flax_generator_kwargs, melgan_perturbed

torch.set_num_threads(2)

# the exported program against the JAX one: max |a - b| <= TOL (1 + max)
TOL = 1e-5
FRAMES = 16
TRUNK = dict(in_channels=16, channels=32, kernel_size=7,
             upsample_scales=(4, 4), upsample_kernel_sizes=(8, 8),
             resblock_kernel_sizes=(3, 5),
             resblock_dilations=((1, 3), (1, 3)), num_embs=300)
# name -> (generator type, generator params, num_mels)
FAMILIES = {
    "melgan": ("MelGANGenerator",
               dict(in_channels=20, channels=32, upsample_scales=(4, 4),
                    stacks=2), 20),
    "multi_band_melgan": ("MelGANGenerator",
                          dict(in_channels=20, out_channels=4, channels=32,
                               upsample_scales=(4, 2), stacks=1), 20),
    "hifigan": ("HiFiGANGenerator",
                dict(in_channels=20, channels=32, upsample_scales=(4, 4),
                     upsample_kernel_sizes=(8, 8),
                     resblock_kernel_sizes=(3, 5),
                     resblock_dilations=((1, 3), (1, 3))), 20),
    "token_hifigan": ("DiscreteSymbolHiFiGANGenerator",
                      dict(TRUNK, num_spk_embs=4, spk_emb_dim=16), 2),
}


def _family(name):
    gen_type, gp, num_mels = FAMILIES[name]
    config = {"generator_type": gen_type, "generator_params": gp,
              "num_mels": num_mels, "sampling_rate": 8000}
    rng = np.random.default_rng(3)
    if gen_type.startswith("DiscreteSymbol"):
        mel = np.stack([rng.integers(0, 300, (2, FRAMES)),
                        rng.integers(0, 4, (2, 1)).repeat(FRAMES, 1)],
                       axis=-1).astype(np.float32)
    else:
        mel = rng.standard_normal((2, FRAMES, num_mels)).astype(np.float32)
    module = jax_model_class(gen_type)(**gp)
    v = jax.tree.map(np.asarray, melgan_perturbed(
        module.init({"params": jax.random.key(0)}, jnp.asarray(mel))))
    return config, v, mel


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL * (1 + np.abs(want).max()), (what, err)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_exported_program_matches_serving_and_jax(name, tmp_path):
    """The exported program at (2, 16, num_mels) equals ``InferenceModel``'s
    module forward (PQMF synthesis after the multi-band generator) on the
    same input, and lies within 1e-5 (1 + max) of the JAX package's
    exported program on the same weights; a program written to a path
    loads back to the same numbers."""
    config, v, mel = _family(name)
    model = InferenceModel(config, v, device="cpu")
    path = str(tmp_path / "gen.pt2")
    blob = export_generator(model, batch_size=2, num_frames=FRAMES,
                            path=path)
    with open(path, "rb") as f:
        assert f.read() == blob
    got = load_exported(blob)(torch.from_numpy(mel))
    with torch.no_grad():
        y = model.generator(torch.from_numpy(mel))
        if model.pqmf is not None:
            y = model.pqmf.synthesis(y)
    assert torch.equal(got, y)
    assert torch.equal(load_exported(path)(torch.from_numpy(mel)), got)
    hop = int(np.prod(config["generator_params"]["upsample_scales"]))
    bands = config["generator_params"].get("out_channels", 1)
    assert got.shape == (2, FRAMES * hop * bands, 1)
    jax_model = JaxInferenceModel(config, v)
    want = jax_load_exported(jax_export_generator(jax_model, 2, FRAMES))(mel)
    _close(got.numpy(), want[0] if isinstance(want, (list, tuple)) else want,
           name)


@pytest.mark.parametrize("gen_type", sorted(NOT_EXPORTABLE))
def test_other_families_are_refused(gen_type):
    """A family whose forward does not take the mel alone raises a
    ``ValueError`` naming it and why, before anything is traced."""
    with pytest.raises(ValueError, match=f"{gen_type} cannot be exported"):
        export_generator(types.SimpleNamespace(gen_type=gen_type))


def test_pwg_is_refused_as_the_jax_export_fails():
    """Parallel WaveGAN's forward takes the noise first: the JAX function
    fails in its apply (no c), the port refuses it by name."""
    kw = flax_generator_kwargs(layers=4, stacks=2, aux_context_window=0)
    config = {"generator_type": "ParallelWaveGANGenerator",
              "generator_params": kw, "num_mels": 20}
    module = jax_model_class("ParallelWaveGANGenerator")(**kw)
    v = module.init({"params": jax.random.key(0)}, jnp.zeros((1, 64, 1)),
                    jnp.zeros((1, 16, 20)))
    with pytest.raises(TypeError, match="'c'"):
        jax_export_generator(JaxInferenceModel(config, v), 1, 16)
    with pytest.raises(ValueError, match="takes the noise z first"):
        export_generator(InferenceModel(config, jax.tree.map(np.asarray, v),
                                        device="cpu"))


def test_f0_generator_is_refused_where_the_jax_export_drops_the_f0():
    """The JAX function exports the F0 generator by applying it to the ids
    alone, which skips its f0; the port's serving reads the f0, so its
    export refuses the family (a deviation kept on purpose)."""
    gp = dict(TRUNK, num_spk_embs=0, linear_channel=8)
    config = {"generator_type": "DiscreteSymbolF0Generator",
              "generator_params": gp, "num_mels": 1}
    module = jax_model_class("DiscreteSymbolF0Generator")(**gp)
    v = module.init({"params": jax.random.key(0)}, jnp.ones((1, 16, 1)))
    y = jax_load_exported(jax_export_generator(
        JaxInferenceModel(config, v), 1, 16))(np.ones((1, 16, 1), np.float32))
    assert np.shape(y) == (1, 256, 1)
    with pytest.raises(ValueError, match="takes the f0 besides the ids"):
        export_generator(types.SimpleNamespace(
            gen_type="DiscreteSymbolF0Generator"))
