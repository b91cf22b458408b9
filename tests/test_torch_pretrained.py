"""The port's local pretrained tags (``utils/pretrained.py``) against the
JAX package's resolver on one cache layout, with the cache's files made by
the port's ``bin.convert_checkpoint`` and served by ``load_model``."""

import os

import numpy as np
import pytest
import torch

from parallelwavegan_tpu.utils import pretrained as jax_pretrained
from parallelwavegan_torch.bin import convert_checkpoint
from parallelwavegan_torch.models import get_model_class
from parallelwavegan_torch.utils import pretrained
from parallelwavegan_torch.utils.io import save_config
from parallelwavegan_torch.utils.model_loader import load_model
from parallelwavegan_torch.utils.params import nested
from parallelwavegan_torch.utils.torch_export import save_reference_checkpoint
from tests.torch_helpers import small_melgan_train_config

torch.set_num_threads(2)


def test_tag_list_is_the_jax_packages():
    assert pretrained.PRETRAINED_MODEL_LIST == \
        jax_pretrained.PRETRAINED_MODEL_LIST
    assert len(pretrained.PRETRAINED_MODEL_LIST) == 36


def test_resolver_matches_jax_on_one_cache(tmp_path, monkeypatch):
    """A cache holding a reference ``.pkl`` under one tag, the ``.ckpt``
    that ``bin.convert_checkpoint`` made of it (with ``config.yml``) under
    another, and a tag directory without a checkpoint: both resolvers
    return the same paths and raise the same errors, from
    ``$PWG_TPU_CACHE`` and from an explicit directory; the resolved files
    serve through ``load_model`` to the same wave."""
    config = small_melgan_train_config("melgan_v1")
    gen_type = config["generator_type"]
    gen = get_model_class(gen_type)(
        **config["generator_params"],
        generator=torch.Generator().manual_seed(0))
    cache = tmp_path / "cache"
    pkl_dir = cache / "ljspeech_melgan.v1"
    pkl_dir.mkdir(parents=True)
    pkl = str(pkl_dir / "checkpoint-5steps.pkl")
    save_reference_checkpoint(pkl, nested({
        k: v.numpy() for k, v in gen.state_dict().items()}), config, steps=5)
    (pkl_dir / "notes.txt").write_text("not a checkpoint\n")
    yml = str(tmp_path / "config.yml")
    save_config(yml, config)
    ckpt = convert_checkpoint.main([
        "--checkpoint", pkl, "--config", yml, "--outdir",
        str(cache / "ljspeech_melgan.v3"), "--device", "cpu",
        "--verbose", "0"])
    (cache / "jsut_hifigan.v1").mkdir()
    monkeypatch.setenv("PWG_TPU_CACHE", str(cache))
    assert pretrained.get_cache_dir() == jax_pretrained.get_cache_dir() \
        == str(cache)
    for tag, want in (("ljspeech_melgan.v1", pkl),
                      ("ljspeech_melgan.v3", ckpt)):
        for download_dir in (None, str(cache)):
            got = pretrained.download_pretrained_model(tag, download_dir)
            assert got == want == jax_pretrained.download_pretrained_model(
                tag, download_dir)
    for tag in ("jsut_hifigan.v1", "vctk_hifigan.v1"):
        for resolver in (pretrained, jax_pretrained):
            with pytest.raises(FileNotFoundError, match=tag):
                resolver.download_pretrained_model(tag)
    with pytest.raises(FileNotFoundError,
                       match="parallelwavegan_torch.bin.convert_checkpoint"):
        pretrained.download_pretrained_model("jsut_hifigan.v1")
    for resolver in (pretrained, jax_pretrained):
        with pytest.raises(KeyError, match="unknown tag: no_such_tag"):
            resolver.download_pretrained_model("no_such_tag")
    mel = np.random.default_rng(0).standard_normal((9, 16)).astype(np.float32)
    waves = [load_model(pretrained.download_pretrained_model(tag), config,
                        device="cpu").inference(mel)
             for tag in ("ljspeech_melgan.v1", "ljspeech_melgan.v3")]
    assert waves[0].shape == (9 * 64, 1)
    np.testing.assert_array_equal(waves[0], waves[1])
    monkeypatch.delenv("PWG_TPU_CACHE")
    assert pretrained.get_cache_dir() == jax_pretrained.get_cache_dir() \
        == os.path.join(os.path.expanduser("~"), ".cache",
                        "parallelwavegan_tpu")
