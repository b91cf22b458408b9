"""Pretrained tags resolved from a local cache directory.

Counterpart of ``parallelwavegan_tpu/utils/pretrained.py`` (the
reference's ``download_pretrained_model`` surface). Nothing is downloaded:
a tag resolves to a ``checkpoint*.ckpt`` or ``checkpoint*.pkl`` that the
user placed under ``<cache>/<tag>/`` (a reference checkpoint as it is, or
converted with ``python -m parallelwavegan_torch.bin.convert_checkpoint``),
and ``utils.model_loader.load_model`` serves it. The cache directory is
``$PWG_TPU_CACHE``, the JAX package's variable, or
``~/.cache/parallelwavegan_tpu``, so one cache serves both packages.
"""

from __future__ import annotations

import os
from typing import List, Optional

# the reference's model zoo tags (corpus_model.version), kept so that tag
# strings used with the reference resolve here once their files are cached
PRETRAINED_MODEL_LIST: List[str] = [
    "ljspeech_parallel_wavegan.v1",
    "ljspeech_parallel_wavegan.v1.long",
    "ljspeech_parallel_wavegan.v1.no_limit",
    "ljspeech_parallel_wavegan.v3",
    "ljspeech_melgan.v1",
    "ljspeech_melgan.v1.long",
    "ljspeech_melgan.v3",
    "ljspeech_melgan.v3.long",
    "ljspeech_full_band_melgan.v2",
    "ljspeech_multi_band_melgan.v2",
    "ljspeech_hifigan.v1",
    "ljspeech_style_melgan.v1",
    "jsut_parallel_wavegan.v1",
    "jsut_multi_band_melgan.v2",
    "jsut_hifigan.v1",
    "jsut_style_melgan.v1",
    "csmsc_parallel_wavegan.v1",
    "csmsc_multi_band_melgan.v2",
    "csmsc_hifigan.v1",
    "csmsc_style_melgan.v1",
    "arctic_slt_parallel_wavegan.v1",
    "jnas_parallel_wavegan.v1",
    "vctk_parallel_wavegan.v1",
    "vctk_parallel_wavegan.v1.long",
    "vctk_multi_band_melgan.v2",
    "vctk_hifigan.v1",
    "vctk_style_melgan.v1",
    "libritts_parallel_wavegan.v1",
    "libritts_parallel_wavegan.v1.long",
    "libritts_multi_band_melgan.v2",
    "libritts_hifigan.v1",
    "libritts_style_melgan.v1",
    "kss_parallel_wavegan.v1",
    "hui_acg_hokuspokus_parallel_wavegan.v1",
    "ruslan_parallel_wavegan.v1",
    "oniku_hifigan.v1",
]


def get_cache_dir() -> str:
    return os.environ.get(
        "PWG_TPU_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "parallelwavegan_tpu"),
    )


def download_pretrained_model(tag: str,
                              download_dir: Optional[str] = None) -> str:
    """Resolve a pretrained tag to a local checkpoint path: the first
    ``checkpoint*.ckpt`` or ``checkpoint*.pkl`` (in name order) under
    ``<cache>/<tag>/``. Raises ``KeyError`` for an unknown tag and
    ``FileNotFoundError`` with instructions when nothing is cached."""
    if tag not in PRETRAINED_MODEL_LIST:
        raise KeyError(
            f"unknown tag: {tag}; available: {PRETRAINED_MODEL_LIST}")
    tag_dir = os.path.join(download_dir or get_cache_dir(), tag)
    if os.path.isdir(tag_dir):
        for name in sorted(os.listdir(tag_dir)):
            if name.startswith("checkpoint") and name.endswith(
                    (".ckpt", ".pkl")):
                return os.path.join(tag_dir, name)
    raise FileNotFoundError(
        f"no cached checkpoint for {tag} under {tag_dir}. Nothing is "
        "downloaded: fetch the tag's checkpoint with the reference tooling, "
        "place it under that directory (optionally converted with `python "
        "-m parallelwavegan_torch.bin.convert_checkpoint`), and retry.")
