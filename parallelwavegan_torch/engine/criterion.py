"""Loss bundle built from a (reference-compatible) experiment config.

Counterpart of ``parallelwavegan_tpu/engine/criterion.py`` for the Parallel
WaveGAN, HiFi-GAN and MelGAN keys: the multi-resolution STFT loss, the
subband STFT loss, the mel spectrogram loss, feature matching, the two
adversarial losses and, for a multi-band generator (``out_channels`` > 1)
and for a VQ-VAE (``out_channels`` subbands if above 1, else 4), the PQMF
filterbank with the layer's defaults (taps 62, cutoff 0.142, beta 9.0)
unless ``pqmf_params`` says otherwise: training reads no version switch. The duration keys raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict

from parallelwavegan_torch.layers.pqmf import PQMF
from parallelwavegan_torch.losses import (
    DiscriminatorAdversarialLoss,
    FeatureMatchLoss,
    GeneratorAdversarialLoss,
    MelSpectrogramLoss,
    MultiResolutionSTFTLoss,
)

_NOT_PORTED = ("use_duration_prediction", "use_duration_loss")


def _stft_loss(params: Dict[str, Any]) -> MultiResolutionSTFTLoss:
    p = dict(params)
    if "window" in p:
        p["window"] = p["window"].replace("_window", "")
    return MultiResolutionSTFTLoss(**p)


def build_criterion(config: Dict[str, Any]) -> Dict[str, Any]:
    for key in _NOT_PORTED:
        if config.get(key, False):
            raise NotImplementedError(f"{key} is not ported yet")
    c: Dict[str, Any] = {}
    if config.get("use_stft_loss", True):
        c["stft"] = _stft_loss(config.get("stft_loss_params", {}))
    if config.get("use_subband_stft_loss", False):
        c["sub_stft"] = _stft_loss(config["subband_stft_loss_params"])
    if config.get("use_mel_loss", False):
        p = dict(config.get("mel_loss_params", {}))
        p.setdefault("fs", config.get("sampling_rate", 22050))
        c["mel"] = MelSpectrogramLoss(**p)
    c["gen_adv"] = GeneratorAdversarialLoss(
        **config.get("generator_adv_loss_params", {})
    )
    c["dis_adv"] = DiscriminatorAdversarialLoss(
        **config.get("discriminator_adv_loss_params", {})
    )
    if config.get("use_feat_match_loss", False):
        c["feat_match"] = FeatureMatchLoss(
            **config.get("feat_match_loss_params", {})
        )
    out_ch = config.get("generator_params", {}).get("out_channels", 1)
    if out_ch > 1 or config.get("generator_type") == "VQVAE":
        c["pqmf"] = PQMF(subbands=out_ch if out_ch > 1 else 4,
                         **config.get("pqmf_params", {}))
    return c
