"""Loss bundle built from a (reference-compatible) experiment config.

Counterpart of ``parallelwavegan_tpu/engine/criterion.py`` for the Parallel
WaveGAN, HiFi-GAN and MelGAN keys: the multi-resolution STFT loss, the
subband STFT loss, the mel spectrogram loss, feature matching, the two
adversarial losses and, for a multi-band generator (``out_channels`` > 1)
and for a VQ-VAE (``out_channels`` subbands if above 1, else 4), the PQMF
filterbank with the layer's defaults (taps 62, cutoff 0.142, beta 9.0)
unless ``pqmf_params`` says otherwise: training reads no version switch.
The duration keys (``use_duration_prediction``, the reference's
``use_duration_loss``, or a duration generator) add the duration
predictor's loss with ``duration_loss_params``, whose one field is
``offset`` as in the JAX package (a ``reduction`` key fails in both).
"""

from __future__ import annotations

from typing import Any, Dict

from parallelwavegan_torch.layers.pqmf import PQMF
from parallelwavegan_torch.losses import (
    DiscriminatorAdversarialLoss,
    DurationPredictorLoss,
    FeatureMatchLoss,
    GeneratorAdversarialLoss,
    MelSpectrogramLoss,
    MultiResolutionSTFTLoss,
)

def _stft_loss(params: Dict[str, Any]) -> MultiResolutionSTFTLoss:
    p = dict(params)
    if "window" in p:
        p["window"] = p["window"].replace("_window", "")
    return MultiResolutionSTFTLoss(**p)


def build_criterion(config: Dict[str, Any]) -> Dict[str, Any]:
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
    if config.get("use_duration_prediction", False) \
            or config.get("use_duration_loss", False) \
            or "Duration" in config.get("generator_type", ""):
        c["duration"] = DurationPredictorLoss(
            **(config.get("duration_loss_params") or {}))
    out_ch = config.get("generator_params", {}).get("out_channels", 1)
    if out_ch > 1 or config.get("generator_type") == "VQVAE":
        c["pqmf"] = PQMF(subbands=out_ch if out_ch > 1 else 4,
                         **config.get("pqmf_params", {}))
    return c
