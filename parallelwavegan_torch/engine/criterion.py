"""Loss bundle built from a (reference-compatible) experiment config.

Counterpart of ``parallelwavegan_tpu/engine/criterion.py`` for the Parallel
WaveGAN and HiFi-GAN keys: the multi-resolution STFT loss, the mel
spectrogram loss, feature matching and the two adversarial losses. Keys of
other families raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict

from parallelwavegan_torch.losses import (
    DiscriminatorAdversarialLoss,
    FeatureMatchLoss,
    GeneratorAdversarialLoss,
    MelSpectrogramLoss,
    MultiResolutionSTFTLoss,
)

_NOT_PORTED = ("use_subband_stft_loss", "use_duration_prediction",
               "use_duration_loss")


def build_criterion(config: Dict[str, Any]) -> Dict[str, Any]:
    for key in _NOT_PORTED:
        if config.get(key, False):
            raise NotImplementedError(f"{key} is not ported yet")
    if config.get("generator_params", {}).get("out_channels", 1) > 1:
        raise NotImplementedError("multi-band generators (PQMF) are not "
                                  "ported yet")
    c: Dict[str, Any] = {}
    if config.get("use_stft_loss", True):
        p = dict(config.get("stft_loss_params", {}))
        if "window" in p:
            p["window"] = p["window"].replace("_window", "")
        c["stft"] = MultiResolutionSTFTLoss(**p)
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
    return c
