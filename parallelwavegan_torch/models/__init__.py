"""Model families and the config-name registry (Parallel WaveGAN, HiFi-GAN,
MelGAN, StyleMelGAN, VQ-VAE, UHiFiGAN and the discrete-symbol generators)."""

from parallelwavegan_torch.models.discrete import (  # noqa: F401
    DiscreteSymbolDurationGenerator,
    DiscreteSymbolF0Generator,
    DiscreteSymbolHiFiGANGenerator,
    DiscreteSymbolStyleMelGANGenerator,
)
from parallelwavegan_torch.models.hifigan import (  # noqa: F401
    HiFiGANGenerator,
    HiFiGANMultiPeriodDiscriminator,
    HiFiGANMultiScaleDiscriminator,
    HiFiGANMultiScaleMultiPeriodDiscriminator,
    HiFiGANPeriodDiscriminator,
    HiFiGANScaleDiscriminator,
)
from parallelwavegan_torch.models.melgan import (  # noqa: F401
    MelGANDiscriminator,
    MelGANGenerator,
    MelGANMultiScaleDiscriminator,
)
from parallelwavegan_torch.models.parallel_wavegan import (  # noqa: F401
    ParallelWaveGANDiscriminator,
    ParallelWaveGANGenerator,
    ResidualParallelWaveGANDiscriminator,
)
from parallelwavegan_torch.models.style_melgan import (  # noqa: F401
    StyleMelGANDiscriminator,
    StyleMelGANGenerator,
)
from parallelwavegan_torch.models.uhifigan import (  # noqa: F401
    UHiFiGANGenerator,
)
from parallelwavegan_torch.models.vqvae import VQVAE  # noqa: F401

_REGISTRY = {
    "DiscreteSymbolHiFiGANGenerator": DiscreteSymbolHiFiGANGenerator,
    "DiscreteSymbolDurationGenerator": DiscreteSymbolDurationGenerator,
    "DiscreteSymbolF0Generator": DiscreteSymbolF0Generator,
    "DiscreteSymbolStyleMelGANGenerator": DiscreteSymbolStyleMelGANGenerator,
    "HiFiGANGenerator": HiFiGANGenerator,
    "HiFiGANPeriodDiscriminator": HiFiGANPeriodDiscriminator,
    "HiFiGANMultiPeriodDiscriminator": HiFiGANMultiPeriodDiscriminator,
    "HiFiGANScaleDiscriminator": HiFiGANScaleDiscriminator,
    "HiFiGANMultiScaleDiscriminator": HiFiGANMultiScaleDiscriminator,
    "HiFiGANMultiScaleMultiPeriodDiscriminator":
        HiFiGANMultiScaleMultiPeriodDiscriminator,
    "MelGANGenerator": MelGANGenerator,
    "MelGANDiscriminator": MelGANDiscriminator,
    "MelGANMultiScaleDiscriminator": MelGANMultiScaleDiscriminator,
    "ParallelWaveGANGenerator": ParallelWaveGANGenerator,
    "ParallelWaveGANDiscriminator": ParallelWaveGANDiscriminator,
    "ResidualParallelWaveGANDiscriminator":
        ResidualParallelWaveGANDiscriminator,
    "StyleMelGANGenerator": StyleMelGANGenerator,
    "StyleMelGANDiscriminator": StyleMelGANDiscriminator,
    "UHiFiGANGenerator": UHiFiGANGenerator,
    "VQVAE": VQVAE,
}
# the discrete-symbol (token) generators, served one utterance a call
DISCRETE_GENERATORS = tuple(name for name in _REGISTRY
                            if name.startswith("DiscreteSymbol"))


def get_model_class(name: str):
    """Resolve a config model name to the port's module class."""
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"unknown model: {name}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]
