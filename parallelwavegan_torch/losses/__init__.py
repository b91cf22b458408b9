"""Training losses (the Parallel WaveGAN and HiFi-GAN sets, and the
duration predictor's)."""

from parallelwavegan_torch.losses.adversarial import (  # noqa: F401
    DiscriminatorAdversarialLoss,
    GeneratorAdversarialLoss,
)
from parallelwavegan_torch.losses.duration import (  # noqa: F401
    DurationPredictorLoss,
)
from parallelwavegan_torch.losses.feat_match import (  # noqa: F401
    FeatureMatchLoss,
)
from parallelwavegan_torch.losses.mel_loss import (  # noqa: F401
    MelSpectrogramLoss,
)
from parallelwavegan_torch.losses.stft_loss import (  # noqa: F401
    MultiResolutionSTFTLoss,
    STFTLoss,
    log_stft_magnitude_loss,
    spectral_convergence_loss,
)
