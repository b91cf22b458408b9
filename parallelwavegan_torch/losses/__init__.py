"""Training losses (the Parallel WaveGAN set so far)."""

from parallelwavegan_torch.losses.adversarial import (  # noqa: F401
    DiscriminatorAdversarialLoss,
    GeneratorAdversarialLoss,
)
from parallelwavegan_torch.losses.stft_loss import (  # noqa: F401
    MultiResolutionSTFTLoss,
    STFTLoss,
    log_stft_magnitude_loss,
    spectral_convergence_loss,
)
