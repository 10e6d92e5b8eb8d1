"""Training losses: the breathing-spectrogram reconstruction loss and the
generator / discriminator objectives (`encodec_tpu/losses/spectrogram.py`,
`gan.py`). The gradient balancer waits for the GAN slice (ROADMAP 11a)."""

from .gan import disc_loss, total_loss  # noqa: F401
from .spectrogram import (  # noqa: F401
    breathing_frequency_weight,
    breathing_spectrogram,
    multi_reconstruction_loss,
    reconstruction_loss,
)
