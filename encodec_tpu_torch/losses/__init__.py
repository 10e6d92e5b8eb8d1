"""Training losses: the breathing-spectrogram reconstruction loss, the
generator / discriminator objectives and the gradient balancer
(`encodec_tpu/losses/spectrogram.py`, `gan.py`, `balancer.py`)."""

from .balancer import (  # noqa: F401
    Balancer,
    averager,
    balance,
    init_balancer_state,
)
from .gan import disc_loss, total_loss  # noqa: F401
from .spectrogram import (  # noqa: F401
    breathing_frequency_weight,
    breathing_spectrogram,
    multi_reconstruction_loss,
    reconstruction_loss,
)
