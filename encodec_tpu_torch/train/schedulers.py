"""Learning-rate schedules (ref encodec/my_code/schedulers.py).

A copy of `encodec_tpu/train/schedulers.py`.
"""

from __future__ import annotations

import math


def linear_warmup_cosine(epoch: int, base_lr: float, warmup_epochs: int,
                         max_epochs: int, min_lr: float = 0.0) -> float:
    """Epoch-level linear warmup then cosine annealing
    (ref LinearWarmupCosineAnnealingLR, schedulers.py:6-23).

    Note the reference's torch scheduler evaluates `get_lr` at
    `last_epoch = epoch_index` starting from 0 *before* the first step;
    this function takes the same 0-based epoch index.
    """
    if epoch < warmup_epochs:
        scale = (epoch + 1) / warmup_epochs
    else:
        scale = 0.5 * (1 + math.cos(
            math.pi * (epoch - warmup_epochs) / (max_epochs - warmup_epochs)))
    return min_lr + (base_lr - min_lr) * scale


def warmup_wrap(epoch: int, base_lr: float, warmup_steps: int,
                base_schedule) -> float:
    """Generic warmup wrapper (ref WarmupScheduler, schedulers.py:25-55,
    defined but unused by the reference trainer): linear ramp for the first
    `warmup_steps` epochs, then defer to `base_schedule(epoch)` — any
    `epoch -> lr` callable."""
    if epoch < warmup_steps:
        return base_lr * (epoch + 1) / warmup_steps
    return float(base_schedule(epoch))
