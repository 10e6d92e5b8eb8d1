"""Experiment configs → models.

The part of `encodec_tpu/train/trainer.py` that inference needs:
`model_from_config`. The training loop itself is not ported yet.
"""

from __future__ import annotations

import typing as tp

import torch

from ..models.model import EncodecModel, build_model
from .config import ConfigNamespace, parse_segment


def model_from_config(config: ConfigNamespace,
                      device: tp.Union[str, torch.device] = "cuda"
                      ) -> EncodecModel:
    """Build the generator of an experiment config (its `model:` section),
    with the fork's fixed choices: no norm on the decoder's last conv and
    one shared codebook. `model.remat` (a JAX memory option) is ignored."""
    m = config.model
    return build_model(
        list(m.target_bandwidths), sample_rate=m.sample_rate,
        channels=m.channels, causal=m.causal, model_norm=m.norm,
        audio_normalize=m.audio_normalize, segment=parse_segment(m.segment),
        name=m.name, ratios=list(m.ratios), bins=m.bins,
        dimension=getattr(m, "dimension", 128),
        n_filters=getattr(m, "filters", 32),
        decoder_final_norm="none",
        shared_codebook=True,
        device=device,
    )
