"""Segment recombination: linear-fade overlap-add.

Port of `encodec_tpu/utils/overlap.py` (ref encodec/utils.py:17-56).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch


def triangle_weight(frame_length: int) -> np.ndarray:
    """The triangular weight of a `frame_length`-sample frame, float32.

    Built with the arithmetic XLA gives `jnp.linspace(0, 1, n + 2)`:
    `iota · float32(1 / (n + 1))`, so the weights equal the JAX package's
    bit for bit (`torch.linspace` rounds 1 ulp apart at about a third of
    them)."""
    n = frame_length
    step = np.float32(1) / np.float32(n + 1)
    t = np.arange(1, n + 1, dtype=np.float32) * step
    return np.float32(0.5) - np.abs(t - np.float32(0.5))


def linear_overlap_add(frames: tp.Sequence[torch.Tensor],
                       stride: int) -> torch.Tensor:
    """Overlap-add `[B, T, C]` frames with triangular weights.

    Frames are placed `stride` apart; each is weighted by a triangle peaking
    at the middle of the first frame's length (a shorter last frame takes
    the start of that triangle) and the sum is divided by the summed
    weights, so a position covered by one frame keeps its value up to
    rounding and two overlapping frames cross-fade linearly. The additions
    run in frame order, as in the JAX package."""
    if not frames:
        raise ValueError("linear_overlap_add needs at least one frame")
    first = frames[0]
    B, _, C = first.shape
    total = stride * (len(frames) - 1) + frames[-1].shape[1]
    weight = torch.from_numpy(triangle_weight(first.shape[1])).to(
        device=first.device, dtype=first.dtype)
    sum_weight = first.new_zeros(total)
    out = first.new_zeros(B, total, C)
    for i, frame in enumerate(frames):
        offset, fl = i * stride, frame.shape[1]
        out[:, offset:offset + fl] += weight[:fl, None] * frame
        sum_weight[offset:offset + fl] += weight[:fl]
    return out / sum_weight[None, :, None]
