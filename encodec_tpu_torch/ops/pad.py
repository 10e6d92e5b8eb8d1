"""1-D padding math for streamable convolutions.

Port of `encodec_tpu/ops/pad.py`: convolutions see enough right padding
that the last window is full, causal convs pad entirely on the left, and
reflect padding works even when the signal is shorter than the pad.

Public functions take channels-last `[B, T, C]` tensors like the JAX
package; `pad_time` is the channels-first `[B, C, T]` form the convs use.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F


def get_extra_padding_for_conv1d(length: int, kernel_size: int, stride: int,
                                 padding_total: int = 0) -> int:
    """Extra right padding so the final conv window is full."""
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (kernel_size - padding_total)
    return ideal_length - length


def pad_time(x: torch.Tensor, paddings: tp.Tuple[int, int],
             mode: str = "zero", value: float = 0.0) -> torch.Tensor:
    """Pad the last (time) axis of `[B, C, T]`.

    Reflect mode on an input shorter than the pad zero-extends first so the
    reflection is defined, then trims the extension (the reference's
    small-input workaround)."""
    padding_left, padding_right = paddings
    if padding_left < 0 or padding_right < 0:
        raise ValueError(f"negative padding {paddings}")
    if mode == "reflect":
        length = x.shape[-1]
        max_pad = max(padding_left, padding_right)
        extra_pad = 0
        if length <= max_pad:
            extra_pad = max_pad - length + 1
            x = F.pad(x, (0, extra_pad))
        padded = F.pad(x, (padding_left, padding_right), mode="reflect")
        return padded[..., :padded.shape[-1] - extra_pad]
    if mode in ("zero", "constant"):
        return F.pad(x, (padding_left, padding_right), value=value)
    if mode == "replicate":
        return F.pad(x, (padding_left, padding_right), mode="replicate")
    raise ValueError(f"Unsupported pad mode {mode!r}")


def pad1d(x: torch.Tensor, paddings: tp.Tuple[int, int], mode: str = "zero",
          value: float = 0.0) -> torch.Tensor:
    """Pad the time axis (axis 1) of `[B, T, C]`."""
    return pad_time(x.transpose(1, 2), paddings, mode, value).transpose(1, 2)


def unpad1d(x: torch.Tensor, paddings: tp.Tuple[int, int]) -> torch.Tensor:
    """Remove left/right padding from the time axis of `[B, T, C]`."""
    padding_left, padding_right = paddings
    if padding_left < 0 or padding_right < 0 or \
            padding_left + padding_right > x.shape[1]:
        raise ValueError(f"bad unpadding {paddings} for length {x.shape[1]}")
    return x[:, padding_left:x.shape[1] - padding_right]
