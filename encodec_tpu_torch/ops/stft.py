"""Short-time Fourier transform with torch.stft(center=False) semantics.

Port of `encodec_tpu/ops/stft.py`: frames of length `n_fft` taken every
`hop`, a `win_length` periodic Hann window zero-padded to `n_fft` and
centered, one-sided rFFT. The framing is JAX's gather (`Tensor.unfold`
takes the same frames) and one batched `torch.fft.rfft`; `torch.stft` is
not used, since its padding and window placement are not the ones the
losses are held to. Used by the spectrogram reconstruction loss and, through
`spectrogram` (torchaudio's `Spectrogram(center=False)`), by the MS-STFT
discriminator.
"""

from __future__ import annotations

import math
import typing as tp

import torch


def hann_window(win_length: int, dtype: torch.dtype = torch.float32,
                device: tp.Optional[torch.device] = None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window's default)."""
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """`[..., T]` → `[..., num_frames, n_fft]` (center=False framing)."""
    T = x.shape[-1]
    if T < n_fft:
        # torch.stft(center=False) raises here too; an empty frame axis
        # would silently turn downstream means into NaN
        raise ValueError(f"signal length {T} is shorter than n_fft {n_fft}")
    return x.unfold(-1, n_fft, hop)


def stft(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
         window: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-sided complex STFT: `[..., T]` → `[..., n_fft//2 + 1, frames]`."""
    if window is None:
        window = hann_window(win_length, x.dtype, x.device)
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        window = torch.nn.functional.pad(window,
                                         (left, n_fft - win_length - left))
    frames = frame_signal(x, n_fft, hop_length) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def spectrogram(x: torch.Tensor, n_fft: int, hop_length: int,
                win_length: int, normalized: bool = True,
                power: tp.Optional[float] = None) -> torch.Tensor:
    """torchaudio.transforms.Spectrogram(center=False): `normalized` divides
    by `sqrt(Σ window²)` (torchaudio's "window" normalization); `power=None`
    returns the complex STFT, else `|STFT|**power`."""
    window = hann_window(win_length, torch.float32, x.device)
    spec = stft(x, n_fft, hop_length, win_length, window)
    if normalized:
        spec = spec / window.square().sum().sqrt()
    if power is None:
        return spec
    mag = spec.abs()
    return mag if power == 1.0 else mag ** power
