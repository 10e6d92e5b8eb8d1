"""Breathing-spectrogram reconstruction losses.

Port of `encodec_tpu/losses/spectrogram.py` (ref
encodec/my_code/spectrogram_loss.py: BreathingSpectrogram 7-76,
create_breathing_frequency_weight 79-109, ReconstructionLoss 112-177,
ReconstructionLosses 180-202).

The spectrogram is a log10-power STFT with a long window (default 30 s of
signal), reflect-padded so frames align with the reference, normalized by
the window sum. The loss weights each time-frequency bin by a Gaussian
centered on the per-frame dominant ("breathing") frequency, or uniformly
with `bandwidth=None`, and combines weighted L1 + alpha * L2; the
dominant-bin match rate is reported as an accuracy metric (an argmax, so
a near-tie can move it by a frame between two implementations; the loss
with `bandwidth=None` does not depend on it). The batch means go through
`dp` (`ops.batch_reduce`): under a data-parallel training step they are
the global batch's.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from ..ops.batch_reduce import LOCAL, BatchReduce
from ..ops.stft import hann_window, stft


def breathing_spectrogram(signal: torch.Tensor, sampling_rate: int = 10,
                          n_fft: int = 256,
                          hop_length: tp.Optional[int] = None,
                          win_length: tp.Optional[int] = None
                          ) -> torch.Tensor:
    """log10 power spectrogram of `[B, T]` (or `[B, 1, T]`) → `[B, F, frames]`."""
    if signal.dim() == 3:
        if signal.shape[1] != 1:
            raise ValueError("Input signal must be [B, 1, T]")
        signal = signal[:, 0]
    win_length = win_length or 30 * sampling_rate
    hop_length = hop_length or 5 * sampling_rate
    if win_length > n_fft:
        raise ValueError(f"win_length {win_length} must be <= n_fft {n_fft} "
                         "(torch.stft semantics; pass win_length explicitly)")
    p = (n_fft - hop_length) // 2
    signal = F.pad(signal[:, None], (p, p), mode="reflect")[:, 0]
    window = hann_window(win_length, torch.float32, signal.device)
    spec = stft(signal, n_fft, hop_length, win_length, window)
    spec = spec / window.sum()
    power = spec.abs().square()
    return torch.log10(power.clamp(min=1e-5))


def breathing_frequency_weight(S_x: torch.Tensor, breathing_rate: torch.Tensor,
                               bandwidth: tp.Optional[float] = 1.0
                               ) -> torch.Tensor:
    """Gaussian weight around the per-frame dominant frequency bin.
    S_x: [B, F, T]; breathing_rate: [B, T] (argmax bins)."""
    if bandwidth is None:
        return torch.ones_like(S_x)
    F_ = S_x.shape[1]
    bins = torch.arange(F_, dtype=torch.float32, device=S_x.device)[None, :, None]
    center = breathing_rate[:, None, :].float()
    weight = torch.exp(-(bins - center).square() / (2 * bandwidth ** 2) + 1e-8)
    weight = weight / weight.amax(dim=1, keepdim=True)
    return weight.clamp(1e-3, 1.0)


def reconstruction_loss(x: torch.Tensor, x_hat: torch.Tensor, *,
                        alpha: float = 0.01,
                        bandwidth: tp.Optional[float] = None,
                        sampling_rate: int = 10, n_fft: int = 1024,
                        hop_length: tp.Optional[int] = None,
                        win_length: tp.Optional[int] = None,
                        dp: BatchReduce = LOCAL
                        ) -> tp.Dict[str, torch.Tensor]:
    """Weighted spectral L1+L2 with breathing-rate accuracy.

    x, x_hat: `[B, 1, T]` or `[B, T]` waveforms (same shapes both)."""
    S_x = breathing_spectrogram(x, sampling_rate, n_fft, hop_length,
                                win_length)
    S_x_hat = breathing_spectrogram(x_hat, sampling_rate, n_fft, hop_length,
                                    win_length)
    rate_x = S_x.argmax(dim=1)
    rate_hat = S_x_hat.argmax(dim=1)
    acc = dp.mean((rate_x == rate_hat).float().mean())

    # the reference keeps bins < 0.5/bin_freq = n_fft: a no-op slice on the
    # (n_fft//2+1)-bin spectrogram, kept for fidelity
    keep = min(n_fft, S_x.shape[1])
    S_x = S_x[:, :keep]
    S_x_hat = S_x_hat[:, :keep]

    weight = breathing_frequency_weight(S_x, rate_x, bandwidth)
    l1 = dp.mean(((S_x - S_x_hat).abs() * weight).mean())
    l2 = dp.mean(((S_x - S_x_hat).square() * weight).mean())
    return {
        "total_loss": l1 + l2 * alpha,
        "l1_loss": l1,
        "l2_loss": l2,
        "acc": acc,
        "Sx_breathing_rate": rate_x,
        "Sx_hat_breathing_rate": rate_hat,
        "S_x": S_x,
        "S_x_hat": S_x_hat,
    }


def multi_reconstruction_loss(x: torch.Tensor, x_hat: torch.Tensor, *,
                              alpha: float = 0.01,
                              bandwidth: tp.Optional[float] = None,
                              sampling_rate: int = 10, n_fft: int = 1024,
                              hop_lengths=(None,), win_lengths=(None,)):
    """Multi-resolution wrapper (ref ReconstructionLosses 180-202)."""
    if len(hop_lengths) != len(win_lengths):
        raise ValueError("hop_lengths and win_lengths differ in length")
    results = [reconstruction_loss(x, x_hat, alpha=alpha, bandwidth=bandwidth,
                                   sampling_rate=sampling_rate, n_fft=n_fft,
                                   hop_length=h, win_length=w)
               for h, w in zip(hop_lengths, win_lengths)]
    n = len(results)
    pick = results[1] if n > 1 else results[0]
    return {
        "total_loss": sum(r["total_loss"] for r in results) / n,
        "l1_loss": sum(r["l1_loss"] for r in results) / n,
        "l2_loss": sum(r["l2_loss"] for r in results) / n,
        "acc": pick["acc"],
        "Sx_breathing_rate": pick["Sx_breathing_rate"],
        "Sx_hat_breathing_rate": pick["Sx_hat_breathing_rate"],
        "S_x": pick["S_x"],
        "S_x_hat": pick["S_x_hat"],
    }
