"""Audio IO and conversion without torchaudio.

The port's own copy of `encodec_tpu/utils/audio.py` (framework-free; the
port imports nothing of the JAX package).

WAV read/write via scipy (PCM16/24/32/float) and channel/sample-rate
conversion with a polyphase resampler. Behavioral reference:
encodec/utils.py:79-103 (convert_audio, save_audio).
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np


def load_wav(path: tp.Union[str, Path]) -> tp.Tuple[np.ndarray, int]:
    """Read a wav file → (float32 `[C, T]` in [-1, 1], sample_rate)."""
    from scipy.io import wavfile
    sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[None, :]
    else:
        data = data.T  # [C, T]
    return np.ascontiguousarray(data), int(sr)


def save_wav(wav: np.ndarray, path: tp.Union[str, Path], sample_rate: int,
             rescale: bool = False) -> None:
    """Write `[C, T]` float audio as PCM16, clipping at 0.99 like the
    reference `save_audio` (utils.py:95-103). int16 input (e.g. from
    `EncodecModel.decode(..., pcm16=True)`, which applies the identical
    quantizer on device) is written through unchanged."""
    from scipy.io import wavfile
    if np.asarray(wav).dtype == np.int16:
        assert not rescale, "rescale requires float input"
        wavfile.write(str(path), sample_rate, np.asarray(wav).T)
        return
    wav = np.asarray(wav, np.float32)
    limit = 0.99
    mx = np.abs(wav).max() if wav.size else 0.0
    if rescale and mx > 0:
        wav = wav * min(limit / mx, 1.0)
    else:
        wav = np.clip(wav, -limit, limit)
    pcm = (wav * 32767.0).astype(np.int16)
    wavfile.write(str(path), sample_rate, pcm.T)


def convert_audio(wav: np.ndarray, sr: int, target_sr: int,
                  target_channels: int) -> np.ndarray:
    """Channel conversion + resampling for `[..., C, T]` audio."""
    assert wav.ndim >= 2, "Audio tensor must have at least 2 dimensions"
    channels = wav.shape[-2]
    assert channels in (1, 2), "Audio must be mono or stereo."
    if target_channels == 1:
        wav = wav.mean(axis=-2, keepdims=True)
    elif target_channels == 2:
        wav = np.broadcast_to(
            wav, wav.shape[:-2] + (target_channels, wav.shape[-1])).copy() \
            if channels == 1 else wav
    elif channels == 1:
        wav = np.broadcast_to(
            wav, wav.shape[:-2] + (target_channels, wav.shape[-1])).copy()
    else:
        raise RuntimeError(
            f"Impossible to convert from {channels} to {target_channels}")
    if sr != target_sr:
        from math import gcd
        from scipy.signal import resample_poly
        g = gcd(sr, target_sr)
        wav = resample_poly(wav, target_sr // g, sr // g, axis=-1).astype(np.float32)
    return np.asarray(wav, np.float32)
