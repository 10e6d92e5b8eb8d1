"""Compress / decompress audio to `.ecdc` bytestreams — raw path.

Port of the raw (no-LM) path of `encodec_tpu/stream/compress.py`: the
header (`m`, `al`, `nc`, `lm`), then one record per segment — for a
normalized model its big-endian f32 scale, then its codes packed LSB-first
in (t, k) order. The writer encodes through the near-tie guard
(`EncodecModel.encode_guarded`, threshold 1e-3), so positions whose RVQ
top-2 gap is razor-thin resolve the same way in every writer whose latents
agree.

Unsegmented (24 kHz) files are byte-identical to the JAX writer's on the
same weights and audio. In segmented (48 kHz) files the header and every
code byte are identical, but a scale may differ from the JAX writer's by up
to 2 ulp: the per-segment RMS is a float32 reduction whose summation order
each framework picks. Each package reads the other's files.

LM entropy coding (`use_lm=True`) is not ported yet.
"""

from __future__ import annotations

import io
import logging
import math
import struct
import typing as tp

import numpy as np
import torch

from . import binary

_LM_MISSING = ("LM entropy coding (use_lm / lmv=3 streams) is not ported to "
               "encodec_tpu_torch yet; it comes with the LM slice of the port")
_SCALE = struct.Struct("!f")


def compress_to_file(model, wav, fo: tp.IO[bytes], use_lm: bool = False,
                     models=None) -> None:
    """Compress a `[C, T]` waveform to a file object, through the near-tie
    guard.

    `model` is an `EncodecModel` with a target bandwidth set; `models`
    overrides the name registry used for validation."""
    from ..models.model import MODELS

    if np.ndim(wav) != 2:
        raise ValueError("Only a single waveform can be encoded.")
    registry = models if models is not None else MODELS
    if model.name not in registry:
        raise ValueError(f"The provided model {model.name} is not supported.")
    if use_lm:
        raise NotImplementedError(_LM_MISSING)
    frames, stats = model.encode_guarded(torch.as_tensor(wav)[None],
                                         threshold=1e-3)
    logging.getLogger(__name__).log(
        logging.INFO if stats["n_flagged"] else logging.DEBUG,
        "tie guard: min RVQ argmin margin %.3g over %d positions; "
        "%d flagged (< threshold), %d re-resolved in f64",
        stats["min_margin"], stats["n_positions"], stats["n_flagged"],
        stats["n_changed"])
    metadata = {
        "m": model.name,
        "al": int(np.shape(wav)[-1]),
        "nc": int(frames[0][0].shape[1]),
        "lm": False,
    }
    binary.write_ecdc_header(fo, metadata)
    for codes, scale in frames:
        if scale is not None:
            fo.write(_SCALE.pack(float(scale.reshape(-1)[0])))
        codes = codes[0].cpu().numpy()                       # [K, T]
        fo.write(binary.pack_bits(codes.T, model.bits_per_codebook))


def decompress_from_file(fo: tp.IO[bytes], models=None
                         ) -> tp.Tuple[torch.Tensor, int]:
    """Decompress a raw `.ecdc` stream → `(wav [C, T], sample_rate)`.

    `models` overrides the pretrained registry (name → factory called with
    `pretrained=True`), e.g. for locally trained or random-weight models."""
    from ..models.model import MODELS

    metadata = binary.read_ecdc_header(fo)
    model_name = metadata["m"]
    audio_length = metadata["al"]
    num_codebooks = metadata["nc"]
    if not isinstance(audio_length, int) or not isinstance(num_codebooks, int):
        raise ValueError("malformed .ecdc header")
    registry = models if models is not None else MODELS
    if model_name not in registry:
        raise ValueError(
            f"The audio was compressed with an unsupported model {model_name}.")
    if metadata["lm"]:
        raise NotImplementedError(_LM_MISSING)
    model = registry[model_name](pretrained=True)
    bits = model.bits_per_codebook
    frames = []
    for _offset, length in model.cfg.segments(audio_length):
        scale = None
        if model.normalize:
            scale_f, = _SCALE.unpack(binary._read_exactly(fo, _SCALE.size))
            scale = torch.full((1, 1), scale_f, dtype=torch.float32)
        frame_length = int(math.ceil(
            length * model.frame_rate / model.sample_rate))
        nbytes = (frame_length * num_codebooks * bits + 7) // 8
        vals = binary.unpack_bits(binary._read_exactly(fo, nbytes), bits,
                                  count=frame_length * num_codebooks)
        codes = vals.reshape(frame_length, num_codebooks).T.astype(np.int32)
        frames.append((torch.from_numpy(codes)[None], scale))
    wav = model.decode(frames)
    return wav[0, :, :audio_length], model.sample_rate


def compress(model, wav, use_lm: bool = False, models=None) -> bytes:
    """Compress a `[C, T]` waveform, returning the `.ecdc` bytes."""
    fo = io.BytesIO()
    compress_to_file(model, wav, fo, use_lm=use_lm, models=models)
    return fo.getvalue()


def decompress(compressed: bytes, models=None) -> tp.Tuple[torch.Tensor, int]:
    """Decompress `.ecdc` bytes → `(wav [C, T], sample_rate)`."""
    return decompress_from_file(io.BytesIO(compressed), models=models)
