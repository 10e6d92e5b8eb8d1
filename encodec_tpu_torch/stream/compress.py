"""Compress / decompress audio to `.ecdc` bytestreams.

Port of `encodec_tpu/stream/compress.py`: the header (`m`, `al`, `nc`,
`lm`), then per segment, for a normalized model, its big-endian f32 scale,
then its codes: packed LSB-first in (t, k) order (raw), or range-coded
against the integer LM's CDF rows (`use_lm`). The writer encodes through
the near-tie guard (`EncodecModel.encode_guarded` at `GUARD_THRESHOLD`,
1e-3), so positions whose RVQ top-2 gap is razor-thin resolve the same way
in every writer whose latents agree. It writes only at the model's
default `set_precision('highest')`: 'high' (TF32 on the card) and 'fast'
(bf16 conv trunks) move the encoder latents themselves, and the card's
margin audit (`probes/precision_audit.py`) found no guard threshold that
gives the 'highest' writer's codes in either mode, so both are refused.

LM-coded streams are lmv=3: the prior is the integer LM (`models.ilm`), so
any device reproduces the writer's CDF rows bit for bit, and the header's
"cc" (a CRC32 of the code frames) is checked before any audio is emitted.
Three layouts, as the JAX writer lays them out:
- several segments (the 48 kHz codec): one stream per segment, their byte
  lengths in "fl", decoded in lockstep;
- one frame in blocks of "lmb" = R tokens (`lm_restart`, "auto" = 375):
  the LM restarts per block, the blocks' lengths in "fl", decoded in
  lockstep;
- one frame, one stream (the rest of the file).
The range coder runs on the host (native C++, else Python), the LM on the
codec model's device. lmv=2 streams, pinned to the JAX package's float-LM
executable, are refused.

Unsegmented (24 kHz) files are byte-identical to the JAX writer's on the
same weights and audio. In segmented (48 kHz) files the header and every
code byte are identical, but a scale may differ from the JAX writer's by up
to 2 ulp: the per-segment RMS is a float32 reduction whose summation order
each framework picks. Each package reads the other's files.
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
from .ac import encode_bounds

_SCALE = struct.Struct("!f")

# The near-tie guard's threshold: it covers the drift of distances between
# executables at 'highest' (the JAX writer's 1e-3).
GUARD_THRESHOLD = 1e-3

# Why the writer refuses the reduced-precision modes: the margin audit on
# an H100 (`probes/precision_audit.py`, full-size seeded models, 10 s of
# speech-like audio). A flagged position is re-resolved in float64 from
# the writer's own latents, so where a mode's latent drift exceeds a
# position's float64 margin, no threshold gives back the 'highest' codes.
REFUSED_MODES = {
    "high": "TF32 moves the 48 kHz model's latents by up to 4.0e-3, and "
            "its guarded codes stay off the 'highest' writer's at 4, 7, 20 "
            "and 42 of 1,515 positions (3, 6, 12, 24 kbps) at every "
            "threshold from 1e-3 to 2",
    "fast": "its bf16 conv trunks move the 48 kHz model's latents by up to "
            "7.9e-2, and its codes stay off the 'highest' writer's at 78 to "
            "579 of 1,515 positions (3 to 24 kbps) at every threshold from "
            "1e-3 to 2",
}

# Default lm_restart block length for single-frame LM streams when the
# caller asks for "auto" (the CLI default): 5 s of tokens at 75 Hz, the
# JAX package's measured knee of rate cost against lockstep decode lanes
# (encodec_tpu/stream/compress.py:76-84).
DEFAULT_LM_RESTART = 375


def _resolve_lm_restart(lm_restart, use_lm: bool, model):
    """'auto' -> DEFAULT_LM_RESTART on single-frame LM streams, None
    otherwise (segmented models already entropy-code segments
    independently; raw streams carry no LM blocks)."""
    if lm_restart != "auto":
        return lm_restart
    if use_lm and model.segment_length is None:
        return DEFAULT_LM_RESTART
    return None


def _encode_lockstep_streams(ilm, codes_list) -> tp.List[bytes]:
    """AC streams for independent code blocks/frames `[K, T]`, teacher-
    forced in one batched lockstep sweep of the integer LM."""
    return [encode_bounds(lows, highs)
            for lows, highs in ilm.codec_symbol_bounds_batched(codes_list)]


def write_lm_payload(fo: tp.IO[bytes], metadata: dict, frames, ilm,
                     lm_restart: tp.Optional[int]) -> None:
    """Write an lmv=3 file: `metadata` (`m`, `al`, `nc`, `lm`) gains
    `lmv`, `cc` and, by layout, `fl` and `lmb`; then the scales and the
    range-coded streams of `frames` ([(codes [1, K, T], scale or None)])
    under the integer LM `ilm`."""
    from ..models.ilm import ILM_VERSION, codes_checksum

    codes_list = [f[0][0].cpu().numpy() for f in frames]    # [K, T] each
    metadata = dict(metadata, lmv=ILM_VERSION, cc=codes_checksum(codes_list))
    if len(frames) == 1 and lm_restart:
        R = int(lm_restart)
        codes_list = [codes_list[0][:, i:i + R]
                      for i in range(0, codes_list[0].shape[1], R)]
        metadata["lmb"] = R
    streams = _encode_lockstep_streams(ilm, codes_list)
    if len(frames) > 1 or lm_restart:
        metadata["fl"] = [len(s) for s in streams]
    binary.write_ecdc_header(fo, metadata)
    # each segment's scale precedes its stream; a single frame's scale
    # precedes all of its blocks
    for i, stream in enumerate(streams):
        if i < len(frames) and frames[i][1] is not None:
            fo.write(_SCALE.pack(float(frames[i][1].reshape(-1)[0])))
        fo.write(stream)


def compress_to_file(model, wav, fo: tp.IO[bytes], use_lm: bool = False,
                     lm=None, models=None,
                     lm_restart: tp.Union[int, str, None] = None,
                     frames=None, portable: bool = True,
                     tie_guard: bool = True) -> None:
    """Compress a `[C, T]` waveform to a file object.

    `model` is an `EncodecModel` with a target bandwidth set; `models`
    overrides the name registry used for validation. With `use_lm`, `lm`
    (a `models.lm.LMModel`) is the prior; without one the model's published
    LM is needed, which the port reads only from a local repository, so
    pass `lm`. `lm_restart=R` (single-frame streams) restarts the LM every
    R tokens so the blocks decode in lockstep; "auto" picks
    `DEFAULT_LM_RESTART` for LM-coded single-frame streams. `portable=False`
    (the JAX writer's lmv=2) is refused.

    The codes come from the near-tie guard (`tie_guard`, the default:
    `EncodecModel.encode_guarded` at `GUARD_THRESHOLD`), from the plain
    `encode` (`tie_guard=False`), or from the caller (`frames`, e.g. the
    batch tool's streaming extractor): then the codes are the caller's
    contract and `wav` gives only the audio length. A model at
    `set_precision('high')` or 'fast' is refused (RuntimeError), whatever
    the codes' source (`REFUSED_MODES`)."""
    from ..models.model import MODELS

    if np.ndim(wav) != 2:
        raise ValueError("Only a single waveform can be encoded.")
    registry = models if models is not None else MODELS
    if model.name not in registry:
        raise ValueError(f"The provided model {model.name} is not supported.")
    lm_restart = _resolve_lm_restart(lm_restart, use_lm, model)
    # cheap argument validation before any device work or checkpoint load
    if lm_restart and not use_lm:
        raise ValueError(
            "lm_restart only affects LM entropy coding — pass use_lm=True "
            "(CLI: --lm) or drop lm_restart.")
    if lm_restart and model.segment_length is not None:
        raise ValueError(
            "lm_restart applies to single-frame streams (e.g. the 24 kHz "
            "model); segmented models already entropy-code every segment "
            "independently and decode them in parallel.")
    if use_lm and not portable:
        raise ValueError(
            "portable=False (lmv=2) streams are pinned to the JAX package's "
            "compiled float-LM executable; the port writes only the "
            "portable lmv=3 format")
    if model.precision in REFUSED_MODES:
        raise RuntimeError(
            f"refusing to write .ecdc at set_precision({model.precision!r}): "
            f"{REFUSED_MODES[model.precision]} (margin audit on an H100, "
            "probes/precision_audit.py). Write at 'highest', the default.")
    ilm = None
    if use_lm:
        from ..models.ilm import IntLMModel
        from ..models.lm import get_lm_model
        ilm = IntLMModel.from_lm(lm if lm is not None else get_lm_model(model))

    if frames is None and tie_guard:
        frames, stats = model.encode_guarded(
            torch.as_tensor(wav)[None], threshold=GUARD_THRESHOLD)
        logging.getLogger(__name__).log(
            logging.INFO if stats["n_flagged"] else logging.DEBUG,
            "tie guard: min RVQ argmin margin %.3g over %d positions; "
            "%d flagged (< threshold), %d re-resolved in f64",
            stats["min_margin"], stats["n_positions"], stats["n_flagged"],
            stats["n_changed"])
    elif frames is None:
        frames = model.encode(torch.as_tensor(wav)[None])
    metadata = {
        "m": model.name,
        "al": int(np.shape(wav)[-1]),
        "nc": int(frames[0][0].shape[1]),
        "lm": use_lm,
    }
    if use_lm:
        write_lm_payload(fo, metadata, frames, ilm, lm_restart)
        return
    binary.write_ecdc_header(fo, metadata)
    for codes, scale in frames:
        if scale is not None:
            fo.write(_SCALE.pack(float(scale.reshape(-1)[0])))
        codes = codes[0].cpu().numpy()                       # [K, T]
        fo.write(binary.pack_bits(codes.T, model.bits_per_codebook))


def _read_scale(fo, model) -> tp.Optional[torch.Tensor]:
    if not model.normalize:
        return None
    scale_f, = _SCALE.unpack(binary._read_exactly(fo, _SCALE.size))
    return torch.full((1, 1), scale_f, dtype=torch.float32)


def _read_lm_frames(fo, model, metadata, ilm) -> list:
    """The code frames of an lmv=3 payload, CRC-checked against "cc"."""
    from ..models.ilm import codes_checksum

    K = metadata["nc"]
    segments = model.cfg.segments(metadata["al"])
    frame_lengths = metadata.get("fl")
    R = metadata.get("lmb")
    if R is not None and (not isinstance(R, int) or R <= 0):
        raise ValueError(f"malformed .ecdc header: 'lmb' = {R!r}")
    n_frames = [math.ceil(n * model.frame_rate / model.sample_rate)
                for _, n in segments]
    if frame_lengths and R:           # one frame in R-token blocks
        if len(segments) != 1:
            raise ValueError("an 'lmb'-blocked LM stream of a segmented model")
        T = n_frames[0]
        scales = [_read_scale(fo, model)]
        Ts = [min(R, T - i) for i in range(0, T, R)]
        if len(Ts) != len(frame_lengths):
            raise ValueError(f"malformed .ecdc header: {len(Ts)} blocks of "
                             f"{R} tokens, 'fl' lists {len(frame_lengths)}")
        datas = [binary._read_exactly(fo, n) for n in frame_lengths]
    elif frame_lengths:               # one stream per segment
        if len(frame_lengths) != len(segments):
            raise ValueError(f"malformed .ecdc header: {len(segments)} "
                             f"segments, 'fl' lists {len(frame_lengths)}")
        scales, datas = [], []
        for nbytes in frame_lengths:
            scales.append(_read_scale(fo, model))
            datas.append(binary._read_exactly(fo, nbytes))
        Ts = n_frames
    else:                             # one frame, one stream
        if len(segments) != 1:
            # the writer records "fl" for every multi-segment LM file;
            # concatenated streams of unknown lengths cannot be re-sliced
            raise ValueError(
                "multi-segment LM-coded stream without a frame index ('fl') "
                "— not a layout this writer produces; re-encode the file.")
        scales = [_read_scale(fo, model)]
        datas = [fo.read()]
        Ts = n_frames
    codes = ilm.decode_lockstep(datas, K, Ts)
    lanes = [codes[s, :, :Ts[s]] for s in range(len(Ts))]
    if R and frame_lengths:
        lanes = [np.concatenate(lanes, axis=1)]
    got = codes_checksum(lanes)
    if "cc" in metadata and got != metadata["cc"]:
        raise ValueError(
            f"lmv=3 code checksum mismatch (got {got:#x}, header says "
            f"{metadata['cc']:#x}) — corrupt stream or decoder bug; refusing "
            "to emit audio.")
    return [(torch.from_numpy(c.astype(np.int32))[None], scale)
            for c, scale in zip(lanes, scales)]


def read_frames(fo: tp.IO[bytes], models=None, lm=None,
                repository: tp.Optional[str] = None,
                device: tp.Union[str, torch.device] = "cuda"):
    """Read a `.ecdc` stream up to its code frames, without decoding audio:
    returns `(model, frames [(codes [1, K, T], scale or None)], audio
    length)`. An LM-coded stream is decoded with `lm`, else with the
    model's published LM from the local `repository`, on the model's
    device. Without `models`, the registry's published model is read from
    `repository` onto `device`; a `models` registry's factories are called
    with `pretrained=True` alone and place their models themselves."""
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
        lmv = metadata.get("lmv")
        if lmv == 2:
            raise ValueError(
                "this .ecdc is an lmv=2 LM stream, pinned to the JAX "
                "package's compiled float-LM executable that wrote it; the "
                "port decodes only the portable lmv=3 format (re-encode "
                "with the JAX writer's default, or decode it there)")
        if lmv != 3:
            raise ValueError(
                "This LM-coded .ecdc stream was written by an older encoder "
                f"generation (lmv={lmv!r}); its CDFs are not reproducible "
                "by this decoder. Re-encode with the current writer, or "
                "decode raw (no-LM) streams which are unaffected.")
    if models is None:
        model = registry[model_name](pretrained=True, repository=repository,
                                     device=device)
    else:
        model = registry[model_name](pretrained=True)
    if metadata["lm"]:
        from ..models.ilm import IntLMModel
        from ..models.lm import get_lm_model
        if lm is None:
            lm = get_lm_model(model, repository=repository)
        return (model, _read_lm_frames(fo, model, metadata,
                                       IntLMModel.from_lm(lm)), audio_length)
    bits = model.bits_per_codebook
    frames = []
    for _offset, length in model.cfg.segments(audio_length):
        scale = _read_scale(fo, model)
        frame_length = int(math.ceil(
            length * model.frame_rate / model.sample_rate))
        nbytes = (frame_length * num_codebooks * bits + 7) // 8
        vals = binary.unpack_bits(binary._read_exactly(fo, nbytes), bits,
                                  count=frame_length * num_codebooks)
        codes = vals.reshape(frame_length, num_codebooks).T.astype(np.int32)
        frames.append((torch.from_numpy(codes)[None], scale))
    return model, frames, audio_length


def decompress_from_file(fo: tp.IO[bytes],
                         device: tp.Union[str, torch.device] = "cuda",
                         models=None, lm=None,
                         repository: tp.Optional[str] = None,
                         decode=None) -> tp.Tuple[torch.Tensor, int]:
    """Decompress a `.ecdc` stream → `(wav [C, T], sample_rate)`.

    `device` (default "cuda") is where the registry's model and its LM are
    built when `models` is None; `models` overrides the pretrained
    registry (name → factory called with `pretrained=True`), e.g. for
    locally trained or random-weight models; `lm` and `repository` as in
    `read_frames`. `decode(frames)` replaces `model.decode(frames)`, e.g.
    `decode(frames, pcm16=True)` (`tools.batch.decompress_directory`)."""
    model, frames, audio_length = read_frames(fo, models, lm, repository,
                                              device)
    wav = (decode or model.decode)(frames)
    return wav[0, :, :audio_length], model.sample_rate


def compress(model, wav, use_lm: bool = False, lm=None, models=None,
             lm_restart: tp.Union[int, str, None] = None,
             portable: bool = True, tie_guard: bool = True) -> bytes:
    """Compress a `[C, T]` waveform, returning the `.ecdc` bytes."""
    fo = io.BytesIO()
    compress_to_file(model, wav, fo, use_lm=use_lm, lm=lm, models=models,
                     lm_restart=lm_restart, portable=portable,
                     tie_guard=tie_guard)
    return fo.getvalue()


def decompress(compressed: bytes,
               device: tp.Union[str, torch.device] = "cuda", models=None,
               lm=None, repository: tp.Optional[str] = None
               ) -> tp.Tuple[torch.Tensor, int]:
    """Decompress `.ecdc` bytes → `(wav [C, T], sample_rate)`."""
    return decompress_from_file(io.BytesIO(compressed), device=device,
                                models=models, lm=lm, repository=repository)
