"""Batch (directory) compression and decompression.

Port of `encodec_tpu/tools/batch.py`.

- `compress_directory` writes `out_dir/<stem>.ecdc` for every `.wav` of a
  directory. Causal, unsegmented models (24 kHz) extract the codes
  through `tools.inference._StreamExtractor`: fixed-shape chunks of the
  streaming encoder (K3 from the carried state, K2 per chunk on the card),
  so a sweep over files of any length meets a bounded set of convolution
  shapes; the codes equal the offline encoder's, so the bytes equal
  per-file `stream.compress_to_file`'s. Files shorter than one chunk are
  encoded offline at their own length (a warning says so once).
  Segmented or normalized models (48 kHz) take the per-file path: their
  per-segment scale depends on whole-segment content.
- `decompress_directory` decodes every `.ecdc` of a directory to a wav,
  building the model and, for LM-coded files, the LM once per model name.
  Single-frame lmv=3 files of causal models decode their range-coded
  streams in lockstep across files (`lockstep` lanes of one integer-LM
  step each; the codes, CRC checks and wavs equal per-file decoding).

The JAX tool pads each decode to a power-of-two length only to bound its
XLA compiles (`_make_bucketed_decode`); the port decodes every file at its
own length.

    python -m encodec_tpu_torch.tools.batch IN_DIR OUT_DIR [-b BW] [--lm] \
        [--decompress] [--pcm16] [--repository DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import typing as tp
import warnings

import numpy as np
import torch


def compress_directory(model, in_dir: str, out_dir: str, *,
                       use_lm: bool = False, lm=None, models=None,
                       lm_restart: tp.Union[int, str, None] = None,
                       chunk_hops: int = 1024, progress: bool = False
                       ) -> tp.List[str]:
    """Compress every `.wav` under `in_dir` (not recursive) to
    `out_dir/<stem>.ecdc`, on the model's device. Returns the written
    paths, in name order."""
    from ..stream.compress import compress_to_file
    from ..utils.audio import convert_audio, load_wav

    extractor = None
    if model.cfg.seanet.causal and not model.normalize \
            and model.segment_length is None:
        from .inference import _StreamExtractor
        extractor = _StreamExtractor(model, chunk_hops=chunk_hops)

    os.makedirs(out_dir, exist_ok=True)
    written: tp.List[str] = []
    warned_short = False
    names = sorted(n for n in os.listdir(in_dir) if n.endswith(".wav"))
    for i, name in enumerate(names):
        wav, sr = load_wav(os.path.join(in_dir, name))
        wav = convert_audio(wav, sr, model.sample_rate, model.channels)
        frames = None
        if extractor is not None:
            if not warned_short and wav.shape[-1] < extractor.chunk:
                warnings.warn(
                    f"{name} ({wav.shape[-1]} samples) is shorter than the "
                    f"shared extractor chunk ({extractor.chunk}); such files "
                    "are encoded offline at their own length, each new "
                    "length with new convolution shapes: pass a smaller "
                    "--chunk-hops to stream them in shared shapes",
                    stacklevel=2)
                warned_short = True
            codes = extractor(np.asarray(wav))                   # [K, T']
            frames = [(torch.from_numpy(codes)[None], None)]
        out_path = os.path.join(out_dir, os.path.splitext(name)[0] + ".ecdc")
        with open(out_path, "wb") as fo:
            compress_to_file(model, np.asarray(wav), fo, use_lm=use_lm,
                             lm=lm, models=models, lm_restart=lm_restart,
                             frames=frames)
        written.append(out_path)
        if progress:
            print(f"[{i + 1}/{len(names)}] {name} -> "
                  f"{os.path.getsize(out_path)} bytes", flush=True)
    return written


def _lockstep_eligible(meta: dict, model) -> bool:
    """A single-frame lmv=3 file of a causal, unsegmented model."""
    return (bool(meta.get("lm")) and meta.get("lmv") == 3
            and "fl" not in meta and "lmb" not in meta
            and model.cfg.seanet.causal and not model.normalize
            and model.segment_length is None)


def decompress_directory(in_dir: str, out_dir: str, *, models=None, lm=None,
                         repository: tp.Optional[str] = None,
                         pcm16: bool = False, progress: bool = False,
                         lockstep: int = 16,
                         device: tp.Union[str, torch.device] = "cuda"
                         ) -> tp.List[str]:
    """Decompress every `.ecdc` under `in_dir` to `out_dir/<stem>.wav`.

    The model is built once per model name (from `models`, else from the
    registry's published checkpoint in `repository`, on `device`), the LM
    once per model name on the first LM-coded file (`lm` when given, else
    the model's published LM from `repository`). Up to `lockstep`
    single-frame lmv=3 files share one lockstep range decode (`lockstep=1`
    decodes file by file; the wavs are the same). `pcm16=True` quantizes
    the audio to int16 on the device (the same quantizer as the host wav
    writer). Returns the written paths, in name order."""
    from ..device import resolve_device
    from ..models.ilm import IntLMModel, codes_checksum
    from ..models.model import MODELS
    from ..stream import binary
    from ..stream.compress import decompress_from_file
    from ..utils.audio import save_wav

    if models is None:      # the registry's models are built on `device`
        device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    registry = dict(models if models is not None else MODELS)
    built: tp.Dict[str, tp.Any] = {}
    lms: tp.Dict[str, tp.Any] = {}
    names = sorted(n for n in os.listdir(in_dir) if n.endswith(".ecdc"))

    def get_model(model_name):
        if model_name not in built:
            if model_name not in registry:
                raise ValueError(f"{model_name}: not a registered model")
            if models is None:
                built[model_name] = registry[model_name](
                    pretrained=True, repository=repository, device=device)
            else:
                built[model_name] = registry[model_name](pretrained=True)
        return built[model_name]

    def get_lm(model_name):
        if lm is not None:
            return lm
        if model_name not in lms:
            from ..models.lm import get_lm_model
            lms[model_name] = get_lm_model(get_model(model_name),
                                           repository=repository)
        return lms[model_name]

    def decode(model, frames):
        return model.decode(frames, pcm16=pcm16)

    # headers only: route each file to the lockstep LM path or the per-file
    # path
    metas = []
    groups: tp.Dict[tp.Tuple[str, int], tp.List[int]] = {}
    for i, name in enumerate(names):
        with open(os.path.join(in_dir, name), "rb") as fo:
            meta = binary.read_ecdc_header(fo)
            offset = fo.tell()
        metas.append((meta, offset))
        if lockstep > 1 and _lockstep_eligible(meta, get_model(meta["m"])):
            groups.setdefault((meta["m"], int(meta["nc"])), []).append(i)

    written: tp.Dict[int, str] = {}

    def emit(i, wav, sr):
        out_path = os.path.join(out_dir,
                                os.path.splitext(names[i])[0] + ".wav")
        save_wav(wav.cpu().numpy(), out_path, sr)
        written[i] = out_path
        if progress:
            print(f"[{len(written)}/{len(names)}] {names[i]} -> {out_path}",
                  flush=True)

    for (model_name, n_q), idxs in groups.items():
        model = get_model(model_name)
        ilm = IntLMModel.from_lm(get_lm(model_name))
        for s0 in range(0, len(idxs), lockstep):
            lane = idxs[s0:s0 + lockstep]
            datas, lengths = [], []
            for i in lane:
                meta, offset = metas[i]
                with open(os.path.join(in_dir, names[i]), "rb") as fo:
                    fo.seek(offset)
                    datas.append(fo.read())
                lengths.append(math.ceil(
                    meta["al"] * model.frame_rate / model.sample_rate))
            all_codes = ilm.decode_lockstep(datas, n_q, lengths)
            for s, i in enumerate(lane):
                meta = metas[i][0]
                codes = all_codes[s, :, :lengths[s]]
                got = codes_checksum([codes])
                if "cc" in meta and got != meta["cc"]:
                    raise ValueError(
                        f"{names[i]}: lmv=3 code checksum mismatch (got "
                        f"{got:#x}, header says {meta['cc']:#x}): corrupt "
                        "stream or decoder bug; refusing to emit audio.")
                frames = [(torch.from_numpy(codes.astype(np.int32))[None],
                           None)]
                wav = decode(model, frames)
                emit(i, wav[0, :, :meta["al"]], model.sample_rate)

    grouped = {i for g in groups.values() for i in g}
    for i, name in enumerate(names):
        if i in grouped:
            continue
        meta = metas[i][0]
        model = get_model(meta["m"])
        with open(os.path.join(in_dir, name), "rb") as fo:
            wav, sr = decompress_from_file(
                fo, models={meta["m"]: lambda pretrained=True, m=model: m},
                lm=get_lm(meta["m"]) if meta["lm"] else None,
                decode=lambda frames, m=model: decode(m, frames))
        emit(i, wav, sr)
    return [written[i] for i in range(len(names))]


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.List[str]:
    parser = argparse.ArgumentParser(
        "encodec_tpu_torch.tools.batch",
        description="Compress (or --decompress) every file of a directory")
    parser.add_argument("in_dir")
    parser.add_argument("out_dir")
    parser.add_argument("--decompress", action="store_true",
                        help="decode .ecdc files to wavs instead")
    parser.add_argument("--pcm16", action="store_true",
                        help="quantize decoded audio to int16 on the device")
    parser.add_argument("-b", "--bandwidth", type=float, default=6.0)
    parser.add_argument("--hq", action="store_true",
                        help="the 48 kHz stereo model (per-file path)")
    parser.add_argument("--lm", action="store_true")
    parser.add_argument("--lm-restart", type=int, default=None)
    parser.add_argument("--repository", default=None,
                        help="local directory of the published checkpoints")
    parser.add_argument("--chunk-hops", type=int, default=1024)
    parser.add_argument("--device", default="cuda",
                        help="where the codec and the LM run (cuda or cpu)")
    args = parser.parse_args(argv)

    if args.decompress:
        paths = decompress_directory(args.in_dir, args.out_dir,
                                     repository=args.repository,
                                     pcm16=args.pcm16, progress=True,
                                     device=args.device)
    else:
        from ..models.model import encodec_model_24khz, encodec_model_48khz
        factory = encodec_model_48khz if args.hq else encodec_model_24khz
        model = factory(pretrained=True, repository=args.repository,
                        device=args.device)
        model.set_target_bandwidth(args.bandwidth)
        lm = model.get_lm_model(args.repository) if args.lm else None
        paths = compress_directory(model, args.in_dir, args.out_dir,
                                   use_lm=args.lm, lm=lm,
                                   lm_restart=args.lm_restart,
                                   chunk_hops=args.chunk_hops, progress=True)
    print(f"wrote {len(paths)} files to {args.out_dir}")
    return paths


if __name__ == "__main__":
    main()
