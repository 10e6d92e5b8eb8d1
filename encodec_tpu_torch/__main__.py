"""`encodec`-compatible command line for the PyTorch/CUDA port.

Usage:
    python -m encodec_tpu_torch INPUT.wav [OUTPUT.ecdc|OUTPUT.wav] [-b BW] [-q]
    python -m encodec_tpu_torch INPUT.ecdc [OUTPUT.wav]

.wav input → compression (or a full roundtrip when the output is also
.wav); .ecdc input → decompression. Checkpoints are read from a local
`--repository DIR`, the LM's too (`encodec_lm_24khz-1608e3c0.th`,
`encodec_lm_48khz-7add9fc3.th`). `-q/--hq` selects the 48 kHz stereo model
(which does not serve 1.5 kbps). `-l/--lm` entropy-codes with the integer
LM (lmv=3), in blocks of `--lm-restart N` tokens on the 24 kHz model.
`--device` (default `cuda`) picks where the codec and the LM run; without a
GPU pass `--device cpu`. `--lm-pinned` (the JAX tool's lmv=2) is refused.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

SUFFIX = ".ecdc"


def get_parser():
    parser = argparse.ArgumentParser(
        "encodec_tpu_torch",
        description="High fidelity neural audio codec (PyTorch/CUDA port). "
                    "If input is a .ecdc, decompresses it. "
                    "If input is .wav, compresses it. If output is also wav, "
                    "do a compression/decompression cycle.")
    parser.add_argument("input", type=Path,
                        help="Input file (wav or ecdc).")
    parser.add_argument("output", type=Path, nargs="?",
                        help="Output file, otherwise inferred from input.")
    parser.add_argument("-b", "--bandwidth", type=float, default=6,
                        choices=[1.5, 3., 6., 12., 24.],
                        help="Target bandwidth (1.5, 3, 6, 12 or 24 kbps). "
                             "1.5 is not supported with --hq.")
    parser.add_argument("-q", "--hq", action="store_true",
                        help="Use the 48 kHz stereo HQ model.")
    parser.add_argument("-l", "--lm", action="store_true",
                        help="Entropy-code with the language model "
                             "(smaller files, slower).")
    parser.add_argument("-f", "--force", action="store_true",
                        help="Overwrite output file if it exists.")
    parser.add_argument("-s", "--decompress_suffix", type=str,
                        default="_decompressed",
                        help="Suffix for the decompressed output file.")
    parser.add_argument("-r", "--rescale", action="store_true",
                        help="Rescale the output to avoid clipping.")
    parser.add_argument("--lm-pinned", action="store_true",
                        help="the JAX tool's lmv=2 LM stream; refused by "
                             "the port, which writes the portable lmv=3.")
    parser.add_argument("--lm-restart", type=_lm_restart_arg,
                        default="auto", metavar="N",
                        help="with --lm: reset the LM every N tokens and "
                             "entropy-code blocks independently — slightly "
                             "larger files, block-parallel decoding. "
                             "Default 'auto' (375 tokens, 5 s) on "
                             "single-frame streams; 0 disables blocking.")
    parser.add_argument("--repository", type=Path, default=None,
                        help="Local directory with the pretrained .th "
                             "checkpoints.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to run the codec on (default cuda; "
                             "'cpu' runs the kernels' plain twins).")
    return parser


def _lm_restart_arg(s: str):
    """'auto' (default) | 0/none (disable) | positive int block length."""
    if s.lower() == "auto":
        return "auto"
    if s.lower() in ("0", "none", "off"):
        return None
    n = int(s)
    if n <= 0:
        raise ValueError(s)
    return n


def fatal(*args):
    print(*args, file=sys.stderr)
    sys.exit(1)


def check_output_exists(args):
    if not args.output.parent.exists():
        fatal(f"Output folder for {args.output} does not exist.")
    if args.output.exists() and not args.force:
        fatal(f"Output file {args.output} exist. Use -f / --force to overwrite.")


def check_clipping(wav, args):
    import numpy as np
    if args.rescale:
        return
    mx = float(np.abs(np.asarray(wav)).max())
    if mx > 0.99:
        print(f"Clipping!! max scale {mx}, limit is 0.99. "
              "To avoid clipping, use the `-r` option to rescale the output.",
              file=sys.stderr)


def main():
    args = get_parser().parse_args()
    if not args.input.exists():
        fatal(f"Input file {args.input} does not exist.")
    if args.lm_pinned:
        fatal("--lm-pinned (lmv=2) streams are pinned to the JAX package's "
              "compiled float-LM executable; the port writes only the "
              "portable lmv=3 format (drop --lm-pinned).")

    # import lazily so `--help` stays instant
    from .models.model import MODELS, TARGET_BANDWIDTHS
    from .stream import compress, decompress
    from .utils.audio import load_wav, save_wav, convert_audio

    rep = str(args.repository) if args.repository else None
    models = {name: (lambda pretrained=True, fn=fn: fn(
        pretrained=pretrained, repository=rep, device=args.device))
        for name, fn in MODELS.items()}

    def write_wav(out, sample_rate):
        out = out.cpu().numpy()
        check_clipping(out, args)
        save_wav(out, args.output, sample_rate, rescale=args.rescale)

    if args.input.suffix.lower() == SUFFIX:
        if args.output is None:
            args.output = args.input.with_name(
                args.input.stem + args.decompress_suffix + ".wav")
        elif args.output.suffix.lower() != ".wav":
            fatal("Output extension must be .wav")
        check_output_exists(args)
        write_wav(*decompress(args.input.read_bytes(), device=args.device,
                              repository=rep))
        return

    if args.output is None:
        args.output = args.input.with_suffix(SUFFIX)
    elif args.output.suffix.lower() not in [SUFFIX, ".wav"]:
        fatal(f"Output extension must be .wav or {SUFFIX}")
    check_output_exists(args)
    model_name = "encodec_48khz" if args.hq else "encodec_24khz"
    # refuse an unserved bandwidth before any checkpoint is read
    if args.bandwidth not in TARGET_BANDWIDTHS[model_name]:
        fatal(f"Bandwidth {args.bandwidth} is not supported by the model "
              f"{model_name}")
    model = models[model_name]()
    model.set_target_bandwidth(args.bandwidth)
    wav, sr = load_wav(args.input)
    wav = convert_audio(wav, sr, model.sample_rate, model.channels)
    lm = None
    if args.lm:
        from .models.lm import get_lm_model
        lm = get_lm_model(model, repository=rep)
    compressed = compress(model, wav, use_lm=args.lm, lm=lm, models=models,
                          lm_restart=args.lm_restart)
    if args.output.suffix.lower() == SUFFIX:
        args.output.write_bytes(compressed)
    else:
        # the roundtrip decodes with the model and LM that encoded
        write_wav(*decompress(compressed, lm=lm,
                              models={model.name: lambda pretrained=True: model}))


if __name__ == "__main__":
    main()
