#!/usr/bin/env python3
"""The integer LM's lockstep decode timed on the card, for one checkout or
two.

    python3 probes/lm_decode_compare.py                 # this checkout
    python3 probes/lm_decode_compare.py --parent DIR    # DIR, this, this, DIR

Each checkout runs in a process of its own (`--worker ROOT` imports
`encodec_tpu_torch` from ROOT), so two versions of
`IntLMModel.decode_lockstep` are timed on one card in one call, in turns.
The LMs are the published LM shapes (24 kHz: n_q 32, card 1024, dim 200, 8
heads, 5 layers, W=262; 48 kHz: n_q 16, W=525) with seeded random weights;
the streams code seeded random codes (≈10 bits per symbol, as a request's
codes under a random-weight LM) in the layouts of a 10 s request:
24 kHz at 6 and 24 kbps in 375-token blocks (`lm_restart` auto, 2 lanes),
at 6 kbps unblocked (one lane of 750), and 48 kHz at 24 kbps (11
segments: 10 of 150 tokens and one of 15). Each layout reports the host
clock of its first decode (where the checkout captures a CUDA graph of
the step, the capture is in it) and of a second one, each ending in a copy
to the host, and checks the codes. Where the checkout has the static
decode runner (`models.ilm._DecodeGraph`), it also times that runner's
steps run eagerly, without a capture, so that the graph's share of a gain
is told from the kernel's. Prints one line per layout and checkout, then
a JSON line `{"lm_decode_compare": ...}`.

Imports no JAX. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
# (label, LM n_q, window W, codebooks K, lane lengths, seconds of audio)
LAYOUTS = [
    ("24 kHz @ 6 kbps, lm_restart auto", 32, 262, 8, [375, 375], 10.0),
    ("24 kHz @ 24 kbps, lm_restart auto", 32, 262, 32, [375, 375], 10.0),
    ("24 kHz @ 6 kbps, unblocked", 32, 262, 8, [750], 10.0),
    ("48 kHz @ 24 kbps, 11 segments", 16, 525, 16, [150] * 10 + [15], 10.0),
]


def worker(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import encodec_tpu_torch
    from encodec_tpu_torch.models import ilm as ilm_mod
    from encodec_tpu_torch.models.ilm import IntLMModel
    from encodec_tpu_torch.models.lm import LMConfig, LMModel, init_lm
    from encodec_tpu_torch.stream.ac import encode_bounds

    pkg = Path(encodec_tpu_torch.__file__).resolve().parent
    if pkg.parent != root.resolve():
        raise SystemExit(f"imported {pkg}, not the checkout {root}")
    # the range decoder's library is built before any decode is timed
    from encodec_tpu_torch.kernels import build
    build.load_library("ac_decode")
    out = {}
    models = {}
    for label, n_q, W, K, Ts, seconds in LAYOUTS:
        if (n_q, W) not in models:
            cfg = LMConfig(n_q=n_q, card=1024, dim=200, num_heads=8,
                           num_layers=5, past_context=W)
            params = init_lm(torch.Generator().manual_seed(70 + n_q), cfg)
            models[n_q, W] = IntLMModel.from_lm(
                LMModel(cfg, params, device="cuda"))
        ilm = models[n_q, W]
        rng = np.random.RandomState(sum(Ts) + K)
        codes = [rng.randint(0, ilm.card, (K, T)) for T in Ts]
        datas = [encode_bounds(lo, hi)
                 for lo, hi in ilm.codec_symbol_bounds_batched(codes)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ilm.decode_lockstep(datas, K, Ts)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = ilm.decode_lockstep(datas, K, Ts)
        s = time.perf_counter() - t0
        if not all(np.array_equal(got[i, :, :T], c)
                   for i, (T, c) in enumerate(zip(Ts, codes))):
            raise SystemExit(f"{label}: decoded codes differ from the coded")
        steps = max(Ts)
        out[label] = dict(steps=steps, s=s, first_s=first,
                          ms_per_step=s / steps * 1e3,
                          ms_per_s_audio=s / seconds * 1e3)
        runner_cls = getattr(ilm_mod, "_DecodeGraph", None)
        if runner_cls is not None:
            with torch.inference_mode():
                runner = runner_cls(ilm, len(Ts), K,
                                    max(len(d) for d in datas), steps)
                runner.reset(datas, Ts)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    runner.step()
                eager = runner.codes[:steps].cpu().numpy()
                e = time.perf_counter() - t0
            if not np.array_equal(np.moveaxis(eager, 0, -1), got):
                raise SystemExit(f"{label}: the eager runner's codes differ")
            out[label].update(eager_s=e, eager_ms_per_step=e / steps * 1e3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="another checkout to time "
                    "in turns with this one")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    turns = ([("parent", args.parent), ("change", HERE), ("change", HERE),
              ("parent", args.parent)] if args.parent else [("this", HERE)])
    results = []
    for name, root in turns:
        proc = subprocess.run([sys.executable, __file__, "--worker",
                               str(root)], capture_output=True, text=True,
                              timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        for label, r in res.items():
            eager = (f"; eager runner {r['eager_s']:.3f} s = "
                     f"{r['eager_ms_per_step']:.3f} ms per step"
                     if "eager_s" in r else "")
            print(f"{name} ({root}): {label}: {r['steps']} steps in "
                  f"{r['s']:.3f} s = {r['ms_per_step']:.3f} ms per step, "
                  f"{r['ms_per_s_audio']:.1f} ms per s of audio (first "
                  f"decode {r['first_s']:.3f} s){eager}")
        results.append(dict(turn=name, root=str(root), layouts=res))
    print(json.dumps({"lm_decode_compare": dict(card=smi, turns=results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
