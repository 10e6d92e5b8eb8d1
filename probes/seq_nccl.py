#!/usr/bin/env python3
"""The data×seq training step in an NCCL world, one card per rank.

    python3 probes/seq_nccl.py [--world 4] [--data 2]

Needs `--world` cards (default 4: data 2 x seq 2). Builds the kernels,
then runs `chip_smoke.seq_world` over NCCL: gan.yaml as written at B=4
on 4 h nights, a generator step with the k-means init, then from its
state a generator, a GAN generator and a discriminator step, each held
against one process on card 0 (losses rtol 1e-4, the state at JAX's mesh
bounds, codes outside tie flags, every rank's state equal), with each
rank's launches of K1, K3's saving forward and K3's backward, its ms per
step and its peak memory. This is the run in which the seq halos, tail
hand-offs, gathers and sums cross NCCL between cards (`chip_smoke.py`,
on one card, runs them over gloo, and over NCCL only in groups of one
rank). Prints the cards' names and power limits and, last, the launch
counts per rank as JSON.

Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--data", type=int, default=2)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from encodec_tpu_torch.device import set_fp32_policy
    from encodec_tpu_torch.kernels import build

    if torch.cuda.device_count() < args.world:
        print(f"seq_nccl: {args.world} CUDA devices needed, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    if args.world % args.data:
        print(f"seq_nccl: --data {args.data} does not divide --world "
              f"{args.world}", file=sys.stderr)
        return 2
    set_fp32_policy()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        counts = chip_smoke.seq_world(torch, torch.device("cuda", 0),
                                      Path(tmp), args.world, "nccl",
                                      args.data)
    print(f"seq_nccl: the world took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({f"seq_nccl_{args.data}x{args.world // args.data}"
                      f"_rank{r}": c for r, c in enumerate(counts)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
