#!/usr/bin/env python3
"""`chip_smoke.py`'s parallel phase alone, on one GPU.

    python3 probes/parallel_phase.py

Builds the kernels, the full-width 24 kHz model (seeded random weights,
`kmeans_init=False`) whose books the tensor-parallel check splits, and
runs `chip_smoke.phase_parallel`: (a) NCCL at world 1 in this process
(the data-parallel step against the plain one, bit for bit; a one-epoch
fit with asynchronous saves), (b) a gloo world of 2 on the same card
(DP, GAN, tp, sp and pp against the single-process runs). Prints the
phase's lines, its launch counts per path and rank, and the card's name
and power limit.

Imports no JAX. Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    import chip_smoke
    from encodec_tpu_torch import kernels
    from encodec_tpu_torch.device import set_fp32_policy
    from encodec_tpu_torch.kernels import build
    from encodec_tpu_torch.models import encodec_model_24khz

    if not torch.cuda.is_available():
        print("parallel_phase: no CUDA device", file=sys.stderr)
        return 2
    set_fp32_policy()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    model = encodec_model_24khz(kmeans_init=False, device=dev)
    counts, ranks = chip_smoke.phase_parallel(torch, kernels, dev, model)
    print(json.dumps({"parallel_nccl_w1": counts,
                      **{f"parallel_gloo_w2_rank{r}": c
                         for r, c in enumerate(ranks)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
