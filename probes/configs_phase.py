#!/usr/bin/env python3
"""`chip_smoke.py`'s published-configs phase alone, on one GPU.

    python3 probes/configs_phase.py [--only NAME ...] [--control]

Builds the kernels and runs `chip_smoke.phase_configs`: six configs of
`encodec_tpu_torch/params/` through `python -m encodec_tpu_torch.train`'s
`main` with PyYAML hidden (the batch that fits, the stand-in where the
config's own batch does not, launch counts, resume, the steps against the
plain twins, K1, K2 and K3 on the path's inputs), then `tools.inference`
on default.yaml. `--only` runs the named configs alone (`l2` also runs
the inference tool). `--control` runs each twin check's generator steps
a second time, and the kernels' step twice and the twins' once with
cuDNN free to pick non-deterministic algorithms, and prints those gaps
beside the kernels' (`chip_smoke.config_steps_vs_twins`). Prints the
phase's lines, its launch counts, its kernel rows and the card's name and
power limit.

Imports no JAX. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
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

    parser = argparse.ArgumentParser("configs_phase")
    parser.add_argument("--only", nargs="*", default=None,
                        choices=chip_smoke.CONFIG_RUNS)
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("configs_phase: no CUDA device", file=sys.stderr)
        return 2
    set_fp32_policy()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths, rows = chip_smoke.phase_configs(
        torch, kernels, torch.device("cuda"),
        tuple(args.only or chip_smoke.CONFIG_RUNS), args.control)
    print(f"phase_configs: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"paths": paths, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
