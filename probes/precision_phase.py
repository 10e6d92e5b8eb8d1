#!/usr/bin/env python3
"""`chip_smoke.py`'s reduced-precision phase alone, on one GPU.

    python3 probes/precision_phase.py

Builds the kernels and the full-width 24 kHz model (seeded random
weights, `kmeans_init=False`), then runs `chip_smoke.phase_precision`:
(a) a bf16 generator, GAN generator and discriminator step of gan.yaml's
model at B=4 on 4 h nights against the float32 steps and the plain twins;
(b) a 10 s 24 kHz request at 'high' and 'fast' (the twins, the writer's
refusals, the guarded 'high' encode, the TF32 flags). Prints the
phase's lines, its launch counts and the card's name and power limit.

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
        print("precision_phase: no CUDA device", file=sys.stderr)
        return 2
    set_fp32_policy()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    model = encodec_model_24khz(kmeans_init=False, device=dev)
    registry = {model.name: lambda pretrained=True: model}
    train, req = chip_smoke.phase_precision(torch, kernels, dev, model,
                                            registry)
    print(json.dumps({"bf16_train": train, "precision_high_fast": req}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
