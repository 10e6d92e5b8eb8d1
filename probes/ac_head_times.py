#!/usr/bin/env python3
"""`ac_head_pull` (csrc/ac_decode.cu) timed alone on the card, at the
decode's shapes and at shapes that split its time between building the
rows and the chain of pulls.

    python3 probes/ac_head_times.py

Shapes (S lanes, K codebooks, card): the requests' (2, 32, 1024) and
(11, 16, 1024); (2, 1, 1024), one row and one pull per lane; (2, 32, 16),
rows of 16 entries, nearly all chain; (32, 32, 1024), more lanes than the
requests have. Inputs: a seeded random head's product (integers as
float64, logits spread over 4000 A10 units) and a seeded random stream
per lane. Each shape, after 20 launches: the kernel's device time under
torch.profiler over 200 launches, and CUDA events over 200 back-to-back
wrapper calls (the host's cost of a call where that is larger). The state
is not reset between launches: the lanes go on decoding, the same work
per pull. Prints one line per shape and a JSON line
`{"ac_head_times": ...}` with the card's name and power limit.

Imports no JAX. Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = [(2, 32, 1024), (11, 16, 1024), (2, 1, 1024), (2, 32, 16),
          (32, 32, 1024)]


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from encodec_tpu_torch.kernels import ac_head_pull, build
    from encodec_tpu_torch.models import ilm
    from encodec_tpu_torch.stream import device_ac

    if not torch.cuda.is_available():
        print("ac_head_times: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    build.load_library("ac_decode")
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    lut = torch.from_numpy(ilm.exp2_table().astype(np.int64)).to(dev)
    out = []
    for S, K, card in SHAPES:
        e0, spread = 4, 4000 << 4
        acc = torch.from_numpy(rng.randint(-spread, spread + 1, (K, S, card))
                               .astype(np.float64)).to(dev)
        head_b = torch.from_numpy(rng.randint(-2000, 2001, (K, card))
                                  .astype(np.int32)).to(dev)
        data = torch.from_numpy(rng.randint(0, 256, (S, 4096))
                                .astype(np.uint8)).to(dev)
        nbits = torch.full((S,), 8 * 4096, dtype=torch.int64, device=dev)
        ts = torch.full((S,), 1 << 30, dtype=torch.int64, device=dev)
        t = torch.zeros(1, dtype=torch.int64, device=dev)
        state = device_ac.init_state(S, dev)
        codes = torch.zeros((1, S, K), dtype=torch.int64, device=dev)
        feed = torch.zeros((S, K), dtype=torch.int64, device=dev)
        ok = torch.ones(S, dtype=torch.bool, device=dev)
        eof = torch.zeros(S, dtype=torch.bool, device=dev)

        def call():
            ac_head_pull(state, acc, head_b, e0, lut, data, nbits, ts, t,
                         codes, feed, ok, eof)

        for _ in range(20):
            call()
        torch.cuda.synchronize()
        n = 200
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if "ac_head_pull_kernel" in e.key]
        launches = sum(e.count for e in kern)
        us = sum(e.self_device_time_total for e in kern) / max(1, launches)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            call()
        end.record()
        torch.cuda.synchronize()
        call_us = start.elapsed_time(end) / n * 1e3
        print(f"ac_head_pull S={S} K={K} card={card}: device {us:.2f} us "
              f"per launch ({launches} profiled), {us / K:.3f} us per pull "
              f"with its row; per wrapper call (events) {call_us:.2f} us")
        out.append(dict(S=S, K=K, card=card, us=us, launches=launches,
                        call_us=call_us))
    print(json.dumps({"ac_head_times": dict(card=smi, shapes=out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
