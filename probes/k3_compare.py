#!/usr/bin/env python3
"""K3's kernels timed on the card, for one checkout or two.

    python3 probes/k3_compare.py                 # this checkout
    python3 probes/k3_compare.py --parent DIR    # DIR, this, this, DIR
    python3 probes/k3_compare.py --barrier       # the step boundary alone
    python3 probes/k3_compare.py --parent DIR --only cluster bwd

Shapes: the grid kernel at H=1024 (B=1 and 32, T=480; B=1, T=64; from
zero state and from a state) and its saving variant (B=1, 16 and 32); the
cluster kernel at H=512 from zero state at the 24 kHz main path's B=1 and
4 (T=750), from a state at the batch tool's chunk (B=1, T=256), from
zero state at the 48 kHz request's B=10 (T=150) and at B=15, 16 (the LM
trainer's codes) and 21 (T=750), saving at the configs' B=8 (T = 1,440,
2,880, 14,400) and at B=14; the backward at H=1024 (B=1 and 32, T=480;
the grid backward), and at H ≤ 512 (the cluster backward in a checkout
that has it, else the grid one): B=4, T=750 and B=8, 14, 16 and 32 at
T=1,440, B=8 at T=2,880 and 14,400 (H=512), B=1, T=14,400 (H=256).

Each checkout runs in a process of its own (`--worker ROOT` imports
`encodec_tpu_torch` from ROOT and builds its kernels there), so two
versions of the package are timed on one card in one call, in turns.
Times are CUDA events around back-to-back calls of the public entry points
(`kernels.lstm_scan`, `kernels.lstm_scan_backward`): device time where the
host keeps ahead, which it does at these sizes. Each shape reports the
median of 5 windows. Prints one line per shape and checkout, then a JSON
line `{"k3_compare": ...}`.

`--barrier` builds `probes/k3_barrier.cu` (one CTA of 512 threads per SM,
cooperative, as the kernels launch) and times T=480 steps of the step
boundary alone: the arrival-counter barrier, the barrier plus reading h
back through L2 (B=1 and 32, H=1024), and polling h for the words it
needs with no barrier.

Imports no JAX. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
GRID = [(1, 480, False), (1, 480, True), (32, 480, False), (32, 480, True),
        (1, 64, False), (1, 64, True)]
SAVE = [(1, 480), (16, 480), (32, 480)]
CLUSTER = [(1, 750, "zero"), (4, 750, "zero"), (1, 256, "state"),
           (10, 150, "zero"), (15, 750, "zero"),
           (16, 750, "zero"), (21, 750, "zero"), (8, 1440, "save"),
           (8, 2880, "save"), (8, 14_400, "save"), (14, 1440, "save")]
BWD = [(1, 480, 1024), (32, 480, 1024), (4, 750, 512), (8, 1440, 512),
       (8, 2880, 512), (8, 14_400, 512), (14, 1440, 512), (16, 1440, 512),
       (32, 1440, 512), (1, 14_400, 256)]


def gauss(torch, shape, seed, dev, scale=1.0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(*shape) * scale)
                            .astype(np.float32)).to(dev)


def weights(torch, H, seed, dev):
    rng = np.random.RandomState(seed)
    lim = 1.0 / math.sqrt(H)
    return torch.from_numpy(rng.uniform(-lim, lim, (4 * H, H))
                            .astype(np.float32)).to(dev)


def window_ms(torch, fn, iters: int, windows: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


GROUPS = ("grid", "save", "cluster", "bwd")


def worker(root: str, only=GROUPS) -> dict:
    sys.path.insert(0, root)
    import torch

    import encodec_tpu_torch
    from encodec_tpu_torch import kernels
    from encodec_tpu_torch.device import set_fp32_policy
    from encodec_tpu_torch.kernels import build

    pkg = Path(encodec_tpu_torch.__file__).resolve().parent
    assert pkg.parent == Path(root).resolve(), (pkg, root)
    set_fp32_policy()
    build.build_all()
    dev = torch.device("cuda")
    res = {}
    H = 1024
    w = weights(torch, H, 51, dev)
    for B, T, stateful in GRID if "grid" in only else ():
        xp = gauss(torch, (B, T, 4 * H), 52, dev)
        st = ((torch.tanh(gauss(torch, (B, H), 53, dev)),
               gauss(torch, (B, H), 54, dev)) if stateful else (None, None))
        res[f"grid B={B} T={T}{' state' if stateful else ''}"] = window_ms(
            torch, lambda: kernels.lstm_scan(xp, w, *st, return_state=True),
            20 if T >= 480 else 100)
    for B, T in SAVE if "save" in only else ():
        xp = gauss(torch, (B, T, 4 * H), 52, dev)
        h0 = torch.tanh(gauss(torch, (B, H), 53, dev))
        c0 = gauss(torch, (B, H), 54, dev)
        res[f"save B={B} T={T}"] = window_ms(
            torch, lambda: kernels.lstm_scan(xp, w, h0, c0, save_c=True), 20)
    Hc = 512
    wc = weights(torch, Hc, 51, dev)
    for B, T, mode in CLUSTER if "cluster" in only else ():
        xp = gauss(torch, (B, T, 4 * Hc), 52, dev)
        st = ((torch.tanh(gauss(torch, (B, Hc), 53, dev)),
               gauss(torch, (B, Hc), 54, dev)) if mode == "state"
              else (None, None))
        res[f"cluster {mode} B={B} T={T} H={Hc}"] = window_ms(
            torch, lambda: kernels.lstm_scan(
                xp, wc, *st, return_state=mode == "state",
                save_c=mode == "save"),
            3 if T > 2000 else 10)
        del xp
    for B, T, Hb in BWD if "bwd" in only else ():
        wb = weights(torch, Hb, 61, dev)
        xp = gauss(torch, (B, T, 4 * Hb), 62, dev)
        h0 = torch.tanh(gauss(torch, (B, Hb), 63, dev))
        c0 = gauss(torch, (B, Hb), 64, dev)
        dy = gauss(torch, (B, T, Hb), 65, dev)
        out, c_seq = kernels.lstm_scan(xp, wb, h0, c0, save_c=True)
        h_prev = torch.cat([h0[:, None], out[:, :-1]], 1)
        pre = (xp + h_prev @ wb.t()).contiguous()
        res[f"bwd B={B} T={T} H={Hb}"] = window_ms(
            torch, lambda: kernels.lstm_scan_backward(pre, c_seq, dy, wb, c0),
            3 if T > 2000 else 10 if T > 1000 else 20)
        del xp, out, c_seq, h_prev, pre, dy
        torch.cuda.empty_cache()
    return res


def barrier() -> None:
    sys.path.insert(0, str(HERE))
    import torch

    from encodec_tpu_torch.kernels import build

    out_dir = HERE / "encodec_tpu_torch" / "kernels" / "_build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libk3_barrier.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(HERE / "probes" / "k3_barrier.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.k3_boundary_launch.argtypes = [P, P, I, I, I, I, I, I, P]
    lib.k3_boundary_launch.restype = I
    dev = torch.device("cuda")
    T, H, U = 480, 1024, 8
    G = H // U
    rows = {}
    for mode, label in ((0, "counter barrier"),
                        (1, "counter barrier + h read back (ld.cg)"),
                        (2, "polled h, no barrier")):
        for B in ((1,) if mode == 0 else (1, 32)):
            buf = torch.empty(T * B * H, device=dev)
            counter = torch.zeros(1, device=dev, dtype=torch.int32)
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                counter.zero_()
                rc = lib.k3_boundary_launch(buf.data_ptr(), counter.data_ptr(),
                                            mode, B, T, H, U, G, stream)
                assert rc == 0, rc

            ms = window_ms(torch, run, 10)
            rows[f"{label} B={B}"] = ms
            print(f"K3 step boundary alone, {label}, B={B}, T={T}, H={H}, "
                  f"{G} CTAs: {ms:.4f} ms ({ms / T * 1e3:.3f} us/step)")
    print(json.dumps({"k3_barrier": rows}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--barrier", action="store_true")
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=GROUPS,
                    help="the groups of shapes to time (default: all)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_compare: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        print("K3TIMES " + json.dumps(worker(args.worker, args.only)))
        return 0
    if args.barrier:
        barrier()
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    parent = str(Path(args.parent).resolve()) if args.parent else None
    order = ([("parent", parent), ("change", str(HERE)),
              ("change", str(HERE)), ("parent", parent)]
             if parent else [("this", str(HERE))])
    runs = []
    for label, root in order:
        proc = subprocess.run([sys.executable, __file__, "--worker", root,
                               "--only", *args.only],
                              capture_output=True, text=True, cwd=root)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("K3TIMES ")), None)
        if proc.returncode != 0 or line is None:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append((label, json.loads(line[len("K3TIMES "):])))
    for shape in runs[0][1]:
        print(f"{shape}: " + ", ".join(
            f"{label} {res[shape]:.4f}" for label, res in runs) + " ms")
    print(json.dumps({"k3_compare": {"order": [r[0] for r in runs],
                                     "ms": [r[1] for r in runs],
                                     "device": smi}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
