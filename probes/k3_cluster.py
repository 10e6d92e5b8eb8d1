#!/usr/bin/env python3
"""K3's cluster kernels on the card: the forward with one or two sequences
per cluster (`csrc/lstm_scan.cu`) and the cluster backward
(`csrc/lstm_bwd_cluster.cu`), checked and timed at the training shapes.

    python3 probes/k3_cluster.py            # resources, checks, times
    python3 probes/k3_cluster.py --quick    # resources and checks only
    python3 probes/k3_cluster.py --breakdown  # timing-only variants

Prints `ptxas -v`'s registers, stack frames and spills of every
instantiation of the two sources (one nvcc each, beside the build), then
holds the kernels against their plain twins (forward within 1e-4;
backward's dgates, dh0 and dc0 within 1e-4 of the twin's largest |value|)
at H = 32, 200, 256 and 512 with B = 1, 4, 8 and 15 and T = 1, 2 and 40,
from zero state and from a state, and checks that row b of a B=8 and a
B=14 launch equals sequence b launched alone, bit for bit, in both
directions. Then (not with --quick) times per layer, by CUDA events
around back-to-back calls of the public entry points (median of 5
windows): the saving forward and the backward at B=8, H=512, T = 1,440 /
2,880 / 14,400 (the configs' training shapes), B=1 and 4 at T=750
forward, and the backward at B=4, T=750 and at B=14 and 32, T=1,440.

With `--breakdown` it first times variants of both sources built by
editing a copy of their text, each beside the unedited build, at one
sequence per cluster (B=4) and two (B=8), T=1,440, both directions: what
each part of a step costs. Timing-only (results wrong, unchecked):
without the cells' expf/tanhf/division (the gates pass through), without
the recurrent product (no FMAs, no loads of W_hh or of the exchanged
vector), without the exchange (no mbarrier waits, no st.async). And the
backward's exchange sent as bulk copies (64 of 128 B per CTA and step at
H=512 instead of 512 st.async of 16 B; its results are right). Ends with
a JSON line `{"k3_cluster": ...}`.

Imports no JAX. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


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


def ptxas(build) -> list:
    """Registers and spills of each kernel instantiation, from ptxas -v."""
    out = HERE / "encodec_tpu_torch" / "kernels" / "_build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    rows = []
    for name in ("lstm_scan", "lstm_bwd_cluster"):
        proc = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out / f"lib{name}_v.so"), str(build.CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        fn, spill = None, (0, 0, 0)
        for line in (proc.stdout + proc.stderr).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn, spill = m.group(1), (0, 0, 0)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and fn:
                spill = tuple(int(g) for g in m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                rows.append((name, fn, int(m.group(1)), spill))
        if proc.returncode:
            print(proc.stdout[-3000:], proc.stderr[-3000:])
            raise SystemExit(f"nvcc failed for {name}")
    for name, fn, regs, spill in rows:
        print(f"ptxas {name} {fn}: {regs} registers, stack frame {spill[0]} "
              f"B, spill stores/loads {spill[1]}/{spill[2]} B")
    return rows


def bwd_inputs(torch, kernels, dev, B, T, H, seed, stateful):
    w = weights(torch, H, seed, dev)
    xp = gauss(torch, (B, T, 4 * H), seed + 1, dev)
    h0 = torch.tanh(gauss(torch, (B, H), seed + 2, dev)) if stateful else None
    c0 = gauss(torch, (B, H), seed + 3, dev) if stateful else None
    out, c_seq = kernels.lstm_scan_plain(xp, w, h0, c0, save_c=True)
    first = torch.zeros(B, 1, H, device=dev) if h0 is None else h0[:, None]
    pre = (xp + torch.cat([first, out[:, :-1]], 1) @ w.t()).contiguous()
    dy = gauss(torch, (B, T, H), seed + 4, dev)
    dc_last = gauss(torch, (B, H), seed + 5, dev, 0.5)
    return xp, w, h0, c0, pre, c_seq, dy, dc_last


def checks(torch, kernels, dev) -> int:
    n = 0
    for H in (32, 200, 256, 512):
        for B in (1, 4, 8, 15):
            for T in (1, 2, 40):
                for stateful in (False, True):
                    xp, w, h0, c0, pre, c_seq, dy, dc_last = bwd_inputs(
                        torch, kernels, dev, B, T, H, 7 + B + T, stateful)
                    got = kernels.lstm_scan(xp, w, h0, c0, save_c=True)
                    want = kernels.lstm_scan_plain(xp, w, h0, c0, save_c=True)
                    err = max(float((g - r).abs().max())
                              for g, r in zip(got, want))
                    assert err <= 1e-4, ("forward", H, B, T, stateful, err)
                    got = kernels.lstm_scan_backward(pre, c_seq, dy, w, c0,
                                                     dc_last)
                    want = kernels.lstm_scan_backward_plain(pre, c_seq, dy, w,
                                                            c0, dc_last)
                    err = max(float((g - r).abs().max())
                              / max(1e-30, float(r.abs().max()))
                              for g, r in zip(got, want))
                    assert err <= 1e-4, ("backward", H, B, T, stateful, err)
                    n += 1
    print(f"checks: {n} shapes, forward and backward within 1e-4 of the "
          "twins")
    for H in (512, 200):
        for B in (8, 14):
            xp, w, h0, c0, pre, c_seq, dy, dc_last = bwd_inputs(
                torch, kernels, dev, B, 40, H, 90 + B, True)
            zero = kernels.lstm_scan(xp, w)
            state, _, cT = kernels.lstm_scan(xp, w, h0, c0, return_state=True)
            saved, cs = kernels.lstm_scan(xp, w, h0, c0, save_c=True)
            assert torch.equal(saved, state)
            whole = kernels.lstm_scan_backward(pre, c_seq, dy, w, c0, dc_last)
            for b in range(B):
                o = slice(b, b + 1)
                assert torch.equal(kernels.lstm_scan(xp[o], w), zero[o]), b
                s1, _, c1 = kernels.lstm_scan(xp[o], w, h0[o], c0[o],
                                              return_state=True)
                assert torch.equal(s1, state[o]) and torch.equal(c1, cT[o])
                assert torch.equal(kernels.lstm_scan(
                    xp[o], w, h0[o], c0[o], save_c=True)[1], cs[o])
                alone = kernels.lstm_scan_backward(pre[o], c_seq[o], dy[o], w,
                                                   c0[o], dc_last[o])
                assert all(torch.equal(a, r[o]) for a, r in zip(alone, whole))
            print(f"bits: H={H} B={B}: every row == its sequence alone, "
                  "forward (zero state, state, saving) and backward")
    return n


def times(torch, kernels, dev) -> dict:
    res = {}
    H = 512
    w = weights(torch, H, 51, dev)
    for B, T in ((1, 750), (4, 750), (8, 750), (10, 150)):
        xp = gauss(torch, (B, T, 4 * H), 52, dev)
        res[f"fwd zero B={B} T={T}"] = window_ms(
            torch, lambda: kernels.lstm_scan(xp, w), 10)
    for B, T in ((8, 1440), (8, 2880), (8, 14_400), (4, 750), (14, 1440),
                 (32, 1440)):
        xp = gauss(torch, (B, T, 4 * H), 62, dev)
        dy = gauss(torch, (B, T, H), 65, dev)
        out, c_seq = kernels.lstm_scan(xp, w, save_c=True)
        pre = (xp + torch.cat([torch.zeros(B, 1, H, device=dev),
                               out[:, :-1]], 1) @ w.t()).contiguous()
        it = 3 if T > 2000 else 10
        res[f"fwd save B={B} T={T}"] = window_ms(
            torch, lambda: kernels.lstm_scan(xp, w, save_c=True), it)
        res[f"bwd B={B} T={T}"] = window_ms(
            torch, lambda: kernels.lstm_scan_backward(pre, c_seq, dy, w), it)
        del xp, dy, out, c_seq, pre
        torch.cuda.empty_cache()
    for k, ms in res.items():
        T = int(k.split("T=")[1])
        print(f"{k} H={H}: {ms:.4f} ms ({ms / T * 1e3:.3f} us/step)")
    return res


# timing-only edits of the kernels' text (results wrong, never checked)
STUBS = """
namespace {
__device__ __forceinline__ void mbar_skip(uint64_t*, unsigned) {}
__device__ __forceinline__ void st_skip(uint32_t, float, uint32_t) {}
__device__ __forceinline__ void st_skip4(uint32_t, float, float, float,
                                         float, uint32_t) {}
__device__ __forceinline__ float skip4(float4, float4, float acc) {
  return acc;
}
}  // namespace
"""
# the backward's exchange as bulk copies: each CTA stages its units'
# dgates, then 4 x C threads each copy one gate's U floats to one CTA
# (cp.async.bulk shared::cta -> shared::cluster, counted on the same
# mbarrier): 64 copies of 128 B per CTA and step at H=512 instead of 512
# st.async of 16 B. Valid where U is a multiple of 4 (H = 256, 512).
BULK = (
    ('#include "cluster.cuh"\n', """#include "cluster.cuh"
namespace {
__device__ __forceinline__ void bulk_copy(uint32_t dst, uint32_t src,
                                          unsigned bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
}  // namespace
"""),
    ("         2 * S * sizeof(uint64_t);\n}",
     "         2 * S * sizeof(uint64_t) + 16 + S * 4 * MAX_UNITS * 4;\n}"),
    ("  uint64_t* bar = reinterpret_cast<uint64_t*>(g_s + 2 * S * GP);  // [S][2]\n",
     "  uint64_t* bar = reinterpret_cast<uint64_t*>(g_s + 2 * S * GP);  // [S][2]\n"
     "  float* stage = reinterpret_cast<float*>(bar + 2 * S + 2);\n"),
    ("  const bool grad_h0 = dh0 != nullptr;\n",
     "  const bool grad_h0 = dh0 != nullptr;\n"
     "  const bool issuer = threadIdx.x < S * 4 * csize;\n"
     "  const int is_j = threadIdx.x / (4 * csize);\n"
     "  const int is_g = (threadIdx.x / csize) % 4;\n"
     "  const uint32_t is_dst = issuer ? map_rank(smem_addr(g_s + u0), threadIdx.x % csize) : 0;\n"
     "  const uint32_t is_bar = issuer ? map_rank(smem_addr(bar), threadIdx.x % csize) : 0;\n"),
    ("        __syncthreads();  // all threads saw this phase before it is re-armed",
     "        if (issuer) asm volatile(\"cp.async.bulk.wait_group.read 0;\" ::: \"memory\");\n"
     "        __syncthreads();"),
    ("        if (send) {\n          // every lane gets the warp's 16 dgates; lane r sends them to CTA r\n",
     "        if (send && j < n_on && cell)\n"
     "          for (int g = 0; g < 4; ++g)\n"
     "            stage[(j * 4 + g) * MAX_UNITS + warp * UNITS_PER_WARP + lane] = d[g];\n"
     "        if (false) {\n"),
    ("      if (send) ++msg;",
     "      if (send) {\n"
     "        asm volatile(\"fence.proxy.async.shared::cta;\" ::: \"memory\");\n"
     "        __syncthreads();\n"
     "        if (issuer && is_j < n_on)\n"
     "          bulk_copy(is_dst + ((2 * is_j + (msg & 1)) * GP + is_g * HP) * 4,\n"
     "                    smem_addr(stage + (is_j * 4 + is_g) * MAX_UNITS), 4u * nu,\n"
     "                    is_bar + (2 * is_j + (msg & 1)) * 8);\n"
     "        ++msg;\n"
     "      }"),
)

BREAKDOWN = {
    "unedited": (),
    "no cell math": (("sigmoidf(", "("), ("tanhf(", "(")),
    "no recurrent product": (("dot4(", "skip4("),),
    # no arming either: an mbarrier armed every step and never completed
    # overflows its transaction count
    "no exchange": (("mbar_wait(", "mbar_skip("),
                    ("mbar_expect_tx(", "mbar_skip("),
                    ("st_async4(", "st_skip4("), ("st_async(", "st_skip(")),
    "backward exchange as bulk copies": BULK,
}


def breakdown(torch, kernels, build, dev) -> dict:
    """Per-step time of each timing-only variant of both cluster kernels,
    loaded in place of the real build (the kernels size their shared
    memory themselves), at one and two sequences per cluster."""
    res = {}
    H, T = 512, 1440
    w = weights(torch, H, 51, dev)
    real = {n: build.load_library(n) for n in ("lstm_scan",
                                              "lstm_bwd_cluster")}
    inputs = {}
    for B in (4, 8):
        xp = gauss(torch, (B, T, 4 * H), 62, dev)
        dy = gauss(torch, (B, T, H), 65, dev)
        out, c_seq = kernels.lstm_scan(xp, w, save_c=True)
        pre = (xp + torch.cat([torch.zeros(B, 1, H, device=dev),
                               out[:, :-1]], 1) @ w.t()).contiguous()
        inputs[B] = (xp, dy, c_seq, pre)
    root = HERE / "encodec_tpu_torch" / "kernels" / "_build" / "probe"
    for label, subs in BREAKDOWN.items():
        d = root / ("breakdown_" + label.replace(" ", "_"))
        d.mkdir(parents=True, exist_ok=True)
        (d / "cluster.cuh").write_text((build.CSRC / "cluster.cuh").read_text())
        procs = {}
        for name in real:
            text = (build.CSRC / f"{name}.cu").read_text().replace(
                '#include "cluster.cuh"\n', '#include "cluster.cuh"\n' + STUBS)
            for a, b in subs:
                if subs is BULK and name != "lstm_bwd_cluster":
                    break
                assert subs is not BULK or text.count(a) == 1, a
                text = text.replace(a, b)
            (d / f"{name}.cu").write_text(text)
            procs[name] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / f"lib{name}.so"),
                 str(d / f"{name}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed for {label} {name}:\n{log}")
            build._LIBS[name] = build._finish(name, d / f"lib{name}.so", None,
                                              d / "unused")
        ms = {}
        for B, (xp, dy, c_seq, pre) in inputs.items():
            ms[f"fwd save B={B}"] = window_ms(
                torch, lambda: kernels.lstm_scan(xp, w, save_c=True), 10)
            ms[f"bwd B={B}"] = window_ms(
                torch, lambda: kernels.lstm_scan_backward(pre, c_seq, dy, w),
                10)
        print(f"breakdown {label} (H={H}, T={T}; B=4: one sequence per "
              "cluster, B=8: two): " + ", ".join(
                  f"{k} {v:.4f} ms ({v / T * 1e3:.3f} us/step)"
                  for k, v in ms.items()))
        res[label] = ms
    build._LIBS.update(real)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--breakdown", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_cluster: no CUDA device", file=sys.stderr)
        return 2
    from encodec_tpu_torch import kernels
    from encodec_tpu_torch.device import set_fp32_policy
    from encodec_tpu_torch.kernels import build, lstm_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    set_fp32_policy()
    rows = ptxas(build)
    build.build_all()
    dev = torch.device("cuda")
    print(f"max active clusters H=512: forward "
          f"{lstm_cuda.max_active_clusters(512, dev)}, backward "
          f"{lstm_cuda.max_bwd_clusters(512, dev)}")
    var = breakdown(torch, kernels, build, dev) if args.breakdown else {}
    n = checks(torch, kernels, dev)
    res = {} if args.quick else times(torch, kernels, dev)
    print(json.dumps({"k3_cluster": {"device": smi, "ptxas": rows,
                                     "checked_shapes": n, "ms": res,
                                     "breakdown": var}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
