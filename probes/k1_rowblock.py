#!/usr/bin/env python3
"""K1's two routes on the card: the row-block kernel against the cluster
split-bins kernel (csrc/vq_search.cu), bit for bit and in time.

    python3 probes/k1_rowblock.py [--ptxas] [--variants SPEC;SPEC...]
                                  [--quick] [--k2] [--clock] [--loads]
                                  [--out DIR]

For each shape (the configs' training searches at D=256, the crossover
where `nearest_plan` switches route at D=128 and D=256, and the main
path's D=128 shapes): both routes on the same seeded inputs, their
indices, margins and scores compared with `torch.equal`, and the indices
against the plain twin outside the 1e-3 tie guard; then device ms by CUDA
events (back-to-back launches, L2 warm, in turns: row-block, cluster,
cluster, row-block, `cdist`+`argmin` twice) beside the FP32 bound; at the
training shapes also the row-block kernel with each cluster size the
route can take (1, 2, 4).

`--ptxas` compiles `vq_search.cu` once more with `-Xptxas -v` and prints
what ptxas reports for each kernel (registers, spills). `--variants`
builds copies of the source with constants of the row-block kernel
replaced (`name:R_STAGES=3,R_MIN_BLOCKS=2;...`, any `constexpr int R_*`),
each with its own nvcc, all started together, and times each at the
training shapes beside the source's own, in turns, with the cluster size
`nearest_plan` gives. `--loads` adds two timing-only variants whose
results are wrong by design: every thread reads 4 of its 8 bins' slab
columns (each twice), and also 4 of its 8 rows', halving the shared loads
per FFMA, to show how far shared-memory loads bound the kernel. `--quick`
times only the training shapes. `--k2`
also times K2 (`rvq_encode_fused`, which keeps the cluster search) at the
configs' eval encodes (one shared book at D=256: N=115,200 and 23,040
with 10 stages of 512 bins, N=23,040 with 8 of 256) beside its plain
twin, `cdist`+`argmin` per stage, the K1 chain (`rvq_encode_margins`,
now on the row-block route) and the bound, after holding its codes equal
to the chain's. `--clock` runs the row-block kernel at N=115,200 / 512
bins back to back for about 3 s while `nvidia-smi` samples the SM clock
and the power draw, and prints the kernel's share of the FP32 peak at the
published 1.98 GHz and at the clock sampled. Prints
one line per measurement and, last, a JSON line `{"k1_rowblock": ...}`
with the card's name and power limit; with `--out DIR` every number also
goes to `DIR/k1_rowblock.json`. Variants build in a temporary directory.

Imports no JAX. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PEAK_FP32_FLOPS = 67e12
TRAINING = [(15_360, 1024), (23_040, 512), (115_200, 512), (23_040, 256)]
# (N, bins, D): the crossovers (first N on the row-block route) and the
# main path's K1 shapes, which stay on the cluster route
OTHERS = [(4_225, 1024, 128), (2_113, 1024, 256), (750, 1024, 128),
          (1_500, 1024, 128), (3_000, 1024, 128)]
# bit checks only: ragged rows, bins and D (the 4-byte copy path)
EDGES = [(1_000, 1000, 256), (5_001, 1000, 128), (20_001, 1000, 250),
         (9_999, 65, 256), (2_113, 7, 30)]


def inputs(torch, N, bins, D, seed, dev):
    rng = np.random.RandomState(seed)
    bound = float(np.sqrt(3.0) * np.sqrt(2.0 / D))
    e = torch.from_numpy(rng.uniform(-bound, bound, (bins, D))
                         .astype(np.float32)).to(dev)
    x = torch.from_numpy((rng.randn(N, D) * 0.3).astype(np.float32)).to(dev)
    return x, e


def events_ms(torch, fn, target_ms: float = 40.0) -> float:
    """Mean device ms per call over back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = max(5, min(400, int(target_ms / max(start.elapsed_time(end),
                                                1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launch(torch, lib, x, e, cluster, per_cta, entry="vq_rowblock_launch"):
    from encodec_tpu_torch.kernels import build

    N, D = x.shape
    idx = torch.empty(N, dtype=torch.int32, device=x.device)
    margin = torch.empty(N, dtype=torch.float32, device=x.device)
    score = torch.empty(N, dtype=torch.float32, device=x.device)
    rc = getattr(lib, entry)(
        x.data_ptr(), e.data_ptr(), N, e.shape[0], D, cluster, per_cta,
        idx.data_ptr(), margin.data_ptr(), score.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    build.check(lib, "vq_search", rc)
    return idx, margin, score


def ptxas_report() -> list:
    from encodec_tpu_torch.kernels import build

    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "lib.so"), str(build.CSRC / "vq_search.cu")],
            capture_output=True, text=True, timeout=600)
    lines = [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
             if "ptxas" in ln]
    return lines


E_LOAD = "*reinterpret_cast<const float4*>(eb + q * R_BG * R_LD + kk);"
X_LOAD = ("xv[i] = *reinterpret_cast<const float4*>(xb + i * R_RG * R_LD + "
          "kk);")


def variant_sources(specs: list, loads: bool) -> dict:
    """{name: source}: copies of vq_search.cu with R_* constants replaced
    (`name:R_STAGES=3,...`), and with `loads` the half-load variants."""
    from encodec_tpu_torch.kernels import build

    src = (build.CSRC / "vq_search.cu").read_text()
    out = {}
    for spec in filter(None, specs):
        name, _, subs = spec.partition(":")
        text = src
        for sub in filter(None, subs.split(",")):
            key, _, val = sub.partition("=")
            text, n = re.subn(rf"constexpr int {key} = [^;]+;",
                              f"constexpr int {key} = {val};", text)
            if n != 1:
                raise SystemExit(f"variant {name}: no constant {key}")
        out[name] = text
    if loads:
        half_e = src.replace(E_LOAD, E_LOAD.replace("q * R_BG", "(q & 3) * "
                                                    "R_BG"))
        out["half_e_loads"] = half_e
        out["half_x_and_e_loads"] = half_e.replace(
            X_LOAD, X_LOAD.replace("i * R_RG", "(i & 3) * R_RG"))
        if src in (half_e, out["half_x_and_e_loads"]):
            raise SystemExit("the load lines of vq_search.cu moved")
    return out


def build_variants(sources: dict, outdir: Path) -> dict:
    """{name: loaded library}, one nvcc per source, all started together."""
    from encodec_tpu_torch.kernels import build

    procs = {}
    for name, text in sources.items():
        d = outdir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "vq_search.cu").write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(d / "libvq_search.so"), str(d / "vq_search.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        rows = [ln.strip() for ln in log.splitlines()
                if "ptxas" in ln and ("rowblock" in ln or "registers" in ln)]
        print(f"variant {name}: nvcc rc={proc.returncode}; "
              + " | ".join(rows[-6:]))
        if proc.returncode != 0:
            print(log[-3000:])
            continue
        lib = ctypes.CDLL(str(d / "libvq_search.so"))
        for fn, (argtypes, restype) in build.SIGNATURES["vq_search"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def attributes(lib) -> tuple:
    b, r, loc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.vq_rowblock_attributes(ctypes.byref(b), ctypes.byref(r),
                                    ctypes.byref(loc))
    return (b.value, r.value, loc.value) if rc == 0 else None


def sustained_clock(torch, lib, dev) -> dict:
    """SM clock and power while the row-block kernel runs for ~3 s."""
    import time

    from encodec_tpu_torch.kernels import vq_cuda

    N, bins, D = 115_200, 512, 256
    x, e = inputs(torch, N, bins, D, 1, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = vq_cuda.nearest_plan(N, bins, D, sms)
    ms = events_ms(torch, lambda: launch(torch, lib, x, e, plan.cluster,
                                         plan.bins_per_cta))
    iters = int(3000 / ms)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.5)
        for _ in range(iters):
            launch(torch, lib, x, e, plan.cluster, plan.bins_per_cta)
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    rows = [tuple(float(v) for v in ln.split(",")) for ln in
            out.strip().splitlines() if ln.strip()]
    busy = [r for r in rows if r[1] > 200.0] or rows
    mhz = sorted(r[0] for r in busy)[len(busy) // 2]
    watts = sorted(r[1] for r in busy)[len(busy) // 2]
    flops = 2.0 * N * bins * D / (ms * 1e-3)
    at_mhz = sms * 128 * 2 * mhz * 1e6  # 128 FP32 lanes per SM
    rec = dict(ms=ms, median_sm_mhz=mhz, median_watts=watts,
               samples=len(rows), share_of_67_tflops=flops / PEAK_FP32_FLOPS,
               share_at_sampled_clock=flops / at_mhz)
    print(f"clock: row-block N={N} bins={bins}: {ms:.4f} ms, "
          f"{flops / 1e12:.1f} TFLOP/s = {rec['share_of_67_tflops']:.3f} of "
          f"67 TFLOP/s; SM clock median {mhz:.0f} MHz, power "
          f"{watts:.0f} W over {len(busy)} busy samples of {len(rows)}: "
          f"{rec['share_at_sampled_clock']:.3f} of the FP32 rate at that "
          "clock")
    return rec


K2_SHAPES = [(115_200, 512, 10), (23_040, 512, 10), (23_040, 256, 8)]


def k2_rows(torch, dev) -> list:
    from encodec_tpu_torch.kernels import (rvq_encode_fused,
                                           rvq_encode_fused_plain, vq_cuda)
    from encodec_tpu_torch.quant.rvq import (RVQConfig, RVQState,
                                             rvq_encode_margins)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for k, (N, bins, n_q) in enumerate(K2_SHAPES):
        D = 256
        x, book = inputs(torch, N, bins, D, 200 + k, dev)
        e = book[None].contiguous()
        cfg = RVQConfig(dimension=D, n_q=n_q, bins=bins, shared_codebook=True)
        state = RVQState(embed=e, embed_avg=e, cluster_size=e[..., 0],
                         inited=True)

        def chain():
            return rvq_encode_margins(state, x[None], cfg, n_q)[0]

        def per_stage_library():
            r = x
            for _ in range(n_q):
                r = r - book[torch.cdist(r, book).argmin(1)]

        codes = rvq_encode_fused(x, e, n_q, True)
        equal = bool(torch.equal(codes, chain().reshape(n_q, N)))
        t = [events_ms(torch, f) for f in (
            lambda: rvq_encode_fused(x, e, n_q, True), chain,
            per_stage_library,
            lambda: rvq_encode_fused_plain(x, e, n_q, True))]
        plan = vq_cuda.rvq_plan(N, bins, D, sms)
        bound = 2.0 * N * n_q * bins * D / PEAK_FP32_FLOPS * 1e3
        row = dict(N=N, bins=bins, n_q=n_q, codes_equal_chain=equal,
                   k2_ms=t[0], k1_chain_ms=t[1], library_per_stage_ms=t[2],
                   plain_ms=t[3], bound_ms=bound,
                   plan=(plan.row_tiles, plan.cluster, plan.smem_bytes))
        out.append(row)
        print(f"K2 N={N} D={D} bins={bins} n_q={n_q} (shared book): codes "
              f"equal the K1 chain {equal}; plan {plan.row_tiles} tiles x "
              f"cluster {plan.cluster}, {plan.smem_bytes} B/CTA; device ms "
              f"(events): K2 {t[0]:.4f}, K1 chain (row-block route, f32 "
              f"update) {t[1]:.4f}, cdist+argmin per stage {t[2]:.4f}, "
              f"plain {t[3]:.4f}, bound {bound:.5f} (operations)")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--variants", default="")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--k2", action="store_true")
    ap.add_argument("--clock", action="store_true")
    ap.add_argument("--loads", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch

    from encodec_tpu_torch.device import set_fp32_policy
    from encodec_tpu_torch.kernels import build, vq_cuda
    from encodec_tpu_torch.kernels import nearest_codebook_plain

    if not torch.cuda.is_available():
        print("k1_rowblock: needs a CUDA device", file=sys.stderr)
        return 2
    set_fp32_policy()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = build.load_library("vq_search")
    record = {"card": smi, "sms": sms, "attributes": attributes(lib),
              "resident_clusters": {c: lib.vq_rowblock_resident(c)
                                    for c in (1, 2, 3, 4, 8)}}
    print(f"row-block kernel: (CTAs per SM, registers, local bytes) = "
          f"{record['attributes']}; shared memory "
          f"{lib.vq_rowblock_smem_bytes()} B; resident clusters by size "
          f"{record['resident_clusters']}")
    if args.ptxas:
        record["ptxas"] = ptxas_report()
        for ln in record["ptxas"]:
            print(ln)

    # -- bits: the row-block route against the cluster route --------------
    checks = []
    shapes = [(N, b, 256) for N, b in TRAINING] + OTHERS + EDGES
    for k, (N, bins, D) in enumerate(shapes):
        x, e = inputs(torch, N, bins, D, 100 + k, dev)
        rb = vq_cuda._rowblock_plan(N, bins, sms)
        cl = vq_cuda._split_plan("K1", N, bins, D, sms,
                                 vq_cuda.nearest_smem_bytes(D))
        a = launch(torch, lib, x, e, rb.cluster, rb.bins_per_cta)
        b = launch(torch, lib, x, e, cl.cluster, cl.bins_per_cta,
                   "vq_nearest_launch")
        ref_idx, ref_margin = nearest_codebook_plain(x, e)
        torch.cuda.synchronize()
        same = [bool(torch.equal(u, v)) for u, v in zip(a, b)]
        safe = ref_margin >= 1e-3
        off = int((a[0][safe] != ref_idx[safe]).sum())
        checks.append(dict(N=N, bins=bins, D=D, rowblock_cluster=rb.cluster,
                           equal_idx_margin_score=same, off_twin=off))
        print(f"bits N={N} bins={bins} D={D}: row-block (C={rb.cluster}) vs "
              f"cluster (C={cl.cluster}) idx/margin/score equal {same}; "
              f"idx off the twin outside the tie guard: {off}")
    record["checks"] = checks
    ok = all(all(c["equal_idx_margin_score"]) and c["off_twin"] == 0
             for c in checks)

    # -- duplicates in different bin tiles and CTAs ------------------------
    N, bins, D = 23_040, 512, 256
    x, e = inputs(torch, N, bins, D, 7, dev)
    dups = (400, 3, 130, 260)
    for j in dups[1:]:
        e[j] = e[dups[0]]
    gen = torch.Generator(device="cpu").manual_seed(8)
    xd = (e[dups[0]][None] + 1e-3 * torch.randn(N, D, generator=gen)
          .to(dev)).contiguous()
    rb = vq_cuda.nearest_plan(N, bins, D, sms)
    d_idx, d_margin, _ = launch(torch, lib, xd, e, rb.cluster,
                                rb.bins_per_cta)
    torch.cuda.synchronize()
    dup_ok = bool((d_idx == min(dups)).all()) and bool((d_margin == 0).all())
    print(f"duplicates {dups} at N={N} bins={bins} (C={rb.cluster}): lowest "
          f"index with margin 0: {dup_ok}")
    ok = ok and dup_ok

    # -- time --------------------------------------------------------------
    times = []
    timed = [(N, b, 256) for N, b in TRAINING]
    if not args.quick:
        timed += OTHERS
    for N, bins, D in timed:
        x, e = inputs(torch, N, bins, D, 1, dev)
        rb = vq_cuda._rowblock_plan(N, bins, sms)
        cl = vq_cuda._split_plan("K1", N, bins, D, sms,
                                 vq_cuda.nearest_smem_bytes(D))

        def run_rb(c=rb.cluster, p=rb.bins_per_cta):
            launch(torch, lib, x, e, c, p)

        def run_cl():
            launch(torch, lib, x, e, cl.cluster, cl.bins_per_cta,
                   "vq_nearest_launch")

        def run_lib():
            torch.cdist(x, e).argmin(1)

        t = [events_ms(torch, f) for f in (run_rb, run_cl, run_cl, run_rb,
                                           run_lib, run_lib)]
        bound = 2.0 * N * bins * D / PEAK_FP32_FLOPS * 1e3
        row = dict(N=N, bins=bins, D=D, route=vq_cuda.nearest_plan(
            N, bins, D, sms).route, rowblock_cluster=rb.cluster,
            rowblock_ms=[t[0], t[3]], cluster_ms=[t[1], t[2]],
            library_ms=[t[4], t[5]], bound_ms=bound)
        if (N, bins) in TRAINING and D == 256:
            sweep = {}
            for c in (1, 2, 4):
                per = -(-bins // c)
                if c * 128 <= max(bins, 128) and (c - 1) * per < bins:
                    sweep[c] = events_ms(torch, lambda c=c, per=per:
                                         run_rb(c, per))
            row["rowblock_ms_by_cluster"] = sweep
        times.append(row)
        print(f"time N={N} bins={bins} D={D} ({row['route']} route): "
              f"row-block C={rb.cluster} {t[0]:.4f}/{t[3]:.4f} ms, cluster "
              f"C={cl.cluster} {t[1]:.4f}/{t[2]:.4f}, cdist+argmin "
              f"{t[4]:.4f}/{t[5]:.4f}, bound {bound:.5f} (operations)"
              + (f"; row-block by C {row['rowblock_ms_by_cluster']}"
                 if "rowblock_ms_by_cluster" in row else ""))
    record["times"] = times

    # -- compile-time variants --------------------------------------------
    if args.variants or args.loads:
        libs = {"source": lib}
        with tempfile.TemporaryDirectory(prefix="k1_variants_") as tmp:
            # loaded libraries stay mapped once their files are gone
            libs.update(build_variants(variant_sources(
                args.variants.split(";"), args.loads), Path(tmp)))
        var = []
        for N, bins in TRAINING:
            x, e = inputs(torch, N, bins, 256, 1, dev)
            rb = vq_cuda._rowblock_plan(N, bins, sms)
            ref = launch(torch, lib, x, e, rb.cluster, rb.bins_per_cta)
            names = list(libs) + list(reversed(list(libs)))
            got = {n: [] for n in libs}
            for n in names:
                got[n].append(events_ms(torch, lambda n=n: launch(
                    torch, libs[n], x, e, rb.cluster, rb.bins_per_cta)))
            same = {n: all(bool(torch.equal(u, v)) for u, v in zip(
                launch(torch, libs[n], x, e, rb.cluster, rb.bins_per_cta),
                ref)) for n in libs}
            attrs = {n: attributes(libs[n]) for n in libs}
            var.append(dict(N=N, bins=bins, ms=got, equal=same, attrs=attrs))
            print(f"variants N={N} bins={bins} C={rb.cluster}: "
                  + "; ".join(f"{n} {v[0]:.4f}/{v[1]:.4f} ms (equal "
                              f"{same[n]}, attrs {attrs[n]})"
                              for n, v in got.items()))
        record["variants"] = var

    if args.clock:
        record["clock"] = sustained_clock(torch, lib, dev)
    if args.k2:
        record["k2"] = k2_rows(torch, dev)
        ok = ok and all(r["codes_equal_chain"] for r in record["k2"])

    record["ok"] = ok
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "k1_rowblock.json").write_text(json.dumps(record,
                                                             indent=1))
    print(json.dumps({"k1_rowblock": {"ok": ok, "card": smi}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
