#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero before the last line):

1. identify the card (name, power limit);
2. build every hand-written kernel from `encodec_tpu_torch/kernels/csrc`
   (one nvcc per source, in parallel);
3. hold each kernel against its plain PyTorch twin on the card at the
   24 kHz and 48 kHz main-path shapes (K1 at N=750, 1500 and 3000 rows,
   including exact duplicate rows in different CTAs' bin ranges; K2 at
   N=750 and 3000 for 8 and 32 stages and a shared book and at N=1500 for
   16 stages, with its plan, and equal to the K1 chain at every position;
   K3 over two layers at B=1 and B=4, T=750, and at B=10, T=150 and B=1,
   T=15, with its cluster plan), and time kernel, twin, one PyTorch library
   call computing the same function (a yardstick the port never calls) as
   device time under torch.profiler, beside the card's bound for the same
   work, and the wrappers' per-call time (CUDA events);
4. drive the 24 kHz main path as a server answering four requests (1, 3,
   5.3 and 10 s of seeded audio) on the full-width 24 kHz model with seeded
   random weights (`kmeans_init=False`, so the books are not all zero):
   encode at 6 and 24 kbps, decode, and a raw `.ecdc` compress → decompress
   roundtrip; launch counts are zeroed before and read after, and every
   kernel of the path must have launched; the outputs are checked, and the
   codes are held against the plain twins' codes on the card;
5. profile one 10 s request (torch.profiler): device time by kernel group
   and the device's idle share, and K2 in that request beside K2 alone on
   the request's latents with the L2 cache warm and flushed;
6. drive the 48 kHz stereo path the same way on the full-width 48 kHz
   model (1, 5.3 and 10 s requests and one of 95,100 samples, whose last
   two segments are both short), with its own launch counts; check the
   segment layout, audio shapes, that each `.ecdc` holds the writer's codes
   and, bit for bit, its scales, and the codes against the plain twins';
7. profile one 10 s 48 kHz request at 24 kbps by kernel group, and run
   the CLI's `-q -b 24` compression and its decompression on the card;
8. K3 from a carried state at a streamed chunk's shapes (B=1, T=6 and 7)
   and at B=10, T=150, against its twin and cuDNN's LSTM from the same
   state, and one launch over T steps against a carried 7 + 6 + ... split
   (bit-equal);
9. stream the 24 kHz model (`StreamingCodec`) as a live service would: a
   10 s + 100-sample request in a 7-hop first chunk, 6-hop (80 ms) chunks
   and an `encode_finish` tail, each chunk's codes decoded as they arrive,
   at 6 and 24 kbps, then the fixed-chunk extractor on 30 s signals, with
   their own launch counts; streamed codes against the offline encode
   outside tie-flagged positions, streamed audio against the offline decode
   of the same codes, per-chunk latency, and one profiled chunk;
10. K3's grid kernel at H=1024 (the breathing model's LSTM): its plan
   (CTAs, units, shared memory, registers and spill); B=1 and 32 with
   T=480 and B=1 with T=64, each from zero state and from a carried state,
   against its twin and cuDNN's LSTM, with the bound; one launch against a
   carried 64 + 64 + ... split, bit for bit;
11. serve the breathing tokenizer (`breathing_model`, full width) with its
   own launch counts: two 4 h nights encoded and decoded, 32 nights of 4 h
   through `encode` (the training batch), and `process_dataset` over a
   `BreathingDataset` of three synthetic nights (4 h, 6 h + 17 samples and
   8 h) offline and in 64-hop stream chunks; codes against the plain twins
   outside tie-flagged positions, audio within 1e-3 of the plain decode,
   streamed extraction codes equal to the offline ones, seconds per hour of
   signal, and a profile of one night (device busy, idle share, K3's
   share);
12. `params/hires_tokens.yaml`'s model (H=256, T=14,400 steps per 4 h
   night) from a config dict: one night, K3 ms per layer;
13. LM entropy coding (lmv=3) with its own launch counts: the integer LMs
   at the published widths (seeded random weights) code the 10 s 24 kHz
   request at 6 and 24 kbps in 375-token blocks and at 6 kbps unblocked,
   and the 10 s 48 kHz request at 24 kbps (11 segments), compressed and
   decompressed on the card with the native range coder; decoded codes
   against the written ones and the `cc` CRC, audio against the raw path's
   decode, each file against the one the port's CPU LM writes, CUDA CDF
   rows against the CPU's; teacher-forced encode and decode times, a
   profiled decode step (launches) and 8 profiled decode steps (idle
   share), bytes against the raw file;
14. print the `kernels` JSON line (launches per path, the grid kernel in a
   row of its own), then the final `ok` JSON line.

Imports no JAX. Exits non-zero without printing a result when no CUDA
device is present or the port's package is not next to this script.
"""

from __future__ import annotations

import importlib
import io
import json
import math
import struct
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

TIE_THRESHOLD = 1e-3    # the container writer's near-tie guard


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound(flops: float, nbytes: float) -> tuple:
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(torch, fn, iters: int) -> float:
    """Mean time per call of `fn` over `iters` back-to-back calls (CUDA
    events): device time, or the host's cost of a call where that is
    larger."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The port's kernels by name, and the launch counter that counts each
OWN_KERNELS = {"vq_nearest_kernel": "nearest_codebook",
               "vq_rvq_kernel": "rvq_encode_fused",
               "lstm_scan_kernel": "lstm_cluster",
               "lstm_grid_kernel": "lstm_grid"}
PROFILE_WINDOWS = 20     # windows tried before a measurement fails
PROFILE_EDGE_S = 0.05    # host time between a window's edges and its work
PROFILE_AGREE = 0.05     # two windows agree within this device time
profiler_stats = {"windows": 0, "short": 0, "restored": 0, "unmatched": 0,
                  "longer_than_span": 0}


def own_launches() -> dict:
    """Launches so far of each of the port's kernels, by kernel name."""
    from encodec_tpu_torch import kernels

    c = launch_counts(kernels)
    c["lstm_cluster"] = c["lstm_scan"] - c["lstm_grid"]
    return {name: c[counter] for name, counter in OWN_KERNELS.items()}


def kernel_window(torch, fn, iters: int, kernel: str = "") -> tuple:
    """Device records of `iters` back-to-back calls of `fn` under
    torch.profiler: {kernel name: (launches, device µs)} for the CUDA
    kernels whose name contains `kernel`, and the calls' wall ms.

    Profiler windows on the H100 machine have come back wrong in three
    ways: short of records (in some processes every window of ten K3
    launches kept nine; late in a long process the first K3 of a window
    of three 18.6 ms launches is often dropped, or all three), with no
    record of a kernel, and with records longer than the calls took. So
    each window profiles one discarded warm-up call and waits
    `PROFILE_EDGE_S` before its calls and after them. Its launches are
    counted, not taken from the records: each of the port's kernels
    launches `iters` times what its counter gives one call, any other
    kernel a multiple of `iters`. A window that kept fewer records (at most
    `iters` - 1 fewer of a kernel) is scaled up at its records' mean time
    and counted in `profiler_stats`. CUDA events on the stream span the
    calls: the port's kernels run one after another on that stream, so a
    window of only the port's kernels whose device time exceeds that span
    (by more than 1% and 5 µs) is refused. A window is used once an
    earlier window had the same launches and a device time within
    `PROFILE_AGREE`. Fails after `PROFILE_WINDOWS` windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    before = own_launches()
    fn()
    torch.cuda.synchronize()
    per_call = {k: n - before[k] for k, n in own_launches().items()}
    seen = []
    for _ in range(PROFILE_WINDOWS):
        traces = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with warnings.catch_warnings():
            # each profiled window is its own cycle; the notice says only that
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=lambda p: traces.append(
                             p.key_averages())) as prof:
                fn()
                torch.cuda.synchronize()
                prof.step()
                time.sleep(PROFILE_EDGE_S)
                t0 = time.perf_counter()
                start.record()
                for _ in range(iters):
                    fn()
                end.record()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                time.sleep(PROFILE_EDGE_S)
                prof.step()
        profiler_stats["windows"] += 1
        records = {}
        for e in (traces[0] if traces else ()):
            if (getattr(e, "device_type", None) == DeviceType.CUDA
                    and kernel in e.key):
                n, us = records.get(e.key, (0, 0.0))
                records[e.key] = (n + e.count, us + e.self_device_time_total)
        # kept records per kernel (the port's by name, template instances
        # together) against the launches made
        kept = {}
        for key, (n, _) in records.items():
            g = next((name for name in OWN_KERNELS if name in key), key)
            kept[g] = kept.get(g, 0) + n
        made = {g: iters * per_call[g] if g in OWN_KERNELS
                else -(-n // iters) * iters for g, n in kept.items()}
        missing = [name for name in OWN_KERNELS
                   if kernel in name and per_call[name] and name not in kept]
        if (not kept or missing
                or any(not made[g] - iters < n <= made[g]
                       for g, n in kept.items())):
            profiler_stats["unmatched"] += 1
            continue
        lost = sum(made[g] - n for g, n in kept.items())
        if lost:
            profiler_stats["short"] += 1
            profiler_stats["restored"] += lost
        scaled = {}
        for key, (n, us) in records.items():
            g = next((name for name in OWN_KERNELS if name in key), key)
            f = made[g] / kept[g]
            scaled[key] = (n * f, us * f)
        busy = sum(us for _, us in scaled.values())
        span_us = start.elapsed_time(end) * 1e3
        if (all(g in OWN_KERNELS for g in kept)
                and busy > span_us * 1.01 + 5.0):
            profiler_stats["longer_than_span"] += 1
            continue
        if any(m == made and abs(b - busy) <= PROFILE_AGREE * max(b, busy)
               for m, b, _ in seen):
            return scaled, wall_ms
        if seen:
            profiler_stats["unmatched"] += 1
        seen.append((made, busy, span_us))
    fail(f"torch.profiler gave no two windows that agree in "
         f"{PROFILE_WINDOWS} ({'kernels ' + kernel if kernel else 'all kernels'}"
         f"; {iters} calls; device us (CUDA-event span) of the usable "
         f"windows: {[(round(b, 1), round(s, 1)) for _, b, s in seen]}; "
         f"{profiler_stats['longer_than_span']} windows longer than their "
         f"span in this run)")


def device_ms(torch, fn, iters: int, kernel: str = "") -> float:
    """Mean device time per call of `fn`: the CUDA kernels' own time under
    torch.profiler over `iters` calls of a whole window (`kernel_window`;
    no host time, no gaps); with `kernel`, only the kernels whose name
    contains it."""
    records, _ = kernel_window(torch, fn, iters, kernel)
    return sum(us for _, us in records.values()) / iters / 1e3


def plain_stage_margins(torch, kernels, x, embed, n_q, shared):
    """Per-stage codes and margins of the plain RVQ chain, [n_q, N] each."""
    residual, codes, margins = x, [], []
    for k in range(n_q):
        book = embed[0 if shared else k]
        idx, m = kernels.nearest_codebook_plain(residual, book)
        codes.append(idx)
        margins.append(m)
        residual = residual - book[idx.long()]
    return torch.stack(codes), torch.stack(margins)


def books(torch, shape, seed, dev):
    bound_ = math.sqrt(3.0) * math.sqrt(2.0 / shape[-1])
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.uniform(-bound_, bound_, shape)
                            .astype(np.float32)).to(dev)


def gauss(torch, shape, seed, dev, scale):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(*shape) * scale)
                            .astype(np.float32)).to(dev)


def phase_k1(torch, kernels, dev):
    """K1 at N=750 (one RVQ stage of a 10 s 24 kHz request, the main path's
    shape), N=1500 (a 10 s 48 kHz request: 10 segments of 150 frames) and
    N=3000; the JSON row is N=750."""
    from encodec_tpu_torch.kernels import vq_cuda

    D, bins = 128, 1024
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    e = books(torch, (bins, D), 11, dev)
    # exact duplicates of the nearest row in three CTAs' bin ranges
    dups = (900, 5, 700)
    e_dup = e.clone()
    for j in dups[1:]:
        e_dup[j] = e_dup[dups[0]]
    rows = {}
    for N in (750, 1500, 4 * 750):
        plan = vq_cuda.nearest_plan(N, bins, D, sms)
        x = gauss(torch, (N, D), 10, dev, 0.3)
        idx, margin = kernels.nearest_codebook(x, e)
        ref_idx, ref_margin = kernels.nearest_codebook_plain(x, e)
        xd = (e_dup[dups[0]][None] + gauss(torch, (N, D), 12, dev, 1e-3))
        d_idx, d_margin = kernels.nearest_codebook(xd.contiguous(), e_dup)
        torch.cuda.synchronize()
        safe = ref_margin >= 1e-5
        n_bad = int((idx[safe] != ref_idx[safe]).sum())
        err = float((margin - ref_margin).abs().max())
        check(n_bad == 0, f"K1 N={N}: {n_bad} indices differ at plain "
                          "margin >= 1e-5")
        check(err <= 1e-4, f"K1 N={N}: margin max|d| {err} > 1e-4")
        check(bool((d_idx == min(dups)).all()) and bool((d_margin == 0).all()),
              f"K1 N={N}: duplicate rows across CTAs do not give the lowest "
              "index with margin 0")
        ms = device_ms(torch, lambda: kernels.nearest_codebook(x, e), 50)
        call_ms = time_ms(torch, lambda: kernels.nearest_codebook(x, e), 50)
        plain_ms = device_ms(
            torch, lambda: kernels.nearest_codebook_plain(x, e), 20)
        lib_ms = device_ms(torch, lambda: torch.cdist(x, e).argmin(1), 20)
        b_ms, b_by = bound(2.0 * N * bins * D, (N * D + bins * D + 2 * N) * 4)
        print(f"K1 nearest_codebook N={N} D={D} bins={bins}: plan "
              f"{plan.row_tiles} tiles x cluster {plan.cluster} = {plan.ctas} "
              f"CTAs, {plan.bins_per_cta} bins/CTA; idx equal (margin>=1e-5), "
              f"margin max|d|={err:.3g}, duplicates {dups} -> {min(dups)}, "
              f"margin 0; device ms: kernel={ms:.4f} plain={plain_ms:.4f} "
              f"library(cdist+argmin)={lib_ms:.4f} bound={b_ms:.5f} ({b_by}); "
              f"per wrapper call (events)={call_ms:.4f}")
        rows[N] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    return rows[750]


def k1_chain(x, e, n_q, shared):
    """`rvq_encode_margins` of the port (K1 per stage, f32 torch update):
    the codes K2 must equal bit for bit, [n_q, N]."""
    from encodec_tpu_torch.quant.rvq import (RVQConfig, RVQState,
                                             rvq_encode_margins)

    cfg = RVQConfig(dimension=x.shape[1], n_q=n_q, bins=e.shape[1],
                    shared_codebook=shared)
    state = RVQState(embed=e, embed_avg=e, cluster_size=e[..., 0],
                     inited=True)
    codes, _ = rvq_encode_margins(state, x[None], cfg, n_q)
    return codes.reshape(n_q, x.shape[0])


K2_CASES = {750: ((8, False), (32, False), (8, True)),
            1500: ((16, False),),
            3000: ((8, False), (32, False), (8, True)),
            7: ((8, False), (32, False)),    # a stream's first chunk
            6: ((8, False), (32, False))}    # and each 80 ms chunk after it


def phase_k2(torch, kernels, dev):
    """K2 at N=750 (every stage of a 10 s 24 kHz request, the main path's
    shape) and N=3000 (a 40 s request, or 4 x 10 s), n_q = 8, 32, and 8
    with one shared book, at N=1500, n_q=16 (a 10 s 48 kHz request at
    24 kbps), and at N=7 and 6 (a streamed chunk's frames) for n_q 8 and
    32; the JSON row is N=750, n_q=32."""
    from encodec_tpu_torch.kernels import vq_cuda

    D, bins = 128, 1024
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for N, cases in K2_CASES.items():
        plan = vq_cuda.rvq_plan(N, bins, D, sms)
        print(f"K2 plan N={N} D={D} bins={bins}: {plan.row_tiles} tiles x "
              f"cluster {plan.cluster} = {plan.ctas} CTAs, "
              f"{plan.bins_per_cta} bins/CTA, {plan.smem_bytes} B shared "
              "memory/CTA")
        x = gauss(torch, (N, D), 20, dev, 0.3)
        for n_q, shared in cases:
            e = books(torch, (1 if shared else n_q, bins, D), 21 + n_q, dev)
            codes = kernels.rvq_encode_fused(x, e, n_q, shared)
            chain = k1_chain(x, e, n_q, shared)
            ref = kernels.rvq_encode_fused_plain(x, e, n_q, shared)
            torch.cuda.synchronize()
            n_chain = int((codes != chain).sum())
            check(n_chain == 0, f"K2 N={N} n_q={n_q} shared={shared}: "
                                f"{n_chain} codes differ from the K1 chain")
            _, margins = plain_stage_margins(torch, kernels, x, e, n_q, shared)
            diff = codes != ref
            first = torch.where(diff.any(0), diff.int().argmax(0), -1)
            n_diff = int((first >= 0).sum())
            n_bad = sum(1 for n, k in enumerate(first.tolist())
                        if k >= 0 and margins[k, n] >= 1e-4)
            check(n_bad == 0, f"K2 N={N} n_q={n_q} shared={shared}: {n_bad} "
                              "rows differ at plain margin >= 1e-4")
            # reconstruction difference between the two code sets
            stage = torch.arange(n_q, device=dev)[:, None] * (0 if shared else 1)
            err = float((e[stage, codes.long()].sum(0)
                         - e[stage, ref.long()].sum(0)).abs().max())
            ms = device_ms(
                torch, lambda: kernels.rvq_encode_fused(x, e, n_q, shared), 20)
            call_ms = time_ms(
                torch, lambda: kernels.rvq_encode_fused(x, e, n_q, shared), 20)
            plain_ms = device_ms(
                torch, lambda: kernels.rvq_encode_fused_plain(x, e, n_q, shared),
                5)

            def lib():
                r = x
                for k in range(n_q):
                    book = e[0 if shared else k]
                    i = torch.cdist(r, book).argmin(1)
                    r = r - book[i]
            lib_ms = device_ms(torch, lib, 5)
            n_books = 1 if shared else n_q
            b_ms, b_by = bound(2.0 * N * n_q * bins * D,
                               (N * D + n_books * bins * D + n_q * N) * 4)
            print(f"K2 rvq_encode_fused N={N} n_q={n_q} shared={shared}: "
                  f"codes equal the K1 chain at all {n_q * N} positions; vs "
                  f"plain: rows differing {n_diff} (all at plain margin < "
                  f"1e-4: {n_diff - n_bad}); device ms: kernel={ms:.4f} "
                  f"({ms / n_q * 1e3:.2f} us/stage) plain={plain_ms:.4f} "
                  f"library(cdist+argmin per stage)={lib_ms:.4f} "
                  f"bound={b_ms:.5f} ({b_by}); per wrapper call (events)="
                  f"{call_ms:.4f}")
            rows[N, n_q, shared] = dict(ms=ms, plain_ms=plain_ms,
                                        library_ms=lib_ms, bound_ms=b_ms,
                                        bound_by=b_by, max_abs_err=err)
    return rows[750, 32, False]


def k3_plan_line(torch, dev, H):
    import ctypes

    from encodec_tpu_torch.kernels import build, lstm_cuda

    lib = build.load_library("lstm_scan")
    n_max = lstm_cuda.max_active_clusters(H, dev)
    plan = lstm_cuda.lstm_plan(1, H, n_max)
    attrs = []
    for state in (0, 1):
        regs, local = ctypes.c_int(), ctypes.c_int()
        build.check(lib, "lstm_scan", lib.lstm_scan_attributes(
            H, state, ctypes.addressof(regs), ctypes.addressof(local)))
        attrs.append(f"{regs.value} registers/thread ({local.value} B local)")
    check(lib.lstm_scan_smem_bytes(H) == plan.smem_bytes,
          "K3 shared memory differs between the kernel and its plan")
    return (f"K3 plan H={H}: clusters of {plan.cluster} CTAs x "
            f"{plan.units_per_cta} units, max active clusters {n_max}, "
            f"{lstm_cuda.K3_THREADS} threads/CTA, zero state {attrs[0]}, "
            f"from a state {attrs[1]}, {plan.smem_bytes} B shared "
            f"memory/CTA; W_hh rows per CTA: {plan.reg_rows} in registers, "
            f"{plan.smem_rows} in shared memory")


def lstm_yardstick(torch, w_hh, dev):
    """cuDNN's LSTM computing K3's function: W_ih = I and zero biases, so
    its input projection is a [B·T, 4H] x [4H, 4H] GEMM of its own."""
    H = w_hh.shape[1]
    cudnn = torch.nn.LSTM(4 * H, H, batch_first=True).to(dev)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(torch.eye(4 * H, device=dev))
        cudnn.weight_hh_l0.copy_(w_hh)
        cudnn.bias_ih_l0.zero_()
        cudnn.bias_hh_l0.zero_()
    return cudnn


def phase_k3(torch, kernels, dev):
    """K3 per layer at H=512: T=750 (a 10 s 24 kHz request's LSTM) at the
    served batch B=1 and at B=4; B=10, T=150 (a 10 s 48 kHz request's ten
    full segments, one batch: more sequences than the card's K3 clusters,
    so some clusters run a second pass) and B=1, T=15 (its 0.1 s tail). The
    JSON row is B=1, T=750."""
    H = 512
    lim = 1.0 / math.sqrt(H)
    rng = np.random.RandomState(31)
    layers = [{k: torch.from_numpy(rng.uniform(-lim, lim, s).astype(np.float32)).to(dev)
               for k, s in (("w_ih", (4 * H, H)), ("w_hh", (4 * H, H)),
                            ("b", (4 * H,)))} for _ in range(2)]
    print(k3_plan_line(torch, dev, H))
    w_hh = layers[0]["w_hh"]
    cudnn = lstm_yardstick(torch, w_hh, dev)
    rows = {}
    for B, T in ((1, 750), (4, 750), (10, 150), (1, 15)):
        x = gauss(torch, (B, T, H), 30, dev, 0.5)

        def stack(scan):
            y = x
            for layer in layers:
                y = scan((y @ layer["w_ih"].t() + layer["b"]).contiguous(),
                         layer["w_hh"])
            return y

        got = stack(kernels.lstm_scan)
        ref = stack(kernels.lstm_scan_plain)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        # up to 750 recurrent steps sum in another order than cuBLAS
        check(err <= 1e-4, f"K3 B={B} T={T}: 2-layer max|d| {err} > 1e-4")
        xp = (x @ layers[0]["w_ih"].t() + layers[0]["b"]).contiguous()
        ms = device_ms(torch, lambda: kernels.lstm_scan(xp, w_hh), 10)
        plain_ms = device_ms(torch, lambda: kernels.lstm_scan_plain(xp, w_hh), 2)
        with torch.no_grad():
            lib_err = float((cudnn(xp)[0] - kernels.lstm_scan(xp, w_hh))
                            .abs().max())
            lib_ms = device_ms(torch, lambda: cudnn(xp), 10)
        b_ms, b_by = bound(2.0 * B * T * H * 4 * H,
                           (B * T * 4 * H + 4 * H * H + B * T * H) * 4)
        print(f"K3 lstm_scan B={B} T={T} H={H}: 2-layer max|d|={err:.3g} "
              f"(cuDNN vs kernel {lib_err:.3g}); per layer device ms: "
              f"kernel={ms:.4f} ({ms / T * 1e3:.3f} us/step) "
              f"plain={plain_ms:.4f} library(cuDNN LSTM)={lib_ms:.4f} "
              f"({lib_ms / T * 1e3:.3f} us/step) bound={b_ms:.5f} ({b_by})")
        rows[B, T] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    return rows[1, 750]


def phase_k3_state(torch, kernels, dev):
    """K3 from a carried (h0, c0) per layer at H=512: B=1, T=6 and T=7 (an
    80 ms chunk of a stream and its 7-hop first chunk) and B=10, T=150
    (distinct state rows; two waves of clusters), against the twin and
    cuDNN's LSTM from the same state; then one launch over T steps against
    launches over a 7 + 6 + ... split with the state carried, which must
    give the same bits."""
    H = 512
    lim = 1.0 / math.sqrt(H)
    rng = np.random.RandomState(41)
    w_hh = torch.from_numpy(rng.uniform(-lim, lim, (4 * H, H))
                            .astype(np.float32)).to(dev)
    cudnn = lstm_yardstick(torch, w_hh, dev)

    def inputs(B, T, seed):
        xp = gauss(torch, (B, T, 4 * H), seed, dev, 1.0)
        h0 = torch.tanh(gauss(torch, (B, H), seed + 1, dev, 1.0))
        c0 = gauss(torch, (B, H), seed + 2, dev, 1.0)
        return xp, h0, c0

    for B, T in ((1, 6), (1, 7), (10, 150)):
        xp, h0, c0 = inputs(B, T, 42)
        out, hT, cT = kernels.lstm_scan(xp, w_hh, h0, c0, return_state=True)
        ref, ref_h, ref_c = kernels.lstm_scan_plain(xp, w_hh, h0, c0,
                                                    return_state=True)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max())
                  for a, b in ((out, ref), (hT, ref_h), (cT, ref_c)))
        check(err <= 1e-4, f"K3 from state B={B} T={T}: max|d| {err} > 1e-4")
        ms = device_ms(torch, lambda: kernels.lstm_scan(
            xp, w_hh, h0, c0, return_state=True), 50)
        plain_ms = device_ms(torch, lambda: kernels.lstm_scan_plain(
            xp, w_hh, h0, c0, return_state=True), 5)
        with torch.no_grad():
            lib_out, _ = cudnn(xp, (h0[None], c0[None]))
            lib_err = float((lib_out - out).abs().max())
            lib_ms = device_ms(torch, lambda: cudnn(xp, (h0[None], c0[None])),
                               50)
        b_ms, b_by = bound(2.0 * B * T * H * 4 * H,
                           (B * T * 4 * H + 4 * H * H + 3 * B * H
                            + B * T * H) * 4)
        print(f"K3 lstm_scan from state B={B} T={T} H={H}: out/hT/cT max|d| "
              f"vs plain {err:.3g} (cuDNN vs kernel {lib_err:.3g}); per layer "
              f"device ms: kernel={ms:.4f} ({ms / T * 1e3:.3f} us/step) "
              f"plain={plain_ms:.4f} library(cuDNN LSTM from (h0, c0))="
              f"{lib_ms:.4f} bound={b_ms:.5f} ({b_by})")
    for B, T in ((1, 750), (10, 150)):
        xp, h0, c0 = inputs(B, T, 43)
        whole, hT, cT = kernels.lstm_scan(xp, w_hh, h0, c0, return_state=True)
        outs, h, c, t = [], h0, c0, 0
        while t < T:
            n = min(7 if t == 0 else 6, T - t)
            out, h, c = kernels.lstm_scan(xp[:, t:t + n].contiguous(), w_hh,
                                          h.contiguous(), c, return_state=True)
            outs.append(out)
            t += n
        torch.cuda.synchronize()
        check(torch.equal(torch.cat(outs, 1), whole) and torch.equal(h, hT)
              and torch.equal(c, cT),
              f"K3 B={B} T={T}: the carried 7 + 6 + ... split differs from "
              "one launch")
        print(f"K3 from state B={B} T={T}: one launch == {len(outs)} launches "
              "of 7, 6, ... steps with (h, c) carried, bit for bit (out, hT, "
              "cT)")


def request_audio(seconds: float, sr: int, seed: int) -> np.ndarray:
    """Seeded noise plus two tones, [1, T] float32."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(round(seconds * sr))) / sr
    wav = (0.05 * rng.randn(t.size) + 0.3 * np.sin(2 * np.pi * 440.0 * t)
           + 0.2 * np.sin(2 * np.pi * 1230.0 * t + rng.uniform(0, np.pi)))
    return np.clip(wav, -0.99, 0.99).astype(np.float32)[None]


def phase_main_path(torch, kernels, dev):
    from encodec_tpu_torch.models import encodec_model_24khz
    from encodec_tpu_torch.models.model import (encode_frame,
                                                encode_frame_margins)
    from encodec_tpu_torch.stream import binary, compress, decompress

    model = encodec_model_24khz(kmeans_init=False, device=dev)
    registry = {model.name: lambda pretrained=True: model}
    cfg = model.cfg
    check(cfg.seanet.n_filters == 32 and cfg.seanet.dimension == 128
          and cfg.rvq.bins == 1024 and cfg.rvq.n_q == 32,
          "not the full-width 24 kHz configuration")
    requests = [(s, request_audio(s, model.sample_rate, 100 + i))
                for i, s in enumerate((1.0, 3.0, 5.3, 10.0))]
    bandwidths = (6.0, 24.0)

    # -- the served path, counted: nothing but user calls in here -------
    kernels.reset_launch_counts()
    served = []
    for seconds, wav in requests:
        for bw in bandwidths:
            model.set_target_bandwidth(bw)
            t0 = time.perf_counter()
            frames = model.encode(wav[None])
            audio = model.decode(frames)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            data = compress(model, wav, models=registry)
            back, sr = decompress(data, models=registry)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            served.append(dict(seconds=seconds, wav=wav, bw=bw,
                               codes=frames[0][0], audio=audio, data=data,
                               back=back, sr=sr, n_q=model.n_q_active,
                               codec_s=t1 - t0, ecdc_s=t2 - t1))
    counts = launch_counts(kernels)
    print(f"main path launches: {json.dumps(counts)}")
    for name, n in counts.items():
        check(n > 0 or name == "lstm_grid",
              f"kernel {name} was never launched on the main path")

    # -- verification, not counted --------------------------------------
    total_diff = total_flagged = 0
    for r in served:
        T = r["wav"].shape[-1]
        frames_T = math.ceil(T / cfg.seanet.hop_length)
        codes = r["codes"]
        check(tuple(codes.shape) == (1, r["n_q"], frames_T),
              f"codes shape {tuple(codes.shape)}")
        check(bool(((codes >= 0) & (codes < cfg.rvq.bins)).all()),
              "codes out of range")
        audio = r["audio"]
        check(tuple(audio.shape) == (1, 1, frames_T * cfg.seanet.hop_length),
              f"audio shape {tuple(audio.shape)}")
        check(bool(torch.isfinite(audio).all()), "decoded audio not finite")
        check(tuple(r["back"].shape) == (1, T) and r["sr"] == model.sample_rate,
              f"decompressed shape {tuple(r['back'].shape)}")
        check(bool(torch.isfinite(r["back"]).all()), "decompressed not finite")
        # the bytes decode back to the writer's (tie-guarded) codes
        model.set_target_bandwidth(r["bw"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        guarded, stats = model.encode_guarded(r["wav"][None], TIE_THRESHOLD)
        t_guarded = time.perf_counter() - t0
        fo = io.BytesIO(r["data"])
        meta = binary.read_ecdc_header(fo)
        vals = binary.unpack_bits(fo.read(), model.bits_per_codebook,
                                  count=frames_T * meta["nc"])
        unpacked = vals.reshape(frames_T, meta["nc"]).T
        check(np.array_equal(unpacked, guarded[0][0][0].cpu().numpy()),
              "ecdc payload does not decode to the writer's codes")
        # kernel path vs plain twins on the card: equal except at
        # tie-guard-flagged positions
        x = torch.from_numpy(r["wav"][None]).to(dev).transpose(1, 2)
        # the writer's device part alone (encoder + K1 margins), to split
        # encode_guarded into device work and host float64 tie resolution
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            encode_frame_margins(model.infer_params, model.qstate, x, cfg,
                                 r["n_q"])
        torch.cuda.synchronize()
        t_device = time.perf_counter() - t0
        plain, _ = encode_frame(model.infer_params, model.qstate, x, cfg,
                                r["n_q"], plain=True)
        _, _, _, margins = encode_frame_margins(
            model.infer_params, model.qstate, x, cfg, r["n_q"], plain=True)
        flagged = (margins < TIE_THRESHOLD).any(1)[0]          # [T']
        diff = (plain != codes).any(1)[0]                      # [T']
        n_unflagged = int((diff & ~flagged).sum())
        check(n_unflagged == 0, f"{n_unflagged} positions differ from the "
                                "plain twins outside the tie guard")
        total_diff += int(diff.sum())
        total_flagged += int(flagged.sum())
        print(f"request {r['seconds']:>4} s @ {r['bw']:>4} kbps: n_q={r['n_q']} "
              f"frames={frames_T} encode+decode {r['codec_s'] * 1e3:.1f} ms, "
              f"compress+decompress {r['ecdc_s'] * 1e3:.1f} ms, "
              f"{len(r['data'])} B; vs plain twins: {int(diff.sum())} positions "
              f"differ, {int(flagged.sum())} tie-flagged; min margin "
              f"{stats['min_margin']:.3g}; encode_guarded {t_guarded * 1e3:.1f} ms"
              f" = device {t_device * 1e3:.1f} ms + host f64 resolution of "
              f"{stats['n_flagged']} positions")
    print(f"main path vs plain twins: {total_diff} differing positions, all "
          f"inside the {total_flagged} tie-flagged ones")
    return counts, model, registry, requests[-1][1]


def phase_cli_48(model) -> None:
    """`python -m encodec_tpu_torch in.wav out.ecdc -q -b 24` and its
    decompression, in process on the card, with the registry's 48 kHz
    factory returning the phase's random-weight model (the published
    checkpoint is not in the repository)."""
    import dataclasses
    import tempfile
    from unittest import mock

    from encodec_tpu_torch import __main__ as cli
    from encodec_tpu_torch.models import model as model_mod
    from encodec_tpu_torch.utils.audio import load_wav, save_wav

    # the name the CLI's registry and the .ecdc header carry
    named = model_mod.EncodecModel(
        dataclasses.replace(model.cfg, name="encodec_48khz"), model.params,
        model.qstate, device=model.device)

    def factory(pretrained=True, repository=None, device="cuda"):
        check(device == "cuda", f"the CLI asked for device {device}")
        return named

    n = 3 * named.sample_rate
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.dict(model_mod.MODELS, {"encodec_48khz": factory}):
        src, ecdc, out = (Path(tmp) / f for f in ("in.wav", "o.ecdc", "o.wav"))
        save_wav(stereo_audio(n, named.sample_rate, 300)[:1], src,
                 named.sample_rate)
        t0 = time.perf_counter()
        for argv in ([str(src), str(ecdc), "-q", "-b", "24"],
                     [str(ecdc), str(out)]):
            with mock.patch.object(sys, "argv", ["encodec_tpu_torch", *argv]):
                cli.main()
        wall = time.perf_counter() - t0
        wav, sr = load_wav(out)
        check(sr == named.sample_rate and wav.shape == (2, n)
              and bool(np.isfinite(wav).all()),
              f"CLI roundtrip gave {wav.shape} at {sr} Hz")
        print(f"CLI -q -b 24: mono 3 s wav -> {ecdc.stat().st_size} B .ecdc "
              f"-> stereo wav {wav.shape} at {sr} Hz in {wall:.2f} s")


def stereo_audio(n: int, sr: int, seed: int) -> np.ndarray:
    """Seeded noise plus two tones on each of two channels, [2, n] float32."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / sr
    wav = (0.05 * rng.randn(2, n)
           + 0.3 * np.sin(2 * np.pi * 440.0 * t + rng.uniform(0, np.pi, (2, 1)))
           + 0.2 * np.sin(2 * np.pi * 1230.0 * t))
    return np.clip(wav, -0.99, 0.99).astype(np.float32)


def ecdc_records(data: bytes, model) -> tuple:
    """A segmented raw `.ecdc` split into its header and, per segment, the
    4-byte scale field and the codes `[K, T']` unpacked from its bytes."""
    from encodec_tpu_torch.stream import binary

    fo = io.BytesIO(data)
    meta = binary.read_ecdc_header(fo)
    records = []
    for _, n in model.cfg.segments(meta["al"]):
        frames = math.ceil(n * model.frame_rate / model.sample_rate)
        scale = fo.read(4)
        nbytes = (frames * meta["nc"] * model.bits_per_codebook + 7) // 8
        vals = binary.unpack_bits(fo.read(nbytes), model.bits_per_codebook,
                                  count=frames * meta["nc"])
        records.append((scale, vals.reshape(frames, meta["nc"]).T))
    check(fo.read() == b"", "bytes left over after the last segment")
    return meta, records


def phase_main_path_48(torch, kernels, dev):
    """The 48 kHz stereo codec at full width, served like the 24 kHz one:
    1, 5.3 and 10 s requests and one of 95,100 samples (segments of 48000,
    47580 and 60 samples: the last two are both short), each at 6 and 24
    kbps, encode → decode and compress → decompress. Launches are counted
    for this phase alone."""
    from encodec_tpu_torch.models import encodec_model_48khz
    from encodec_tpu_torch.models.model import (encode_frame,
                                                encode_frame_margins)
    from encodec_tpu_torch.stream import compress, decompress

    model = encodec_model_48khz(kmeans_init=False, device=dev)
    registry = {model.name: lambda pretrained=True: model}
    cfg = model.cfg
    check(cfg.seanet.n_filters == 32 and cfg.seanet.dimension == 128
          and cfg.rvq.bins == 1024 and cfg.rvq.n_q == 16
          and cfg.channels == 2 and not cfg.seanet.causal
          and cfg.seanet.norm == "time_group_norm" and cfg.normalize
          and cfg.segment_length == 48_000 and cfg.segment_stride == 47_520,
          "not the full-width 48 kHz configuration")
    sr = model.sample_rate
    requests = [(n, stereo_audio(n, sr, 200 + 2 * i)) for i, n in
                enumerate((48_000, 254_400, 480_000, 95_100))]

    # -- the served path, counted: nothing but user calls in here -------
    kernels.reset_launch_counts()
    served = []
    for n, wav in requests:
        for bw in (6.0, 24.0):
            model.set_target_bandwidth(bw)
            t0 = time.perf_counter()
            frames = model.encode(wav[None])
            audio = model.decode(frames)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            data = compress(model, wav, models=registry)
            back, back_sr = decompress(data, models=registry)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            served.append(dict(n=n, wav=wav, bw=bw, frames=frames,
                               audio=audio, data=data, back=back,
                               sr=back_sr, n_q=model.n_q_active,
                               codec_s=t1 - t0, ecdc_s=t2 - t1))
    counts = launch_counts(kernels)
    print(f"48 kHz path launches: {json.dumps(counts)}")
    for name, k in counts.items():
        check(k > 0 or name == "lstm_grid",
              f"kernel {name} was never launched on the 48 kHz path")

    # -- verification, not counted --------------------------------------
    hop = cfg.seanet.hop_length
    total_diff = total_flagged = 0
    for r in served:
        segs = cfg.segments(r["n"])
        frames = r["frames"]
        check(len(frames) == len(segs), f"{len(frames)} frames for "
                                        f"{len(segs)} segments")
        for (codes, scale), (_, length) in zip(frames, segs):
            check(tuple(codes.shape) == (1, r["n_q"], math.ceil(length / hop)),
                  f"codes shape {tuple(codes.shape)}")
            check(bool(((codes >= 0) & (codes < cfg.rvq.bins)).all()),
                  "codes out of range")
            check(tuple(scale.shape) == (1, 1) and float(scale) > 0
                  and math.isfinite(float(scale)), f"scale {scale}")
        out_len = (cfg.segment_stride * (len(segs) - 1)
                   + math.ceil(segs[-1][1] / hop) * hop)
        audio = r["audio"]
        check(tuple(audio.shape) == (1, 2, out_len),
              f"audio shape {tuple(audio.shape)}, want (1, 2, {out_len})")
        check(bool(torch.isfinite(audio).all()), "decoded audio not finite")
        check(tuple(r["back"].shape) == (2, r["n"]) and r["sr"] == sr,
              f"decompressed shape {tuple(r['back'].shape)}")
        check(bool(torch.isfinite(r["back"]).all()), "decompressed not finite")
        # the file holds the writer's (tie-guarded) codes and, bit for bit,
        # the scales it computed
        model.set_target_bandwidth(r["bw"])
        guarded, stats = model.encode_guarded(r["wav"][None], TIE_THRESHOLD)
        meta, records = ecdc_records(r["data"], model)
        check(meta["al"] == r["n"] and meta["nc"] == r["n_q"],
              f"ecdc header {meta}")
        for (field, codes), (g_codes, g_scale) in zip(records, guarded):
            check(np.array_equal(codes, g_codes[0].cpu().numpy()),
                  "ecdc payload does not decode to the writer's codes")
            check(field == struct.pack("!f", float(g_scale)),
                  "ecdc scale field differs from the writer's scale")
        # kernel path vs plain twins on the card, group by group: equal
        # except at tie-guard-flagged positions
        _, groups = model.segment_groups(r["wav"][None])
        n_diff = n_flagged = 0
        for idxs, stacked in groups:
            with torch.inference_mode():
                plain, _ = encode_frame(model.infer_params, model.qstate,
                                        stacked, cfg, r["n_q"], plain=True)
                _, _, _, margins = encode_frame_margins(
                    model.infer_params, model.qstate, stacked, cfg, r["n_q"],
                    plain=True)
            kernel = torch.cat([frames[i][0] for i in idxs])
            flagged = (margins < TIE_THRESHOLD).any(1)
            diff = (plain != kernel).any(1)
            k = int((diff & ~flagged).sum())
            check(k == 0, f"{k} positions differ from the plain twins "
                          "outside the tie guard")
            n_diff += int(diff.sum())
            n_flagged += int(flagged.sum())
        total_diff += n_diff
        total_flagged += n_flagged
        print(f"48 kHz request {r['n'] / sr:.4f} s ({r['n']} samples, "
              f"segments {[n for _, n in segs]}) @ {r['bw']:>4} kbps: "
              f"n_q={r['n_q']} encode+decode {r['codec_s'] * 1e3:.1f} ms, "
              f"compress+decompress {r['ecdc_s'] * 1e3:.1f} ms, "
              f"{len(r['data'])} B; vs plain twins: {n_diff} positions "
              f"differ, {n_flagged} tie-flagged; min margin "
              f"{stats['min_margin']:.3g}, {stats['n_flagged']} positions "
              "resolved in host f64")
    print(f"48 kHz path vs plain twins: {total_diff} differing positions, "
          f"all inside the {total_flagged} tie-flagged ones")
    return counts, model, requests[2][1]


def stream_pieces(n: int, first: int, chunk: int, hop: int) -> list:
    """A live stream's pieces of an n-sample request: (start, end, finish?)
    for a `first`-sample first chunk, `chunk`-sample chunks, one chunk of
    the whole hops left, then the tail shorter than a hop."""
    pieces, t = [], 0
    n_full = n - n % hop
    while t < n_full:
        end = min(t + (first if t == 0 else chunk), n_full)
        pieces.append((t, end, False))
        t = end
    if n > n_full:
        pieces.append((n_full, n, True))
    return pieces


def offline_flags(torch, model, wav, n_q):
    """Positions [T'] whose offline K1 margin is under the tie guard at
    some stage (the codes there may fairly differ between two writers)."""
    from encodec_tpu_torch.models.model import encode_frame_margins

    x = torch.from_numpy(wav[None]).to(model.device).transpose(1, 2)
    with torch.inference_mode():
        _, _, _, margins = encode_frame_margins(
            model.infer_params, model.qstate, x, model.cfg, n_q)
    return (margins < TIE_THRESHOLD).any(1)[0]


def phase_stream(torch, kernels, model):
    """The 24 kHz model streamed as a live service streams it, then the
    fixed-chunk extractor, counted as one path. Per bandwidth (6 and 24
    kbps) one 10 s + 100-sample request: a 7-hop first chunk (the least that
    primes every conv), 6-hop (80 ms) chunks, a 5-hop chunk and the
    100-sample tail through `encode_finish`, each chunk's codes decoded as
    they arrive. Then `_StreamExtractor(chunk_hops=1024)` on a 30 s +
    57-sample signal and on one of another length."""
    from encodec_tpu_torch.models import StreamingCodec, min_first_chunk
    from encodec_tpu_torch.tools.inference import (_StreamExtractor,
                                                   extract_codes)

    cfg = model.cfg
    sr, hop = model.sample_rate, cfg.seanet.hop_length
    first = min_first_chunk(cfg.seanet)
    check(first == 7 * hop, f"min_first_chunk {first}, want {7 * hop}")
    n = 10 * sr + 100
    wav = request_audio(n / sr, sr, 400)
    check(wav.shape == (1, n), f"request shape {wav.shape}")
    pieces = stream_pieces(n, first, 6 * hop, hop)
    sig = {k: request_audio(m / sr, sr, 410 + k)
           for k, m in ((1, 30 * sr + 57), (2, 30 * sr + 100))}

    # -- the stream path, counted: nothing but user calls in here -------
    kernels.reset_launch_counts()
    runs = {}
    for bw in (6.0, 24.0):
        model.set_target_bandwidth(bw)
        codec = StreamingCodec(model)
        codes, audio, lat = [], [], []
        for a, b, finish in pieces:
            chunk = wav[None, :, a:b]
            t0 = time.perf_counter()
            c = codec.encode_finish(chunk) if finish else \
                codec.encode_chunk(chunk)
            out = codec.decode_chunk(c)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            codes.append(c)
            audio.append(out)
        runs[bw] = dict(codes=torch.cat(codes, -1), audio=torch.cat(audio, -1),
                        lat=np.array(lat),
                        n_q=min(model.n_q_active, cfg.rvq.n_q))
    extractor = _StreamExtractor(model, chunk_hops=1024)
    ex_codes, ex_s = {}, {}
    for k in (1, 2):
        t0 = time.perf_counter()
        ex_codes[k] = extractor(sig[k])
        ex_s[k] = time.perf_counter() - t0
    counts = launch_counts(kernels)
    stateful = kernels.lstm_scan.stateful_launches
    print(f"stream path launches: {json.dumps(counts)}, K3 from a carried "
          f"state: {stateful}")
    check(counts["rvq_encode_fused"] > 0 and counts["lstm_scan"] > 0
          and stateful > 0, "the stream path did not launch K2 and K3 from "
                            "a carried state")

    # -- verification, not counted --------------------------------------
    frames = -(-n // hop)
    for bw, r in runs.items():
        model.set_target_bandwidth(bw)
        check(tuple(r["codes"].shape) == (1, r["n_q"], frames),
              f"stream codes shape {tuple(r['codes'].shape)}")
        offline = model.encode(wav[None])[0][0]
        flagged = offline_flags(torch, model, wav, r["n_q"])
        diff = (r["codes"] != offline).any(1)[0]
        n_unflagged = int((diff & ~flagged).sum())
        check(n_unflagged == 0, f"stream @ {bw} kbps: {n_unflagged} positions "
                                "differ from the offline encode outside the "
                                "tie guard")
        audio = r["audio"]
        check(tuple(audio.shape) == (1, 1, frames * hop)
              and bool(torch.isfinite(audio).all()),
              f"stream audio shape {tuple(audio.shape)} or not finite")
        ref = model.decode([(r["codes"], None)])
        err = float((audio - ref).abs().max())
        check(err <= 1e-3, f"stream @ {bw} kbps: audio max|d| {err} > 1e-3 "
                           "from the offline decode of the same codes")
        lat = r["lat"] * 1e3
        print(f"stream 10 s + 100 samples @ {bw:>4} kbps: n_q={r['n_q']}, "
              f"{len(pieces)} chunks ({pieces[0][1]} samples, then "
              f"{6 * hop}, ..., a {pieces[-1][1] - pieces[-1][0]}-sample "
              f"tail); codes vs offline: {int(diff.sum())} positions differ, "
              f"all inside the {int(flagged.sum())} tie-flagged; audio vs "
              f"offline decode of the same codes max|d|={err:.3g}; per-chunk "
              f"encode+decode ms (host clock, synchronized): median "
              f"{np.median(lat):.3f}, p99 {np.percentile(lat, 99):.3f}, max "
              f"{lat.max():.3f}, first {lat[0]:.3f}; real-time factor "
              f"{lat.sum() / 1e3 / (n / sr):.4f}")

    model.set_target_bandwidth(24.0)
    offline_s = {}
    for k in (1, 2):
        t0 = time.perf_counter()
        want = extract_codes(model, sig[k])
        offline_s[k] = time.perf_counter() - t0
        flagged = offline_flags(torch, model, sig[k],
                                min(model.n_q_active, cfg.rvq.n_q))
        diff = torch.from_numpy((ex_codes[k] != want).any(0)).to(
            flagged.device)
        check(ex_codes[k].shape == want.shape and int((diff & ~flagged).sum()) == 0,
              f"extractor: codes differ from extract_codes outside the tie "
              f"guard (signal {k})")
        print(f"extractor chunk_hops=1024 on {sig[k].shape[1]} samples @ 24 "
              f"kbps: codes {ex_codes[k].shape}, {int(diff.sum())} positions differ "
              f"from extract_codes, all inside the {int(flagged.sum())} "
              f"tie-flagged; time {'first call' if k == 1 else 'new length'} "
              f"{ex_s[k] * 1e3:.1f} ms vs extract_codes (first call at "
              f"this length) {offline_s[k] * 1e3:.1f} ms")

    # one profiled 80 ms chunk of a primed stream
    codec = StreamingCodec(model)
    codec.decode_chunk(codec.encode_chunk(wav[None, :, :first]))
    chunk = wav[None, :, first:first + 6 * hop]
    profile_request(torch, lambda: codec.decode_chunk(codec.encode_chunk(chunk)),
                    "one streamed 80 ms chunk encode+decode @ 24.0 kbps")
    return counts


def k3_grid_plan_line(torch, dev, H):
    import ctypes

    from encodec_tpu_torch.kernels import build, lstm_cuda

    lib = build.load_library("lstm_grid")
    n_max = lstm_cuda.max_grid_ctas(H, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    regs, local = ctypes.c_int(), ctypes.c_int()
    build.check(lib, "lstm_grid", lib.lstm_grid_attributes(
        H, ctypes.addressof(regs), ctypes.addressof(local)))
    plans = {B: lstm_cuda.grid_plan(B, H, n_max) for B in (1, 32)}
    for B, plan in plans.items():
        check(plan.ctas <= n_max, f"K3 grid plan at B={B}: {plan}")
        check(lib.lstm_grid_smem_bytes(H, plan.batch_per_launch)
              == plan.smem_bytes,
              "K3 grid shared memory differs between the kernel and its plan")
    p = plans[1]
    return (f"K3 grid plan H={H}: {p.ctas} CTAs x {p.units_per_cta} units "
            f"({4 * p.units_per_cta} W_hh rows in registers per CTA) on {sms} "
            f"SMs, max co-resident CTAs {n_max} (occupancy API), "
            f"{lstm_cuda.GRID_THREADS} threads/CTA, {regs.value} "
            f"registers/thread ({local.value} B local), shared memory "
            f"{p.smem_bytes} B/CTA at B=1 and {plans[32].smem_bytes} at B=32 "
            f"({plans[32].n_launches} launch), at most "
            f"{lstm_cuda.grid_max_batch(H)} sequences per launch")


def phase_k3_grid(torch, kernels, dev):
    """K3's grid kernel per layer at H=1024, the breathing model's LSTM: B=1
    and 32 with T=480 (a 4 h night; the training batch of 32 nights) and
    B=1 with T=64 (a 64-hop extractor chunk), each from zero state and from
    a carried (h0, c0), against its twin and cuDNN's LSTM; then one launch
    over T=480 against launches over a carried 64 + 64 + ... split, which
    must give the same bits. The JSON row is B=1, T=480 from zero state."""
    H = 1024
    print(k3_grid_plan_line(torch, dev, H))
    w_hh = books(torch, (4 * H, H), 51, dev) / math.sqrt(6.0)  # ±1/sqrt(H)
    cudnn = lstm_yardstick(torch, w_hh, dev)
    rows = {}
    for B, T in ((1, 480), (32, 480), (1, 64)):
        xp = gauss(torch, (B, T, 4 * H), 52, dev, 1.0)
        h0 = torch.tanh(gauss(torch, (B, H), 53, dev, 1.0))
        c0 = gauss(torch, (B, H), 54, dev, 1.0)
        proj = xp.reshape(B * T, 4 * H)
        eye = cudnn.weight_ih_l0.detach()
        gemm_ms = device_ms(torch, lambda: proj @ eye, 5)
        for stateful in (False, True):
            st = (h0, c0) if stateful else (None, None)
            before = kernels.lstm_scan.grid_launches
            out, hT, cT = kernels.lstm_scan(xp, w_hh, *st, return_state=True)
            check(kernels.lstm_scan.grid_launches == before + 1,
                  f"K3 B={B} T={T} H={H} did not launch the grid kernel once")
            ref = kernels.lstm_scan_plain(xp, w_hh, *st, return_state=True)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max())
                      for a, b in zip((out, hT, cT), ref))
            # 480 recurrent steps sum in another order than cuBLAS
            check(err <= 1e-4, f"K3 grid B={B} T={T} state={stateful}: "
                               f"max|d| {err} > 1e-4")
            ms = device_ms(torch, lambda: kernels.lstm_scan(
                xp, w_hh, *st, return_state=True), 10)
            plain_ms = device_ms(torch, lambda: kernels.lstm_scan_plain(
                xp, w_hh, *st, return_state=True), 2)
            lib_state = (h0[None], c0[None]) if stateful else None
            with torch.no_grad():
                lib_err = float((cudnn(xp, lib_state)[0] - out).abs().max())
                lib_ms = device_ms(torch, lambda: cudnn(xp, lib_state), 5)
            nbytes = (B * T * 4 * H + 4 * H * H + B * T * H + B * H
                      + (2 * B * H if stateful else 0)) * 4
            b_ms, b_by = bound(2.0 * B * T * H * 4 * H, nbytes)
            print(f"K3 grid lstm_scan B={B} T={T} H={H} "
                  f"{'from (h0, c0)' if stateful else 'zero state'}: out/hT/cT "
                  f"max|d| vs plain {err:.3g} (cuDNN vs kernel {lib_err:.3g}); "
                  f"per layer device ms: kernel={ms:.4f} ({ms / T * 1e3:.3f} "
                  f"us/step) plain={plain_ms:.4f} library(cuDNN LSTM)="
                  f"{lib_ms:.4f} (its identity input GEMM alone {gemm_ms:.4f}) "
                  f"bound={b_ms:.5f} ({b_by})")
            rows[B, T, stateful] = dict(ms=ms, plain_ms=plain_ms,
                                        library_ms=lib_ms, bound_ms=b_ms,
                                        bound_by=b_by, max_abs_err=err)
    for B in (1, 32):
        T = 480
        xp = gauss(torch, (B, T, 4 * H), 55, dev, 1.0)
        h0 = torch.tanh(gauss(torch, (B, H), 56, dev, 1.0))
        c0 = gauss(torch, (B, H), 57, dev, 1.0)
        whole, hT, cT = kernels.lstm_scan(xp, w_hh, h0, c0, return_state=True)
        outs, h, c = [], h0, c0
        for t in range(0, T, 64):
            out, h, c = kernels.lstm_scan(xp[:, t:t + 64].contiguous(), w_hh,
                                          h.contiguous(), c, return_state=True)
            outs.append(out)
        torch.cuda.synchronize()
        check(torch.equal(torch.cat(outs, 1), whole) and torch.equal(h, hT)
              and torch.equal(c, cT),
              f"K3 grid B={B}: the carried 64 + 64 + ... split differs from "
              "one launch")
        print(f"K3 grid from state B={B} T={T} H={H}: one launch == "
              f"{len(outs)} launches of 64, ..., {T % 64 or 64} steps with "
              "(h, c) carried, bit for bit (out, hT, cT)")
    return rows[1, 480, False]


def breathing_signal(n: int, seed: int) -> np.ndarray:
    """A seeded synthetic night at 10 Hz, [n] float32: breathing at 12-18
    breaths a minute with a slowly varying depth, noise and a few motion
    bursts."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 10.0
    rate = 0.25 + 0.04 * np.sin(2 * np.pi * t / 3600.0 + rng.uniform(0, 6))
    sig = np.sin(2 * np.pi * np.cumsum(rate) / 10.0)
    sig *= 1.0 + 0.3 * np.sin(2 * np.pi * t / 1800.0)
    sig += 0.1 * rng.randn(n)
    for start in rng.randint(0, max(1, n - 600), size=3):
        sig[start:start + 600] += 3.0 * rng.randn(600)
    return sig.astype(np.float32)


def phase_breathing(torch, kernels, dev):
    """The breathing tokenizer (`breathing_model`, full width, H=1024) served
    as its users run it, counted as one path: two 4 h nights encoded and
    decoded, the training batch of 32 nights of 4 h through `encode`, then
    `tools.inference.process_dataset` over a `BreathingDataset` of three
    nights (4 h, 6 h + 17 samples, 8 h) offline and with
    `stream_chunk_hops=64`."""
    import tempfile

    from encodec_tpu_torch.data import BreathingDataset
    from encodec_tpu_torch.models import breathing_model
    from encodec_tpu_torch.models.model import (decode_frame, encode_frame,
                                                encode_frame_margins)
    from encodec_tpu_torch.tools.inference import process_dataset

    model = breathing_model(kmeans_init=False, device=dev)
    cfg = model.cfg
    check(cfg.seanet.n_filters == 32 and cfg.seanet.dimension == 256
          and cfg.rvq.bins == 1024 and model.n_q_active == 8
          and cfg.rvq.shared_codebook and cfg.seanet.hop_length == 300
          and model.params["encoder"]["lstm"]["layers"][0]["w_hh"].shape
          == (4096, 1024), "not the full-width breathing configuration")
    n4 = 4 * 36_000
    nights = [breathing_signal(n4, 600 + i)[None] for i in range(2)]
    batch = np.stack([breathing_signal(n4, 700 + i)[None]
                      for i in range(32)])                     # [32, 1, n]
    tmp = tempfile.TemporaryDirectory()
    chan = Path(tmp.name) / "synth" / "thorax"
    chan.mkdir(parents=True)
    lengths = (n4, 6 * 36_000 + 17, 8 * 36_000)
    for i, n in enumerate(lengths):
        np.savez(chan / f"night{i}.npz", data=breathing_signal(n, 800 + i),
                 fs=10)
    dataset = BreathingDataset(tmp.name, "synth", mode="test")
    hours = sum(lengths) / 36_000

    # -- the breathing path, counted: nothing but user calls in here ------
    kernels.reset_launch_counts()
    served = []
    for wav in nights:
        t0 = time.perf_counter()
        frames = model.encode(wav[None])
        audio = model.decode(frames)
        torch.cuda.synchronize()
        served.append(dict(wav=wav, codes=frames[0][0], audio=audio,
                           s=time.perf_counter() - t0))
    t0 = time.perf_counter()
    batch_codes = model.encode(batch)[0][0]
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    out_dirs, extract_s = {}, {}
    for hops in (None, 64):
        out_dirs[hops] = Path(tmp.name) / f"codes_{hops}"
        t0 = time.perf_counter()
        n_written = process_dataset(model, dataset, str(out_dirs[hops]),
                                    stream_chunk_hops=hops)
        extract_s[hops] = time.perf_counter() - t0
        check(n_written == 3, f"process_dataset wrote {n_written} files")
    counts = launch_counts(kernels)
    stateful = kernels.lstm_scan.stateful_launches
    print(f"breathing path launches: {json.dumps(counts)}, K3 from a carried "
          f"state: {stateful}")
    check(counts["rvq_encode_fused"] > 0 and counts["lstm_grid"] > 0
          and counts["lstm_grid"] == counts["lstm_scan"] and stateful > 0,
          "the breathing path did not launch K2 and K3's grid kernel (from "
          "zero and from a carried state)")

    # -- verification, not counted --------------------------------------
    hop = cfg.seanet.hop_length
    for i, r in enumerate(served):
        codes = r["codes"]
        check(tuple(codes.shape) == (1, 8, n4 // hop),
              f"night codes shape {tuple(codes.shape)}")
        check(tuple(r["audio"].shape) == (1, 1, n4)
              and bool(torch.isfinite(r["audio"]).all()),
              f"night audio shape {tuple(r['audio'].shape)} or not finite")
        x = torch.from_numpy(r["wav"][None]).to(dev).transpose(1, 2)
        with torch.inference_mode():
            plain, _ = encode_frame(model.infer_params, model.qstate, x, cfg,
                                    8, plain=True)
            _, _, _, margins = encode_frame_margins(
                model.infer_params, model.qstate, x, cfg, 8, plain=True)
            plain_audio = decode_frame(model.infer_params, model.qstate,
                                       codes, cfg, plain=True)
        flagged = (margins < TIE_THRESHOLD).any(1)[0]
        diff = (plain != codes).any(1)[0]
        check(int((diff & ~flagged).sum()) == 0,
              f"night {i}: codes differ from the plain twins outside the tie "
              "guard")
        err = float((r["audio"].transpose(1, 2) - plain_audio).abs().max())
        check(err <= 1e-3, f"night {i}: audio max|d| {err} > 1e-3 from the "
                           "plain twins' decode of the same codes")
        print(f"breathing night {i} (4 h, {n4} samples, T={n4 // hop} LSTM "
              f"steps): encode+decode {r['s'] * 1e3:.1f} ms; vs plain twins: "
              f"{int(diff.sum())} positions differ, {int(flagged.sum())} "
              f"tie-flagged; audio max|d| {err:.3g}")
    xb = torch.from_numpy(batch).to(dev).transpose(1, 2)
    with torch.inference_mode():
        plain, _ = encode_frame(model.infer_params, model.qstate, xb, cfg, 8,
                                plain=True)
        _, _, _, margins = encode_frame_margins(
            model.infer_params, model.qstate, xb, cfg, 8, plain=True)
    flagged = (margins < TIE_THRESHOLD).any(1)
    diff = (plain != batch_codes).any(1)
    check(tuple(batch_codes.shape) == (32, 8, n4 // hop)
          and int((diff & ~flagged).sum()) == 0,
          "batch of 32 nights: codes differ from the plain twins outside the "
          "tie guard")
    print(f"breathing batch B=32 x 4 h through encode: {batch_s * 1e3:.1f} ms; "
          f"vs plain twins: {int(diff.sum())} positions differ, "
          f"{int(flagged.sum())} tie-flagged")
    n_diff = 0
    for i, n in enumerate(lengths):
        with np.load(out_dirs[None] / "thorax" / f"night{i}.npz") as a, \
                np.load(out_dirs[64] / "thorax" / f"night{i}.npz") as b:
            check(a["codes"].shape == b["codes"].shape == (8, -(-n // hop))
                  and float(a["fs"]) == float(b["fs"]) == 10 / hop,
                  f"extraction night {i}: codes {a['codes'].shape}, "
                  f"{b['codes'].shape}")
            n_diff += int((a["codes"] != b["codes"]).any(0).sum())
    check(n_diff == 0, f"streamed extraction differs from the offline one at "
                       f"{n_diff} positions")
    print(f"extraction over {len(lengths)} nights ({hours:.4f} h): offline "
          f"{extract_s[None]:.2f} s ({extract_s[None] / hours:.4f} s per hour "
          f"of signal), stream_chunk_hops=64 {extract_s[64]:.2f} s "
          f"({extract_s[64] / hours:.4f} s per hour); codes equal at every "
          "position")
    tmp.cleanup()

    groups = profile_request(
        torch, lambda: model.decode(model.encode(nights[0][None])),
        "one 4 h breathing night encode+decode")
    busy = sum(groups.values())
    check(busy > 0, "the breathing night's profile recorded no device time")
    print(f"breathing night: K3 {groups.get('K3', 0.0):.3f} ms of {busy:.3f} "
          f"ms device busy (share {groups.get('K3', 0.0) / busy:.3f})")
    return counts


def phase_hires(torch, kernels, dev):
    """`params/hires_tokens.yaml`'s model (H=256, hop 10: T=14,400 LSTM steps
    per 4 h night; the cluster kernel's longest chain), built by
    `model_from_config` from that file's `model:` values as a dict: one
    night encoded and decoded, K3's device ms per layer. Counted as its own
    path."""
    from encodec_tpu_torch.train import ConfigNamespace, model_from_config

    model = model_from_config(ConfigNamespace({"model": dict(
        audio_normalize=False, bins=1024, causal=True, channels=1,
        dimension=256, filters=32, name="my_encodec", norm="layer_norm",
        ratios=[5, 2, 1], sample_rate=10, segment="None",
        target_bandwidths=[0.1])}), device=dev)
    check(model.params["encoder"]["lstm"]["layers"][0]["w_hh"].shape
          == (1024, 256) and model.cfg.seanet.hop_length == 10,
          "not the hires_tokens configuration")
    n = 4 * 36_000
    wav = breathing_signal(n, 900)[None]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    frames = model.encode(wav[None])
    audio = model.decode(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(kernels)
    check(counts["lstm_scan"] == 4 and counts["lstm_grid"] == 0,
          f"hires_tokens launches {counts}")
    check(tuple(frames[0][0].shape) == (1, model.n_q_active, n // 10)
          and tuple(audio.shape) == (1, 1, n)
          and bool(torch.isfinite(audio).all()),
          "hires_tokens codes or audio shape, or audio not finite")
    k3_ms = device_ms(torch, lambda: model.encode(wav[None]), 1,
                      "lstm_scan_kernel") / 2
    print(f"hires_tokens night (4 h, T={n // 10} LSTM steps at H=256): "
          f"encode+decode {wall * 1e3:.1f} ms (first call); K3 per layer in "
          f"the encode {k3_ms:.4f} ms ({k3_ms / (n // 10) * 1e3:.3f} us/step)")
    # the same layer alone, against its twin and cuDNN's LSTM
    w_hh = model.params["encoder"]["lstm"]["layers"][0]["w_hh"]
    H, T = w_hh.shape[1], n // 10
    xp = gauss(torch, (1, T, 4 * H), 58, dev, 1.0)
    cudnn = lstm_yardstick(torch, w_hh, dev)
    err = float((kernels.lstm_scan(xp, w_hh)
                 - kernels.lstm_scan_plain(xp, w_hh)).abs().max())
    check(err <= 1e-4, f"K3 B=1 T={T} H={H}: max|d| {err} > 1e-4")
    ms = device_ms(torch, lambda: kernels.lstm_scan(xp, w_hh), 3)
    plain_ms = device_ms(torch, lambda: kernels.lstm_scan_plain(xp, w_hh), 1)
    with torch.no_grad():
        lib_ms = device_ms(torch, lambda: cudnn(xp), 2)
    b_ms, b_by = bound(2.0 * T * H * 4 * H, (T * 4 * H + 4 * H * H + T * H) * 4)
    print(f"K3 lstm_scan B=1 T={T} H={H} (hires_tokens, gaussian inputs): "
          f"max|d| vs plain {err:.3g}; per layer device ms: kernel={ms:.4f} "
          f"({ms / T * 1e3:.3f} us/step) plain={plain_ms:.4f} library(cuDNN "
          f"LSTM)={lib_ms:.4f} bound={b_ms:.5f} ({b_by})")
    return counts


def raw_ecdc(model, frames, audio_length: int) -> bytes:
    """The raw `.ecdc` of `frames` (the file `compress` writes without the
    LM for the same codes and scales)."""
    from encodec_tpu_torch.stream import binary

    fo = io.BytesIO()
    binary.write_ecdc_header(fo, {"m": model.name, "al": audio_length,
                                  "nc": int(frames[0][0].shape[1]),
                                  "lm": False})
    for codes, scale in frames:
        if scale is not None:
            fo.write(struct.pack("!f", float(scale.reshape(-1)[0])))
        fo.write(binary.pack_bits(codes[0].cpu().numpy().T,
                                  model.bits_per_codebook))
    return fo.getvalue()


def lm_pair(torch, model, seed: int) -> tuple:
    """The integer LM of `model`'s published LM configuration with seeded
    random weights, on the card and on the CPU (the same weights)."""
    from encodec_tpu_torch.models.ilm import IntLMModel
    from encodec_tpu_torch.models.lm import LMModel, init_lm, lm_config_for

    cfg = lm_config_for(model)
    params = init_lm(torch.Generator().manual_seed(seed), cfg)
    return (LMModel(cfg, params, device=model.device),
            IntLMModel.from_lm(LMModel(cfg, params, device="cpu")))


def lm_rows_equal(torch, gpu, cpu, codes_list, C: int = 32) -> str:
    """A teacher-forced chunk of the writer's first C tokens and the step
    after it, on the card and on the CPU: rows equal bit for bit."""
    S, K = len(codes_list), codes_list[0].shape[0]
    shifted = np.zeros((S, K, C + 1), np.int64)
    for s, c in enumerate(codes_list):
        n = min(c.shape[1], C + 1)
        shifted[s, :, 1:n] = 1 + c[:, :n - 1]
    rows = {}
    for name, ilm in (("cuda", gpu), ("cpu", cpu)):
        x = torch.from_numpy(shifted).to(ilm.device)
        with torch.inference_mode():
            chunk, state = ilm.chunk_forward(x[:, :, :C], ilm.init_stream(S))
            step, _ = ilm.step(x[:, :, C], state)
        rows[name] = (chunk.cpu().numpy(), step.cpu().numpy())
    check(np.array_equal(rows["cuda"][0], rows["cpu"][0]),
          f"LM chunk rows S={S} K={K}: CUDA differs from the CPU")
    check(np.array_equal(rows["cuda"][1], rows["cpu"][1]),
          f"LM step rows S={S} K={K}: CUDA differs from the CPU")
    return (f"chunk [{S}, {C}, {K}, {gpu.card}] and the next step "
            f"[{S}, {K}, {gpu.card}] equal")


def phase_lm(torch, kernels, model, model48, wav24, wav48):
    """LM entropy coding (lmv=3) on the card, counted as one path: the
    integer LMs at the published widths (24 kHz: dim 200, 8 heads, 5
    layers, card 1024, n_q 32, W=262; 48 kHz: n_q 16, W=525) with seeded
    random weights; the 10 s 24 kHz request at 6 and 24 kbps with
    `lm_restart="auto"` (2 lanes of 375 steps) and at 6 kbps unblocked (one
    lane of 750), and the 10 s 48 kHz request at 24 kbps (11 segments in
    lockstep, the `fl` index), each compressed and decompressed on the
    card. Checks: decoded codes equal the writer's (tie-guarded) codes and
    the `cc` CRC passes; the audio equals the raw path's decode of the same
    codes; each file equals, byte for byte, the one the port's CPU LM
    writes from the same codes; CUDA CDF rows equal the CPU's."""
    from encodec_tpu_torch import native
    from encodec_tpu_torch.models.ilm import IntLMModel
    from encodec_tpu_torch.stream import binary, compress, decompress
    from encodec_tpu_torch.stream.compress import write_lm_payload

    t_phase = time.perf_counter()
    check(native.available(), "the native range coder did not build")
    lm24, cpu24 = lm_pair(torch, model, 70)
    lm48, cpu48 = lm_pair(torch, model48, 71)
    check((lm24.cfg.dim, lm24.cfg.num_heads, lm24.cfg.num_layers,
           lm24.cfg.card, lm24.cfg.n_q, lm24.cfg.past_context)
          == (200, 8, 5, 1024, 32, 262)
          and (lm48.cfg.n_q, lm48.cfg.past_context) == (16, 525),
          "not the published LM widths")
    jobs = [("24 kHz 10 s @ 6 kbps, lm_restart auto", model, lm24, cpu24,
             6.0, wav24, "auto"),
            ("24 kHz 10 s @ 24 kbps, lm_restart auto", model, lm24, cpu24,
             24.0, wav24, "auto"),
            ("24 kHz 10 s @ 6 kbps, unblocked", model, lm24, cpu24, 6.0,
             wav24, None),
            ("48 kHz stereo 10 s @ 24 kbps, 11 segments", model48, lm48,
             cpu48, 24.0, wav48, None)]

    # -- the LM path, counted: nothing but user calls in here -----------
    # `decompress` reads the code frames through `read_frames`; a spy keeps
    # what it returned and its time (the range decode and the cc check),
    # so each file is decoded once (the package's `compress` is the
    # function, so the module comes from importlib)
    compress_module = importlib.import_module(
        "encodec_tpu_torch.stream.compress")
    read_frames = compress_module.read_frames
    decoded = []

    def spy(*args, **kwargs):
        t0 = time.perf_counter()
        out = read_frames(*args, **kwargs)
        decoded.append((out[1], out[2], time.perf_counter() - t0))
        return out

    compress_module.read_frames = spy
    kernels.reset_launch_counts()
    served = []
    for label, m, lm, cpu_ilm, bw, wav, restart in jobs:
        reg = {m.name: lambda pretrained=True, m=m: m}
        m.set_target_bandwidth(bw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = compress(m, wav, use_lm=True, lm=lm, models=reg,
                        lm_restart=restart)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back, sr = decompress(data, models=reg, lm=lm)
        torch.cuda.synchronize()
        served.append(dict(label=label, m=m, lm=lm, cpu=cpu_ilm, bw=bw,
                           wav=wav, reg=reg, data=data, back=back, sr=sr,
                           compress_s=t1 - t0,
                           decompress_s=time.perf_counter() - t1))
    counts = launch_counts(kernels)
    compress_module.read_frames = read_frames
    check(len(decoded) == len(served), "decompress did not read its frames "
          "through read_frames")
    print(f"lm path launches: {json.dumps(counts)}")
    check(counts["nearest_codebook"] > 0 and counts["lstm_scan"] > 0
          and counts["rvq_encode_fused"] == 0,
          "the LM path did not launch K1 and K3 (and no K2)")

    # -- verification, not counted --------------------------------------
    for r, (frames, al, decode_s) in zip(served, decoded):
        m, data, wav = r["m"], r["data"], r["wav"]
        gpu = IntLMModel.from_lm(r["lm"])
        m.set_target_bandwidth(r["bw"])
        meta = binary.read_ecdc_header(io.BytesIO(data))
        guarded, _ = m.encode_guarded(wav[None], TIE_THRESHOLD)
        check(len(frames) == len(guarded) and all(
            np.array_equal(f[0].numpy(), g[0].cpu().numpy())
            for f, g in zip(frames, guarded)),
            f"{r['label']}: decoded codes differ from the written ones")
        t_check = time.perf_counter()
        raw = raw_ecdc(m, frames, al)
        raw_back, _ = decompress(raw, models=r["reg"])
        check(r["sr"] == m.sample_rate and tuple(r["back"].shape)
              == (m.channels, wav.shape[-1])
              and bool(torch.equal(r["back"], raw_back)),
              f"{r['label']}: audio differs from the raw path's decode")
        # the port's CPU LM writes the same file from the same codes
        codes_list = [f[0][0].numpy() for f in frames]
        base = {k: meta[k] for k in ("m", "al", "nc", "lm")}
        cpu_file = io.BytesIO()
        restart = meta.get("lmb")
        t0 = time.perf_counter()
        write_lm_payload(cpu_file, base, frames, r["cpu"], restart)
        cpu_s = time.perf_counter() - t0
        check_s = time.perf_counter() - t_check - cpu_s
        check(cpu_file.getvalue() == data,
              f"{r['label']}: the card's file differs from the CPU writer's")
        R = restart or max(c.shape[1] for c in codes_list)
        blocks = ([c[:, i:i + R] for c in codes_list
                   for i in range(0, c.shape[1], R)])
        t0 = time.perf_counter()
        gpu.codec_symbol_bounds_batched(blocks)
        encode_s = time.perf_counter() - t0
        Ts = [b.shape[1] for b in blocks]
        steps = max(Ts)
        seconds = wav.shape[-1] / m.sample_rate
        r.update(Ts=Ts, blocks=blocks, meta=meta)
        print(f"lm request {r['label']}: K={meta['nc']}, {len(Ts)} lanes x "
              f"{steps} steps; {len(data)} B vs raw {len(raw)} B ("
              f"{len(data) / len(raw):.4f}); compress {r['compress_s'] * 1e3:.1f}"
              f" ms, decompress {r['decompress_s'] * 1e3:.1f} ms; teacher-"
              f"forced LM encode {encode_s * 1e3:.1f} ms; range decode "
              f"{decode_s * 1e3:.1f} ms = {decode_s / steps * 1e3:.3f} ms per "
              f"step, {decode_s / seconds * 1e3:.1f} ms per s of audio; "
              f"codes = written, cc ok, audio = raw decode, file = CPU writer's"
              f" (CPU writer {cpu_s * 1e3:.1f} ms, raw decode and checks "
              f"{check_s * 1e3:.1f} ms)")
    t0 = time.perf_counter()
    print(f"lm portability: 24 kHz "
          f"{lm_rows_equal(torch, IntLMModel.from_lm(lm24), cpu24, served[1]['blocks'])}"
          f"; 48 kHz {lm_rows_equal(torch, IntLMModel.from_lm(lm48), cpu48, served[3]['blocks'])}"
          f" ({(time.perf_counter() - t0) * 1e3:.1f} ms)")
    t0 = time.perf_counter()

    # one profiled decode step and a profiled 8-step decode per layout
    for r in (served[1], served[3]):
        gpu = IntLMModel.from_lm(r["lm"])
        S, K = len(r["Ts"]), r["meta"]["nc"]
        feed = torch.ones((S, K), dtype=torch.int64, device=model.device)
        with torch.inference_mode():
            state = gpu.init_stream(S)
            for _ in range(3):
                _, state = gpu.step(feed, state)
        records, wall = kernel_window(torch, lambda: gpu.step(feed, state), 5)
        launches = sum(n for n, _ in records.values()) / 5
        busy = sum(us for _, us in records.values()) / 5 / 1e3
        datas = lm_streams(r["data"], r["meta"], r["m"])
        n_steps = 8
        records, wall_d = kernel_window(
            torch, lambda: gpu.decode_lockstep(
                datas, K, [min(n_steps, T) for T in r["Ts"]]), 1)
        busy_d = sum(us for _, us in records.values()) / 1e3
        print(f"lm decode profile, {r['label']} (S={S}, K={K}): one step "
              f"{launches:.0f} kernel launches, device busy {busy:.4f} ms, "
              f"wall {wall / 5:.3f} ms (profiled); {n_steps} lockstep decode "
              f"steps: wall {wall_d:.2f} ms, device busy {busy_d:.3f} ms, idle "
              f"share {1 - busy_d / wall_d:.3f}")
    print(f"lm profiles {time.perf_counter() - t0:.1f} s; lm phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def lm_streams(data: bytes, meta: dict, model) -> list:
    """The range-coded streams of an lmv=3 file with an `fl` index."""
    from encodec_tpu_torch.stream import binary

    fo = io.BytesIO(data)
    binary.read_ecdc_header(fo)
    segmented = "lmb" not in meta
    if not segmented and model.normalize:
        fo.read(4)
    out = []
    for n in meta["fl"]:
        if segmented and model.normalize:
            fo.read(4)
        out.append(fo.read(n))
    return out


def launch_counts(kernels) -> dict:
    """The wrappers' launch counts, and the grid kernel's own."""
    return dict(kernels.launch_counts(),
                lstm_grid=kernels.lstm_scan.grid_launches)


KERNEL_GROUPS = (("K2", "vq_rvq_kernel"), ("K1", "vq_nearest_kernel"),
                 ("K3", "lstm_scan_kernel"), ("K3", "lstm_grid_kernel"))


def kernel_group(name: str) -> str:
    for group, key in KERNEL_GROUPS:
        if key in name:
            return group
    low = name.lower()
    if any(k in low for k in ("conv", "cudnn", "xmma", "implicit")):
        return "cuDNN conv"
    if "gemm" in low or "cutlass" in low:
        return "GEMM"
    return "other"


def k2_in_request(torch, kernels, model, wav, request_ms, phase_ms):
    """K2 as the profiled request ran it, beside K2 alone on the same
    request's latents with the L2 cache warm (back to back, as in the K2
    phase) and flushed before each call (as in the request, where the
    convolutions' activations pass through L2 between encodes)."""
    from encodec_tpu_torch.models.model import encode_frame_margins

    dev = model.qstate.embed.device
    n_q = min(model.n_q_active, model.cfg.rvq.n_q)
    x = torch.from_numpy(wav[None]).to(dev).transpose(1, 2)
    with torch.inference_mode():
        _, _, z, _ = encode_frame_margins(model.infer_params, model.qstate,
                                          x, model.cfg, n_q)
    z = z.reshape(-1, z.shape[-1]).contiguous()
    embed = model.qstate.embed.contiguous()
    shared = model.cfg.rvq.shared_codebook
    flush = torch.empty(64 * 2 ** 20, device=dev)  # 256 MiB, 5x the L2

    def run():
        kernels.rvq_encode_fused(z, embed, n_q, shared)

    def cold():
        flush.fill_(1.0)
        run()

    g = gauss(torch, tuple(z.shape), 20, dev, 0.3)

    def gaussian():
        kernels.rvq_encode_fused(g, embed, n_q, shared)

    warm_ms = device_ms(torch, run, 20, "vq_rvq_kernel")
    cold_ms = device_ms(torch, cold, 20, "vq_rvq_kernel")
    g_ms = device_ms(torch, gaussian, 20, "vq_rvq_kernel")
    return (f"K2 in the 10 s request @ 24 kbps: {request_ms:.4f} ms under the "
            f"profiler; alone on that request's latents (N={z.shape[0]}, "
            f"n_q={n_q}): L2 warm {warm_ms:.4f} ms, L2 flushed before each "
            f"call {cold_ms:.4f} ms; the phase's gaussian rows on the model's "
            f"books, L2 warm {g_ms:.4f} ms; the K2 phase (N=750, n_q=32, "
            f"gaussian rows, its own books, L2 warm) {phase_ms:.4f} ms")


def profile_request(torch, fn, label: str) -> dict:
    """Device time of one call of `fn` by kernel group, from a whole
    profiler window (`kernel_window`), printed with the five largest
    kernels; returns ms per group. Wall time includes the profiler's own
    overhead, so the idle share is an upper bound."""
    records, wall_ms = kernel_window(torch, fn, 1)
    groups: dict = {}
    for key, (_, us) in records.items():
        g = kernel_group(key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
    busy = sum(groups.values())
    split = ", ".join(f"{g} {ms:.3f} ms" for g, ms in
                      sorted(groups.items(), key=lambda kv: -kv[1]))
    print(f"profile {label}: wall {wall_ms:.2f} ms (profiled), device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}; by group: "
          f"{split}")
    top = sorted(((us / 1e3, n, key[:60]) for key, (n, us) in records.items()),
                 reverse=True)
    for ms, n, key in top[:5]:
        print(f"    {ms:8.3f} ms  x{round(n):<4d} {key}")
    return groups


def phase_profile(torch, kernels, model, registry, wav, k2_phase_ms):
    """One 10 s 24 kHz request by kernel group, after the counted main
    path; K2 in the 24 kbps request beside K2 alone on its latents."""
    from encodec_tpu_torch.stream import compress, decompress

    def codec():
        model.decode(model.encode(wav[None]))

    def ecdc():
        decompress(compress(model, wav, models=registry), models=registry)

    for bw, what, fn in ((6.0, "encode+decode", codec),
                         (24.0, "encode+decode", codec),
                         (6.0, "compress+decompress", ecdc)):
        model.set_target_bandwidth(bw)
        groups = profile_request(torch, fn,
                                 f"10 s request {what} @ {bw} kbps")
        if bw == 24.0 and fn is codec:
            print(k2_in_request(torch, kernels, model, wav,
                                groups.get("K2", 0.0), k2_phase_ms))


def phase_profile_48(torch, model, wav):
    """One 10 s 48 kHz stereo request, encode+decode at 24 kbps, by kernel
    group."""
    def codec():
        model.decode(model.encode(wav[None]))

    model.set_target_bandwidth(24.0)
    profile_request(torch, codec,
                    "10 s 48 kHz stereo request encode+decode @ 24.0 kbps")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    try:
        import encodec_tpu_torch
        from encodec_tpu_torch import kernels
        from encodec_tpu_torch.device import set_fp32_policy
        from encodec_tpu_torch.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: the encodec_tpu_torch package is not next to "
              f"this script ({exc})", file=sys.stderr)
        return 2
    pkg = Path(encodec_tpu_torch.__file__).resolve().parent
    if pkg.parent != here:
        # an installed copy elsewhere is not the checkout under test
        print(f"chip_smoke: imported encodec_tpu_torch from {pkg}, not from "
              f"the checkout next to this script ({here})", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    set_fp32_policy()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"device: {name}")
    print(smi[0] if smi else "nvidia-smi: no output")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    k1 = phase_k1(torch, kernels, dev)
    k2 = phase_k2(torch, kernels, dev)
    k3 = phase_k3(torch, kernels, dev)
    counts, model, registry, wav10 = phase_main_path(torch, kernels, dev)
    phase_profile(torch, kernels, model, registry, wav10, k2["ms"])
    counts48, model48, wav48 = phase_main_path_48(torch, kernels, dev)
    phase_profile_48(torch, model48, wav48)
    phase_cli_48(model48)
    phase_k3_state(torch, kernels, dev)
    counts_stream = phase_stream(torch, kernels, model)
    k3_grid = phase_k3_grid(torch, kernels, dev)
    counts_breathing = phase_breathing(torch, kernels, dev)
    counts_hires = phase_hires(torch, kernels, dev)
    counts_lm = phase_lm(torch, kernels, model, model48, wav10, wav48)

    paths = {"24k": counts, "48k": counts48, "stream": counts_stream,
             "breathing": counts_breathing, "hires_tokens": counts_hires,
             "lm": counts_lm}
    for c in paths.values():   # lstm_scan counts both K3 kernels
        c["lstm_cluster"] = c["lstm_scan"] - c["lstm_grid"]
    rows = [
        ("K1 nearest_codebook", "vq_search.cu", "vq_pallas.py:43",
         "nearest_codebook", k1),
        ("K2 rvq_encode_fused", "vq_search.cu", "vq_pallas.py:124",
         "rvq_encode_fused", k2),
        ("K3 lstm_scan (cluster kernel, H <= 512)", "lstm_scan.cu",
         "lstm_pallas.py:55", "lstm_cluster", k3),
        ("K3 lstm_scan (grid kernel, 512 < H <= 1024)", "lstm_grid.cu",
         "lstm_pallas.py:55", "lstm_grid", k3_grid),
    ]
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda",
         "source": f"encodec_tpu_torch/kernels/csrc/{src}",
         "replaces": f"encodec_tpu/kernels/{rep}",
         "launches": {p: c[fn] for p, c in paths.items()}, **m}
        for n, src, rep, fn, m in rows]}))
    print(f"profiler windows: {profiler_stats['windows']}; "
          f"{profiler_stats['short']} short of records, scaled up for "
          f"{profiler_stats['restored']} launches in all; "
          f"{profiler_stats['unmatched']} unusable or matching no earlier "
          f"window; {profiler_stats['longer_than_span']} longer than their "
          "CUDA-event span")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
