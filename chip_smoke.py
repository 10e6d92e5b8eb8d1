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
10. print the `kernels` JSON line (launches per path), then the final `ok`
   JSON line.

Imports no JAX. Exits non-zero without printing a result when no CUDA
device is present or the port's package is not next to this script.
"""

from __future__ import annotations

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


def device_ms(torch, fn, iters: int, kernel: str = "") -> float:
    """Mean device time per call of `fn`: the CUDA kernels' own time under
    torch.profiler, summed over `iters` calls (no host time, no gaps); with
    `kernel`, only the kernels whose name contains it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        # each profiled window is its own cycle; the notice says only that
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if getattr(e, "device_type", None) == DeviceType.CUDA
             and kernel in e.key)
    check(us > 0, "the profiler recorded no device time")
    return us / iters / 1e3


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
    # library yardstick: cuDNN's LSTM on the same xp (W_ih = I, zero bias
    # computes exactly the same recurrence)
    cudnn = torch.nn.LSTM(4 * H, H, batch_first=True).to(dev)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(torch.eye(4 * H, device=dev))
        cudnn.weight_hh_l0.copy_(w_hh)
        cudnn.bias_ih_l0.zero_()
        cudnn.bias_hh_l0.zero_()
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
    cudnn = torch.nn.LSTM(4 * H, H, batch_first=True).to(dev)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(torch.eye(4 * H, device=dev))
        cudnn.weight_hh_l0.copy_(w_hh)
        cudnn.bias_ih_l0.zero_()
        cudnn.bias_hh_l0.zero_()

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
    counts = kernels.launch_counts()
    print(f"main path launches: {json.dumps(counts)}")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was never launched on the main path")

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
    counts = kernels.launch_counts()
    print(f"48 kHz path launches: {json.dumps(counts)}")
    for name, k in counts.items():
        check(k > 0, f"kernel {name} was never launched on the 48 kHz path")

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
    counts = kernels.launch_counts()
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


KERNEL_GROUPS = (("K2", "vq_rvq_kernel"), ("K1", "vq_nearest_kernel"),
                 ("K3", "lstm_scan_kernel"))


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
    """Device time of one call of `fn` by kernel group (torch.profiler),
    printed with the five largest kernels; returns ms per group. Wall time
    includes the profiler's own overhead, so the idle share is an upper
    bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    top = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us > 0:
            g = kernel_group(e.key)
            groups[g] = groups.get(g, 0.0) + us / 1e3
            top.append((us / 1e3, e.count, e.key[:60]))
    busy = sum(groups.values())
    if busy == 0:
        print(f"profile {label}: no device time recorded")
        return groups
    split = ", ".join(f"{g} {ms:.3f} ms" for g, ms in
                      sorted(groups.items(), key=lambda kv: -kv[1]))
    print(f"profile {label}: wall {wall_ms:.2f} ms (profiled), device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}; by group: "
          f"{split}")
    for ms, n, key in sorted(top, reverse=True)[:5]:
        print(f"    {ms:8.3f} ms  x{n:<4d} {key}")
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

    rows = [
        ("K1 nearest_codebook", "vq_search.cu", "vq_pallas.py:43",
         "nearest_codebook", k1),
        ("K2 rvq_encode_fused", "vq_search.cu", "vq_pallas.py:124",
         "rvq_encode_fused", k2),
        ("K3 lstm_scan", "lstm_scan.cu", "lstm_pallas.py:55", "lstm_scan", k3),
    ]
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda",
         "source": f"encodec_tpu_torch/kernels/csrc/{src}",
         "replaces": f"encodec_tpu/kernels/{rep}",
         "launches": {"24k": counts[fn], "48k": counts48[fn],
                      "stream": counts_stream[fn]}, **m}
        for n, src, rep, fn, m in rows]}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
