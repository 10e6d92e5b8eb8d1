#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero before the last line):

1. identify the card (name, power limit);
2. build every hand-written kernel from `encodec_tpu_torch/kernels/csrc`
   (one nvcc per source, in parallel);
3. hold each kernel against its plain PyTorch twin on the card at the
   24 kHz and 48 kHz main-path shapes (K1 at N=750, 1500 and 3000 rows,
   including exact duplicate rows in different CTAs' bin ranges, and at
   the first N of its row-block route, bit for bit against the cluster
   route and timed beside it; K2 at
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
   (CTAs, units, rows x k per lane, batch tile, shared memory, registers;
   no spill); B=1 and 32 with T=480 and B=1 with T=64, each from zero
   state and from a carried state, against its twin and cuDNN's LSTM, with
   the bound; one launch against a carried 64 + 64 + ... split, bit for
   bit; every row of the B=32 launch against its sequence launched alone,
   bit for bit;
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
   night) from the port's copy of the file: one night, K3 ms per layer;
13. K3's backward kernels and the saving forward per layer, from a given
   state: the grid backward (`csrc/lstm_bwd.cu`) at H=1024 with B=1 and
   32 (T=480), the cluster backward (`csrc/lstm_bwd_cluster.cu`) at H=512
   (B=4, T=750; the configs' B=8, T=1,440, two sequences per cluster) and
   H=256 (B=1, T=14,400), each with its plan (the grid's rows and columns
   per thread, partial sums' buffer and registers, no spill; the cluster's
   clusters, sequences per cluster, waves, register/shared split of W_hh's
   columns, summation order, registers and local bytes):
   the saving forward's `out` bit-equal to the plain launch's, dxp, dh0
   and dc0 within 1e-4 and dW_hh within 1e-3 of the largest |value| of the
   plain twin's `torch.autograd.grad`, and for B > 1 every sequence's
   gradients alone (at H <= 512 its saving forward too) equal to its row
   of the batch, bit for bit; device ms
   of the saving forward beside cuDNN's LSTM forward with gradients on,
   the backward kernel beside its own bound (the recurrent product), the
   plain backward, and the layer's backward (the kernel and its two
   matmuls) beside the bound of its three products and cuDNN's LSTM
   backward and forward + backward;
14. training `params/default.yaml`'s model (the port's copy, read by
   `load_config`; B=32 nights of 4 h):
   the largest batch of the config as it is that fits the card (its peak
   memory, ms per step and one profiled step by kernel group); the first
   step from a fresh state with every leaf's gradient finite and non-zero;
   then, as a stand-in for the config (its B=32 does not fit), with
   its own launch counts, `python -m encodec_tpu_torch.train`'s `main` at
   B=32 with `model.remat: true` on synthetic npz nights through
   `build_dataloaders` (epochs cut to 2 batches), 2 epochs of 2 steps
   with k-means init, eval and save; a fresh `Trainer` resuming the run
   bit for bit and stepping on; ms per step, peak memory and one profiled
   step by kernel group (idle share); one B=4 step from epoch 1's state on
   the kernels against the plain twins (codes outside tie-flagged
   positions, loss within 1e-4, gradient leaves within 1e-3); K1 at the
   training shape (N=15,360, D=256, 1024 bins: its row-block route, which
   the path must have launched) against its twin and, bit for bit, the
   cluster route, timed beside both and cdist+argmin;
15. the GAN phase of training (`params/gan.yaml`, read so: default.yaml's
   generator with the MS-STFT discriminator in 512-frame chunks), with its
   own launch counts: the largest batch of gan.yaml as written at which a
   GAN generator step and a discriminator step both fit (peak memory, ms
   per step, one profiled step of each by kernel group: cuDNN conv2d
   forward and backward, conv1d, K1, K3 forward and backward, other; idle
   share); the B=32 stand-in with `model.remat: true`; gan_disc512.yaml as
   written (B=8, the whole-signal route); `train.__main__.main` at B=32
   with remat, the discriminator from epoch 1, 2 epochs of 2 steps (at
   least one GAN step and one discriminator step), resumed bit for bit
   with the discriminator's state; a GAN step and a discriminator step at
   B=4 on the kernels against the plain twins; the chunked discriminator
   against the whole-signal forward and `disc_remat` against the plain
   route (B=2, 1 h nights);
16. six published configs never trained on the card before
   (`phase_configs`: tokens_10s, l2_weightnorm, l2, multires_disc,
   bins512_commit, disc256_bins256), each read from
   `encodec_tpu_torch/params/<name>.yaml` with PyYAML hidden (as on a
   machine without it), with its own launch counts: n_q, H, hop and T per
   night; the first step from a fresh state (B=2, k-means init) with every
   gradient leaf finite and non-zero; for l2, whose B=32 is default.yaml's
   and does not fit (phase 14), B=32 with `model.remat: true` as a
   stand-in; `python -m encodec_tpu_torch.train`'s
   `main` with `--config encodec_tpu_torch/params/<name>.yaml` (the root,
   the dataset, the cut epochs and a stand-in's options set through
   `build_dataloaders`): 2 epochs of 2 batches with the k-means init, eval
   and save, K1, K2, K3 and K3's backward launched; l2_weightnorm (the
   GAN phase from epoch 0, two whole-signal discriminators) resumed bit
   for bit in a fresh Trainer, the discriminator's state included; from
   epoch 1's state at the run's batch, ms per step (median of two) and
   peak memory, and K1 and K3 (saving forward and backward) on the inputs
   that step gave them, held against their twins and, for the shapes new
   to the table, timed beside the twins, the library and the bound; a
   generator step at B=2 on the batch's first half hour from epoch 1's
   state on the kernels against the plain twins (codes outside tie flags,
   loss within 1e-4, each gradient leaf within 1e-3 of its own largest
   |value| plus 1e-3 of the whole gradient's), for l2_weightnorm the GAN
   generator step (5e-3) and a discriminator step; then `tools.inference`
   with `--config encodec_tpu_torch/params/default.yaml` on the l2 run's
   checkpoint;
17. LM entropy coding (lmv=3) with its own launch counts: the integer LMs
   at the published widths (seeded random weights) code the 10 s 24 kHz
   request at 6 and 24 kbps in 375-token blocks and at 6 kbps unblocked,
   and the 10 s 48 kHz request at 24 kbps (11 segments), compressed on
   the card with the native range coder and decompressed on the card, the
   decode step being a CUDA graph per lane count, replayed, whose range
   decoder is the hand-written kernel `ac_head_pull` (`csrc/ac_decode.cu`,
   the LM's CDF head fused in; one launch per decode step, replays
   counted); decoded codes against the written ones, the `cc` CRC and the
   host range decoder over the card's own rows, the kernel against its
   twin on the card (each request's first 12 steps of the eager runner;
   synthetic streams at card 16 and 1024 with extreme skew, ragged lanes,
   a cut and a corrupt stream) and timed at S=2, K=32 and S=11, K=16
   beside its bound, audio against the raw path's decode, each file
   against the one the port's CPU LM writes, CUDA CDF rows against the
   CPU's; teacher-forced encode and decode times per step and per second
   of audio, the first decode's capture, per request profiled graph
   replays and eager runner steps (wall per step, device busy, launches
   per step, idle share), bytes against the raw file;
18. train an entropy prior on the port's own codes at the published LM
   width (n_q 32, card 1024, dim 200, 8 heads, 5 layers), with its own
   launch counts: 16 seeded 10 s requests encoded at 24 kbps (K2, K3), 20
   steps of `make_lm_train_step` at B=16 x T=750 (ms per step, peak
   memory, bits per code falling), the trained LM coding a 10 s request
   (lmv=3, read back and decoded on the card), `tools.export` of phase
   14's run directory, `tools.batch` over 4 wavs (one shorter than a
   chunk) and `tools.benchmark.bench` once; checks: one step on the card
   against the CPU port, `forward_batch` against `scan` and `__call__`
   within 1e-5, the card's and the CPU's decoded codes against the
   written ones and the file against the CPU writer's, the export and the
   LM's state dict reloaded bit for bit, the batch files against per-file
   compression and decompression;
19. the parallel package on torch.distributed (`phase_parallel`), with
   its own launch counts: (a) NCCL at world 1 in this process,
   default.yaml's model as written at B=16: the data-parallel generator
   step against the plain step, bit for bit, and ms per step of both; a
   one-epoch fit (3 batches) with `checkpoint.async_save: true`, its
   checkpoint against a synchronous save of the same state, bit for bit,
   the synchronous save's seconds and share of the epoch, the
   asynchronous save's blocking seconds; (b) a gloo world of 2, both
   ranks on this card (CUDA tensors staged through host memory), against
   single-process runs on the card: the DP generator step of default.yaml
   at B=8 (k-means and a second step; losses rtol 1e-4, the state at
   JAX's mesh bounds, codes outside tie flags, the ranks' states and
   generator states equal), gan.yaml's GAN generator and discriminator
   steps at B=4, the 24 kHz model's 10 s request at 24 kbps with its
   books split 512 + 512 (`rvq_encode_tp`: codes equal to K2's), the
   breathing model on a 4 h night in two time shards (`encode_sp`,
   `decode_sp`), and the published 24 kHz LM width at 4 layers in two
   pipeline stages (`lm_forward_batch_pp`, one `make_lm_pp_train_step`);
   launches and ms per rank. Two ranks on one card check correctness,
   not scaling;
20. the data×seq training step and the DAC-style RVQ
   (`phase_seq_parallel`): a gloo world of 2 on this card, data 1 x seq
   2, gan.yaml as written at B=4 on 4 h nights: a generator step with the
   k-means init, then from its state a generator, a GAN generator and a
   discriminator step, each against one process on the card (losses rtol
   1e-4, the state at JAX's mesh bounds, codes outside tie flags, the
   ranks' states equal), ms and peak memory per rank beside the single
   process's, K1, K3's saving forward and backward launched on each rank;
   `dac_rvq_forward` at the reference DAC shape on the card against the
   CPU port (codes outside float64 near-ties, latents within 1e-5). On
   one card the seq halos, gathers and sums run over gloo only (NCCL
   cannot put two ranks on one card, and a seq axis of one rank is the
   data-parallel step); `probes/seq_nccl.py` runs the same checks over
   NCCL on four cards;
21. the reduced-precision modes (`phase_precision`): (a) bf16 training
   compute (`common.compute_dtype: bfloat16`), gan.yaml's model as written
   at B=4 on 4 h nights: from a float32 state after the k-means step, a
   generator, a GAN generator and a discriminator step in bf16: finite,
   masters and Adam float32, the GAN terms within rtol 0.1 of the float32
   steps', the losses within 2e-2 of the same bf16 steps on the plain
   twins; K1, K3's saving forward and K3's backward launched, each held to
   its twin on the inputs the bf16 step gave it; (b) `set_precision` on
   the 24 kHz model, a 10 s request at 6 kbps at 'high' (TF32) and at
   'fast' (bf16 trunks): K2 and K3 (and K1 in the guarded 'high'
   encode) held to their twins on the request's inputs, the 'high' codes
   and audio to the twins' path, the `.ecdc` writer refused at 'high' and
   at 'fast', the guarded 'high' codes decoded, the TF32 flags as they
   were after every call;
22. print the `kernels` JSON line (launches per path, the grid kernel, the
   backward kernel and the range decoder in rows of their own), then the
   final `ok` JSON line.

Imports no JAX. Exits non-zero without printing a result when no CUDA
device is present or the port's package is not next to this script.
"""

from __future__ import annotations

import importlib
import io
import json
import math
import statistics
import struct
import subprocess
import sys
import time
import typing as tp
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


# The port's kernels by name, and the launch counter that counts each (a
# name stands for every kernel whose name holds it: each template's
# instantiations)
OWN_KERNELS = {"vq_nearest_kernel": "nearest_cluster",
               "vq_nearest_rowblock_kernel": "nearest_rowblock",
               "vq_rvq_kernel": "rvq_encode_fused",
               "lstm_scan_kernel": "lstm_cluster",
               "lstm_grid_kernel": "lstm_grid",
               "lstm_bwd_kernel": "lstm_bwd_grid",
               "lstm_bwd_cluster_kernel": "lstm_bwd_cluster",
               "ac_head_pull_kernel": "ac_head_pull"}
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
    c["nearest_cluster"] = c["nearest_codebook"] - c["nearest_rowblock"]
    c["lstm_bwd_grid"] = c["lstm_scan_backward"] - c["lstm_bwd_cluster"]
    return {name: c[counter] for name, counter in OWN_KERNELS.items()}


def kernel_window(torch, fn, iters: int, kernel: str = "",
                  required: bool = True) -> tp.Optional[tuple]:
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
    `PROFILE_AGREE`. Fails after `PROFILE_WINDOWS` windows, or returns None
    when not `required`."""
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
    if not required:
        return None
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


def device_or_event_ms(torch, fn, iters: int, kernel: str = "") -> tuple:
    """`device_ms`, or, when no two profiler windows agree (late in a long
    process the profiler loses records: PERF.md §7), the CUDA-event time
    per call of `iters` back-to-back calls (`time_ms`: device time where
    the host keeps ahead, else the host's cost). Returns (ms, method)."""
    window = kernel_window(torch, fn, iters, kernel, required=False)
    if window is not None:
        return sum(us for _, us in window[0].values()) / iters / 1e3, \
            "profiler"
    return time_ms(torch, fn, iters), "CUDA events"


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


def k1_plan_text(plan) -> str:
    return (f"{plan.route} route, {plan.row_tiles} blocks of {plan.rows} "
            f"rows x cluster {plan.cluster} = {plan.ctas} CTAs, "
            f"{plan.bins_per_cta} bins/CTA, {plan.smem_bytes} B shared "
            "memory/CTA")


def k1_against_cluster_route(torch, kernels, x, e, label: str) -> None:
    """K1 as its plan launches it against the cluster route forced on the
    same inputs: indices, margins and scores equal bit for bit."""
    got = kernels.nearest_codebook(x, e, return_score=True)
    want = kernels.nearest_codebook(x, e, return_score=True,
                                    _route="cluster")
    torch.cuda.synchronize()
    diff = [int((g != w).sum()) for g, w in zip(got, want)]
    check(not any(diff), f"{label}: idx, margin, score differ from the "
                         f"cluster route's at {diff} rows")


def k1_crossover(vq_cuda, bins: int, D: int, sms: int) -> int:
    """The smallest N that `nearest_plan` sends to the row-block route."""
    lo, hi = 1, 1 << 22
    while lo < hi:
        mid = (lo + hi) // 2
        if vq_cuda.nearest_plan(mid, bins, D, sms).route == "rowblock":
            hi = mid
        else:
            lo = mid + 1
    return lo


def phase_k1(torch, kernels, dev):
    """K1 at N=750 (one RVQ stage of a 10 s 24 kHz request, the main path's
    shape), N=1500 (a 10 s 48 kHz request: 10 segments of 150 frames),
    N=3000, and at the first N of the row-block route (4,225 on 132 SMs),
    where it is also held bit for bit against the cluster route and timed
    beside it; the JSON row is N=750."""
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
    for N in (750, 1500, 4 * 750, k1_crossover(vq_cuda, bins, D, sms)):
        plan = vq_cuda.nearest_plan(N, bins, D, sms)
        x = gauss(torch, (N, D), 10, dev, 0.3)
        idx, margin = kernels.nearest_codebook(x, e)
        ref_idx, ref_margin, ref_score = kernels.nearest_codebook_plain(
            x, e, return_score=True)
        s_idx, s_margin, score = kernels.nearest_codebook(x, e,
                                                          return_score=True)
        xd = (e_dup[dups[0]][None] + gauss(torch, (N, D), 12, dev, 1e-3))
        d_idx, d_margin = kernels.nearest_codebook(xd.contiguous(), e_dup)
        torch.cuda.synchronize()
        safe = ref_margin >= 1e-5
        n_bad = int((idx[safe] != ref_idx[safe]).sum())
        err = float((margin - ref_margin).abs().max())
        check(n_bad == 0, f"K1 N={N}: {n_bad} indices differ at plain "
                          "margin >= 1e-5")
        check(err <= 1e-4, f"K1 N={N}: margin max|d| {err} > 1e-4")
        score_err = float((score - ref_score).abs().max())
        check(bool(torch.equal(s_idx, idx)) and bool(torch.equal(s_margin,
                                                                  margin)),
              f"K1 N={N}: the score output changed the index or margin")
        check(score_err <= 1e-4, f"K1 N={N}: score max|d| {score_err} > 1e-4")
        check(bool((d_idx == min(dups)).all()) and bool((d_margin == 0).all()),
              f"K1 N={N}: duplicate rows across CTAs do not give the lowest "
              "index with margin 0")
        vs_cluster = ""
        if plan.route == "rowblock":
            k1_against_cluster_route(torch, kernels, x, e, f"K1 N={N}")
            cl_ms = device_ms(torch, lambda: kernels.nearest_codebook(
                x, e, _route="cluster"), 50)
            vs_cluster = (f"; idx, margin, score equal the cluster route's "
                          f"bit for bit, whose device ms={cl_ms:.4f}")
        ms = device_ms(torch, lambda: kernels.nearest_codebook(x, e), 50)
        call_ms = time_ms(torch, lambda: kernels.nearest_codebook(x, e), 50)
        plain_ms = device_ms(
            torch, lambda: kernels.nearest_codebook_plain(x, e), 20)
        lib_ms = device_ms(torch, lambda: torch.cdist(x, e).argmin(1), 20)
        b_ms, b_by = bound(2.0 * N * bins * D, (N * D + bins * D + 2 * N) * 4)
        print(f"K1 nearest_codebook N={N} D={D} bins={bins}: plan "
              f"{k1_plan_text(plan)}; idx equal (margin>=1e-5), "
              f"margin max|d|={err:.3g}, winner score max|d|={score_err:.3g} "
              "(idx and margin unchanged with it), "
              f"duplicates {dups} -> {min(dups)}, "
              f"margin 0; device ms: kernel={ms:.4f} plain={plain_ms:.4f} "
              f"library(cdist+argmin)={lib_ms:.4f} bound={b_ms:.5f} ({b_by}); "
              f"per wrapper call (events)={call_ms:.4f}{vs_cluster}")
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
            12000: ((32, False),),           # phase_lm_train's 16 x 10 s
            256: ((8, False),),              # the batch tool's chunk
            7: ((8, False), (32, False)),    # a stream's first chunk
            6: ((8, False), (32, False))}    # and each 80 ms chunk after it


def phase_k2(torch, kernels, dev):
    """K2 at N=750 (every stage of a 10 s 24 kHz request, the main path's
    shape) and N=3000 (a 40 s request, or 4 x 10 s), n_q = 8, 32, and 8
    with one shared book, at N=1500, n_q=16 (a 10 s 48 kHz request at
    24 kbps), at N=12,000, n_q=32 (phase_lm_train's 16 x 10 s training
    codes, one batch), at N=256, n_q=8 (the batch tool's 256-hop chunk at
    6 kbps), and at N=7 and 6 (a streamed chunk's frames) for n_q 8 and
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
    plans = {seqs: lstm_cuda.lstm_plan(B, H, n_max)
             for seqs, B in ((1, 1), (2, n_max + 1))}
    attrs, local_b = {}, {}
    for seqs, plan in plans.items():
        check(plan.seqs_per_cluster == seqs
              and lib.lstm_scan_smem_bytes(H, seqs) == plan.smem_bytes,
              "K3 shared memory differs between the kernel and its plan")
        for state in (0, 1, 2):
            regs, local = ctypes.c_int(), ctypes.c_int()
            build.check(lib, "lstm_scan", lib.lstm_scan_attributes(
                H, state, seqs, ctypes.addressof(regs),
                ctypes.addressof(local)))
            attrs[state, seqs] = f"{regs.value} / {local.value} B"
            local_b[state, seqs] = local.value
    # two sequences per cluster must not spill more than one does
    for state in (0, 1, 2):
        check(local_b[state, 2] <= local_b[state, 1],
              f"K3 H={H} (state variant {state}): two sequences per cluster "
              f"take {local_b[state, 2]} B of local memory, one "
              f"{local_b[state, 1]} B")
    p1, p2 = plans[1], plans[2]
    return (f"K3 plan H={H}: clusters of {p1.cluster} CTAs x "
            f"{p1.units_per_cta} units, max active clusters {n_max}, one "
            f"sequence per cluster up to {n_max}, two above where cheaper "
            f"({p2.n_clusters} clusters at B={p2.B}, {p2.waves} wave), "
            f"{lstm_cuda.K3_THREADS} threads/CTA; registers/thread / local "
            f"bytes, one / two sequences per cluster: zero state "
            f"{attrs[0, 1]} / {attrs[0, 2]}, from a state {attrs[1, 1]} / "
            f"{attrs[1, 2]}, saving every c (training) {attrs[2, 1]} / "
            f"{attrs[2, 2]}; {p1.smem_bytes} / {p2.smem_bytes} B shared "
            f"memory/CTA; W_hh rows per CTA: {p1.reg_rows} in registers, "
            f"{p1.smem_rows} in shared memory")


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
    so some clusters run a second pass), B=1, T=15 (its 0.1 s tail) and
    B=16, T=750 (phase_lm_train's training codes, one batch). The JSON row
    is B=1, T=750."""
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
    for B, T in ((1, 750), (4, 750), (10, 150), (1, 15), (16, 750)):
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
    80 ms chunk of a stream and its 7-hop first chunk), B=1, T=256 (the
    batch tool's extractor chunk) and B=10, T=150 (distinct state rows;
    two waves of clusters), against the twin and
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

    for B, T in ((1, 6), (1, 7), (1, 256), (10, 150)):
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
    # serving runs no backward kernel, a raw .ecdc no range decoder, and
    # its searches are too small for K1's row-block route
    for name, n in counts.items():
        check(n > 0 or name in ("lstm_grid", "lstm_scan_backward",
                                "lstm_bwd_cluster", "ac_head_pull",
                                "nearest_rowblock"),
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
        check(k > 0 or name in ("lstm_grid", "lstm_scan_backward",
                                "lstm_bwd_cluster", "ac_head_pull",
                                "nearest_rowblock"),
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
    attrs = []
    for save in (0, 1):
        for fenced in (0, 1):
            regs, local = ctypes.c_int(), ctypes.c_int()
            build.check(lib, "lstm_grid", lib.lstm_grid_attributes(
                save, fenced, ctypes.addressof(regs), ctypes.addressof(local)))
            check(local.value == 0, f"K3 grid kernel (save={save}, fenced="
                                    f"{fenced}) spills {local.value} B")
            attrs.append(f"{regs.value} registers/thread ({local.value} B "
                         "local)")
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
            f"{lstm_cuda.GRID_THREADS} threads/CTA as "
            f"{lstm_cuda.GRID_ROW_GROUPS} row groups x {p.k_slices} k slices "
            f"of {lstm_cuda.GRID_K_SLICE}, {lstm_cuda.GRID_LANE_ROWS} rows x "
            f"{lstm_cuda.GRID_LANE_K} k per lane, batch tile "
            f"{lstm_cuda.GRID_BATCH_TILE} (a lone last sequence alone), "
            f"polling / barrier per step (B >= 10): plain {attrs[0]} / "
            f"{attrs[1]}, saving every c {attrs[2]} / {attrs[3]}, shared memory "
            f"{p.smem_bytes} B/CTA at B=1 and {plans[32].smem_bytes} at B=32 "
            f"({plans[32].n_launches} launch), at most "
            f"{lstm_cuda.grid_max_batch(H)} sequences per launch")


# The cluster backward's local memory per thread (its stack frame, spills
# included) with one / two sequences per cluster, the most of any H: what
# H=512 took on the H100 (255 registers; ptxas: 28 / 4 B spill stores).
BWD_CLUSTER_LOCAL_BYTES = {1: 32, 2: 8}


def k3_bwd_plan_line(torch, dev, B, H):
    """The backward's plan at (B, H) by its route, its registers (the grid
    backward must not spill, the cluster backward no more than it did when
    measured) and its shared memory against the kernel's, and the launches
    one call makes."""
    import ctypes

    from encodec_tpu_torch.kernels import build, lstm_cuda

    if lstm_cuda.bwd_route(H) == "cluster":
        lib = build.load_library("lstm_bwd_cluster")
        n_max = lstm_cuda.max_bwd_clusters(H, dev)
        plan = lstm_cuda.bwd_cluster_plan(B, H, n_max)
        attrs = []
        for seqs in (1, 2):
            regs, local = ctypes.c_int(), ctypes.c_int()
            build.check(lib, "lstm_bwd_cluster",
                        lib.lstm_bwd_cluster_attributes(
                            H, seqs, ctypes.addressof(regs),
                            ctypes.addressof(local)))
            check(local.value <= BWD_CLUSTER_LOCAL_BYTES[seqs],
                  f"K3 cluster backward H={H}, {seqs} sequence(s) per "
                  f"cluster: {local.value} B of local memory, more than the "
                  f"{BWD_CLUSTER_LOCAL_BYTES[seqs]} B measured at H=512")
            attrs.append(f"{regs.value} registers/thread ({local.value} B "
                         f"local)")
        check(lib.lstm_bwd_cluster_smem_bytes(H, plan.seqs_per_cluster)
              == plan.smem_bytes, "K3 cluster backward shared memory "
                                  "differs between the kernel and its plan")
        return plan, 1, (
            f"cluster backward plan: {plan.n_clusters} clusters (max active "
            f"{n_max}) of {plan.cluster} CTAs x {plan.units_per_cta} units, "
            f"{plan.seqs_per_cluster} sequence(s) per cluster, "
            f"{plan.waves} wave(s), W_hh columns per CTA {plan.reg_rows} in "
            f"registers / {plan.smem_rows} in shared memory, "
            f"{plan.smem_bytes} B shared memory/CTA, dh summed as "
            f"{plan.sum_order()}, one / two sequences per cluster "
            f"{attrs[0]} / {attrs[1]}, 1 launch")
    lib = build.load_library("lstm_bwd")
    plan = lstm_cuda.bwd_plan(B, H, lstm_cuda.max_bwd_ctas(H, dev))
    regs, local = ctypes.c_int(), ctypes.c_int()
    build.check(lib, "lstm_bwd", lib.lstm_bwd_attributes(
        plan.units_per_cta, ctypes.addressof(regs), ctypes.addressof(local)))
    check(local.value == 0, f"K3 backward kernel (U={plan.units_per_cta}) "
                            f"spills {local.value} B to local memory")
    check(lib.lstm_bwd_smem_bytes(plan.batch_per_launch, plan.ctas,
                                  plan.units_per_cta) == plan.smem_bytes,
          "K3 backward shared memory differs between the kernel and its plan")
    return plan, plan.n_launches, (
        f"grid backward plan: {plan.ctas} CTAs x {plan.units_per_cta} units "
        f"({4 * plan.units_per_cta} W_hh rows x {lstm_cuda.BWD_COLS} columns "
        f"per thread), product batch tile {lstm_cuda.BWD_BATCH_TILE}, "
        f"{plan.n_launches} launch, {plan.smem_bytes} B shared memory/CTA, "
        f"partial sums {plan.partial_bytes} B (each CTA's block read "
        f"whole, {plan.ctas} sources per unit in {len(plan.sum_chains())} "
        f"chains, {'16 threads' if plan.spread() else 'one thread'} a "
        f"cell), {regs.value} registers/thread ({local.value} B local)")


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
        # the yardsticks fall back to CUDA events where no two profiler
        # windows agree (late in a long process the profiler loses
        # records); the kernel's own time does not
        gemm_ms = device_or_event_ms(torch, lambda: proj @ eye, 5)[0]
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
            plain_ms = device_or_event_ms(torch, lambda: kernels.
                                          lstm_scan_plain(
                                              xp, w_hh, *st,
                                              return_state=True), 2)[0]
            lib_state = (h0[None], c0[None]) if stateful else None
            with torch.no_grad():
                lib_err = float((cudnn(xp, lib_state)[0] - out).abs().max())
                lib_ms = device_or_event_ms(
                    torch, lambda: cudnn(xp, lib_state), 5)[0]
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
        if B == 32:
            # a sequence's bits do not depend on its slot or on B
            for b in range(B):
                one = slice(b, b + 1)
                alone, _, c1 = kernels.lstm_scan(xp[one], w_hh, h0[one],
                                                 c0[one], return_state=True)
                check(torch.equal(alone, whole[one])
                      and torch.equal(c1, cT[one]),
                      f"K3 grid: sequence {b} alone differs from row {b} of "
                      "the B=32 launch")
            print(f"K3 grid B={B} T={T} H={H}: row b of the B=32 launch == "
                  "the B=1 launch of sequence b, bit for bit (out, cT), "
                  "for every b")
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
    `model_from_config` from `encodec_tpu_torch/params/hires_tokens.yaml`
    (`load_config`): one night encoded and decoded, K3's device ms per
    layer, and the layer alone against its twin (which steps 14,400 times
    from Python: one call, timed by CUDA events). Counted as its own
    path."""
    from encodec_tpu_torch.train import load_config, model_from_config

    model = model_from_config(load_config(config_path("hires_tokens")),
                              device=dev)
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
    # the twin steps 14,400 times from Python: one call, timed by CUDA
    # events, serves the check and the row
    plain_out, plain_ms = run_once(torch,
                                   lambda: kernels.lstm_scan_plain(xp, w_hh))
    how_p = "CUDA events, one call"
    err = float((kernels.lstm_scan(xp, w_hh) - plain_out).abs().max())
    check(err <= 1e-4, f"K3 B=1 T={T} H={H}: max|d| {err} > 1e-4")
    del plain_out
    # 18.7 ms launches: the profiler drops such records late in a process
    ms, how = device_or_event_ms(torch, lambda: kernels.lstm_scan(xp, w_hh), 3)
    with torch.no_grad():
        lib_ms, how_l = device_or_event_ms(torch, lambda: cudnn(xp), 2)
    b_ms, b_by = bound(2.0 * T * H * 4 * H, (T * 4 * H + 4 * H * H + T * H) * 4)
    print(f"K3 lstm_scan B=1 T={T} H={H} (hires_tokens, gaussian inputs): "
          f"max|d| vs plain {err:.3g}; per layer device ms: kernel={ms:.4f} "
          f"({ms / T * 1e3:.3f} us/step) plain={plain_ms:.4f} library(cuDNN "
          f"LSTM)={lib_ms:.4f} bound={b_ms:.5f} ({b_by}); timed by {how} / "
          f"{how_p} / {how_l}")
    return counts


def phase_k3_bwd(torch, kernels, dev):
    """K3's backward kernels and the saving forward per layer, from a given
    (h0, c0): the grid backward (`csrc/lstm_bwd.cu`) at H=1024, B=1 and
    B=32 with T=480 (a 4 h night of the breathing model; the training
    batch of 32 nights); the cluster backward (`csrc/lstm_bwd_cluster.cu`)
    at H=512, B=4, T=750, at the configs' B=8, T=1,440 (tokens_10s: two
    sequences per cluster, one wave) and at H=256, B=1, T=14,400
    (hires_tokens). The saving
    forward must give the plain launch's `out` bits; dxp, dh0 and dc0 must
    be within 1e-4 of the largest |value| of the plain twin's
    `torch.autograd.grad`, dW_hh within 1e-3 (a sum over B·T rows in
    another order); for every B > 1 each sequence's backward alone must
    give its row's bits, and at H <= 512 its saving forward alone too
    (`out` and every c). Device ms (torch.profiler, or CUDA events where no two
    windows agree): the saving forward, the backward kernel, its two
    matmuls (pre-activations and dW_hh), the plain twin's backward; by CUDA
    events: cuDNN's LSTM forward with gradients on (beside the saving
    forward) and forward + backward at the same shape (the yardsticks).
    The kernel's bound counts its own work: the recurrent product
    (2·B·T·4H·H FLOPs) and the bytes of pre, c, dy, dgates, W_hh, c0, dh0
    and dc0. The layer's backward (the kernel and its two matmuls)
    is bounded apart, by the three products and the bytes of xp, h, c, dy,
    W_hh, dxp and dW_hh, and held against cuDNN's backward, which also
    computes dx and dW_ih. No library call computes the kernel's function
    alone, so its rows have no `library_ms`. Returns the JSON rows of the
    grid backward (H=1024, B=32, T=480) and of the cluster backward (H=512,
    B=8, T=1,440)."""
    from encodec_tpu_torch.kernels import lstm_cuda
    from encodec_tpu_torch.ops.lstm import LstmLayer

    rows = {}
    for B, T, H in ((1, 480, 1024), (32, 480, 1024), (4, 750, 512),
                    (8, 1440, 512), (1, 14_400, 256)):
        t_shape = time.perf_counter()
        plan, n_launch, plan_text = k3_bwd_plan_line(torch, dev, B, H)
        w_hh = books(torch, (4 * H, H), 61, dev) / math.sqrt(6.0)  # ±1/√H
        xp = gauss(torch, (B, T, 4 * H), 62, dev, 1.0)
        h0 = torch.tanh(gauss(torch, (B, H), 63, dev, 1.0))
        c0 = gauss(torch, (B, H), 64, dev, 1.0)
        dy = gauss(torch, (B, T, H), 65, dev, 1.0)
        # the saving forward: the plain launch's bits, and every step's c
        before = kernels.lstm_scan.save_launches
        out, c_seq = kernels.lstm_scan(xp, w_hh, h0, c0, save_c=True)
        plain_launch = kernels.lstm_scan(xp, w_hh, h0, c0)
        torch.cuda.synchronize()
        check(kernels.lstm_scan.save_launches > before
              and torch.equal(out, plain_launch),
              f"K3 saving forward B={B} T={T} H={H}: out differs from the "
              "plain launch's bits")
        # the gradient through the autograd route, against the twin's
        leaves = [t.clone().requires_grad_(True) for t in (xp, w_hh, h0, c0)]
        before = kernels.lstm_scan_backward.launches
        y, _ = LstmLayer.apply(*leaves, False)
        got = torch.autograd.grad(y, leaves, dy)
        check(kernels.lstm_scan_backward.launches == before + n_launch,
              f"K3 backward B={B} T={T} H={H} did not launch its plan")
        ref_leaves = [t.clone().requires_grad_(True)
                      for t in (xp, w_hh, h0, c0)]
        want = torch.autograd.grad(kernels.lstm_scan_plain(*ref_leaves),
                                   ref_leaves, dy)
        torch.cuda.synchronize()
        errs = {}
        abs_err = float((got[0] - want[0]).abs().max())
        for name, g, r, tol in zip(("dxp", "dW_hh", "dh0", "dc0"), got, want,
                                   (1e-4, 1e-3, 1e-4, 1e-4)):
            errs[name] = float((g - r).abs().max()) / float(r.abs().max())
            check(bool(torch.isfinite(g).all()) and errs[name] <= tol,
                  f"K3 backward B={B} T={T} H={H}: {name} max|d| "
                  f"{errs[name]:.3g} of its largest |value| > {tol}")
        del got, want, y, leaves, ref_leaves
        # the pieces of the layer's backward, timed alone
        h_prev = torch.cat([h0[:, None], out[:, :-1]], 1)
        pre = torch.addmm(xp.reshape(B * T, 4 * H), h_prev.reshape(B * T, H),
                          w_hh.t()).reshape(B, T, 4 * H)
        dgates, dh0, dc0 = kernels.lstm_scan_backward(pre, c_seq, dy, w_hh,
                                                      c0)
        slot_note = ""
        if B > 1:
            # a sequence's bits do not depend on its slot or on B (at H <=
            # 512 B=8 runs two sequences per cluster, B=1 one)
            cluster = lstm_cuda.bwd_route(H) == "cluster"
            for b in range(B):
                one = slice(b, b + 1)
                alone = kernels.lstm_scan_backward(pre[one], c_seq[one],
                                                   dy[one], w_hh, c0[one])
                check(all(torch.equal(a, r[one]) for a, r in
                          zip(alone, (dgates, dh0, dc0))),
                      f"K3 backward: sequence {b} alone differs from row {b} "
                      f"of the B={B} launch")
                if cluster:
                    fwd = kernels.lstm_scan(xp[one], w_hh, h0[one], c0[one],
                                            save_c=True)
                    check(torch.equal(fwd[0], out[one])
                          and torch.equal(fwd[1], c_seq[one]),
                          f"K3 saving forward: sequence {b} alone differs "
                          f"from row {b} of the B={B} launch")
            slot_note = (f"; row b of the B={B} backward == the B=1 backward "
                         "of sequence b, bit for bit (dgates, dh0, dc0)"
                         + (", and of the saving forward (out, every c)"
                            if cluster else "") + ", for every b")
        timed = {}
        timed["fwd"] = device_or_event_ms(torch, lambda: kernels.lstm_scan(
            xp, w_hh, h0, c0, save_c=True), 3, "lstm_")
        timed["bwd"] = device_or_event_ms(
            torch, lambda: kernels.lstm_scan_backward(pre, c_seq, dy, w_hh,
                                                      c0), 3, "lstm_bwd")
        timed["mm"] = device_or_event_ms(torch, lambda: (
            torch.addmm(xp.reshape(B * T, 4 * H), h_prev.reshape(B * T, H),
                        w_hh.t()),
            dgates.reshape(B * T, 4 * H).t() @ h_prev.reshape(B * T, H)), 3)
        # the twin launches 25 or so small kernels per step: over
        # hires_tokens' 14,400 steps CUDA events time one call, unwarmed
        def plain():
            kernels.lstm_scan_backward_plain(pre, c_seq, dy, w_hh, c0)

        timed["plain"] = (device_or_event_ms(torch, plain, 1) if T <= 750
                          else (run_once(torch, plain)[1],
                                "CUDA events, one call"))
        cudnn = lstm_yardstick(torch, w_hh, dev)
        x_req = xp.clone().requires_grad_(True)
        lib_out = cudnn(x_req, (h0[None], c0[None]))[0]
        lib_params = [x_req, *cudnn.parameters()]
        # cuDNN's LSTM launches kernels per step: a profiler window of it
        # at T=14,400 takes minutes to read, so CUDA events time it
        timed["lib_bwd"] = (time_ms(torch, lambda: torch.autograd.grad(
            lib_out, lib_params, dy, retain_graph=True), 3), "CUDA events")
        timed["lib"] = (time_ms(torch, lambda: torch.autograd.grad(
            cudnn(x_req, (h0[None], c0[None]))[0], lib_params, dy), 3),
            "CUDA events")
        # cuDNN's forward with gradients on (it keeps its reserve for the
        # backward), beside the saving launch
        timed["lib_fwd"] = (time_ms(torch, lambda: cudnn(
            x_req, (h0[None], c0[None]))[0], 3), "CUDA events")
        fwd_ms, ms, mm_ms, lib_bwd_ms, lib_ms, lib_fwd_ms = (
            timed[k][0] for k in ("fwd", "bwd", "mm", "lib_bwd", "lib",
                                  "lib_fwd"))
        plain_ms = timed["plain"][0]
        events = sorted(k for k, (_, how) in timed.items()
                        if how != "profiler"
                        and k not in ("lib", "lib_bwd", "lib_fwd"))
        del lib_out, x_req, lib_params, cudnn
        # the kernel: the recurrent product; pre, c, dy, W_hh and c0 in,
        # dgates, dh0 and dc0 out
        b_ms, b_by = bound(2.0 * B * T * 4 * H * H,
                           (2 * B * T * 4 * H + 2 * B * T * H + 4 * H * H
                            + 3 * B * H) * 4)
        # the layer's backward: the kernel and its two matmuls; xp, h, c,
        # dy and W_hh in, dxp and dW_hh out
        layer_ms, layer_by = bound(3 * 2.0 * B * T * 4 * H * H,
                                   (2 * B * T * 4 * H + 3 * B * T * H
                                    + 2 * 4 * H * H) * 4)
        print(f"K3 backward B={B} T={T} H={H} from (h0, c0): {plan_text}; "
              f"saving forward out == plain launch bit for bit; vs the "
              f"twin's autograd: "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f" of the largest |value|{slot_note}; per layer device ms: "
              f"saving forward={fwd_ms:.4f} (cuDNN LSTM forward with "
              f"gradients on, CUDA events: {lib_fwd_ms:.4f}) backward "
              f"kernel={ms:.4f} "
              f"({ms / T * 1e3:.3f} us/step, bound={b_ms:.5f} ({b_by}): "
              f"the recurrent product) plain backward={plain_ms:.4f}"
              f"; the layer's backward: kernel + its two matmuls="
              f"{ms + mm_ms:.4f} (matmuls {mm_ms:.4f}), bound={layer_ms:.5f} "
              f"({layer_by}: three products), cuDNN LSTM backward (also dx "
              f"and dW_ih, CUDA events)={lib_bwd_ms:.4f}, cuDNN fwd+bwd="
              f"{lib_ms:.4f}"
              + (f"; by CUDA events (no two profiler windows agreed): "
                 f"{', '.join(events)}" if events else "")
              + f" [{time.perf_counter() - t_shape:.1f} s]")
        rows[B, T, H] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                             bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=abs_err)
        del xp, out, c_seq, plain_launch, pre, dgates, dh0, dc0, h_prev, dy
        torch.cuda.empty_cache()
    return rows[32, 480, 1024], rows[8, 1440, 512]


TRAIN_NIGHT = 4 * 36_000 + 600   # a 4 h crop with room to move
PARAMS = Path(__file__).resolve().parent / "encodec_tpu_torch" / "params"


def config_path(name: str) -> str:
    """`encodec_tpu_torch/params/<name>.yaml`, relative to the working
    directory when the checkout is it (as a user passes it)."""
    path = PARAMS / f"{name}.yaml"
    try:
        return str(path.relative_to(Path.cwd()))
    except ValueError:
        return str(path)


def published_config(name: str, root: str) -> dict:
    """`encodec_tpu_torch/params/<name>.yaml` as written (`load_config`,
    with or without PyYAML), on synthetic nights under `root`, logging and
    saving every epoch, in one process (`distributed.data_parallel` off:
    eval keeps its last short batch; `cut_epochs` cuts the virtual
    epochs)."""
    from encodec_tpu_torch.train import config_to_dict, load_config

    cfg = config_to_dict(load_config(config_path(name)))
    cfg["common"]["log_interval"] = 1
    cfg["checkpoint"]["save_every"] = 1
    cfg["dataset"].update(root=root, datasets={"synth": 1.0})
    cfg["distributed"] = {"data_parallel": False}
    return cfg


def train_config(root: str) -> dict:
    """default.yaml (`published_config`)."""
    return published_config("default", root)


TRAIN_ITEMS, VAL_ITEMS = 64, 19   # 2 training batches of 32, one for eval


def cut_epochs(build):
    """`build_dataloaders` with its virtual epochs cut to `TRAIN_ITEMS`
    training and `VAL_ITEMS` validation crops."""
    def cut(config, *shard):
        train, val, mapping = build(config, *shard)
        train.dataset.size, val.dataset.size = TRAIN_ITEMS, VAL_ITEMS
        return train, val, mapping
    return cut


def train_group(name: str) -> str:
    """Kernel groups of a training step."""
    for group, key in (("K3 backward", "lstm_bwd_kernel"),
                       ("K3 backward", "lstm_bwd_cluster_kernel"),
                       ("K3 forward", "lstm_grid_kernel"),
                       ("K3 forward", "lstm_scan_kernel"),
                       ("K1", "vq_nearest_kernel"),
                       ("K1", "vq_nearest_rowblock_kernel"),
                       ("K2", "vq_rvq_kernel")):
        if key in name:
            return group
    low = name.lower()
    if any(k in low for k in ("conv", "cudnn", "xmma", "implicit", "fprop",
                              "dgrad", "wgrad")):
        back = any(k in low for k in ("dgrad", "wgrad", "bwd", "backward"))
        return "cuDNN conv backward" if back else "cuDNN conv forward"
    return "other"


def states_equal(torch, a, b) -> bool:
    """Two train states equal bit for bit: params, Adam, quantizer and
    generator state, and a GAN run's discriminator, its Adam state and the
    balancer's EMA state."""
    from encodec_tpu_torch.train.optim import tree_leaves

    def trees(s):
        out = (s.params, s.opt_state.mu, s.opt_state.nu, s.opt_state.count,
               s.disc_params, s.balancer_state)
        if s.disc_opt_state is not None:
            out += tuple(s.disc_opt_state)
        return out

    if (a.disc_params is None) != (b.disc_params is None) or (
            a.balancer_state is None) != (b.balancer_state is None):
        return False
    la = [x for x in tree_leaves(trees(a)) if x is not None]
    lb = [x for x in tree_leaves(trees(b)) if x is not None]
    pairs = list(zip(la, lb)) + list(zip(a.qstate[:3], b.qstate[:3]))
    pairs.append((a.rng, b.rng))
    return (a.qstate.inited == b.qstate.inited and len(la) == len(lb)
            and all(torch.equal(x.cpu(), y.cpu()) for x, y in pairs))


def codes_off_ties(torch, mk: dict, mp: dict) -> tuple:
    """Two training steps' codes ([B, K, T']) held stage by stage. The
    stages share one book, which each stage's EMA update and dead-code
    expiry change before the next searches it: so at the first stage
    where any position's code differs, each difference must be tie-flagged
    (margin < `TIE_THRESHOLD`, [K, B·T'], in either step), and the stages
    after it search another book and are not compared. Returns
    (positions, positions differing, that first stage or None, positions
    tie-flagged at some stage, positions off outside the guard)."""
    K = mk["codes"].shape[1]
    diff = (mk["codes"] != mp["codes"]).transpose(0, 1).reshape(K, -1)
    tied = torch.minimum(mk["margins"], mp["margins"]) < TIE_THRESHOLD
    stages = [k for k in range(K) if bool(diff[k].any())]
    first = stages[0] if stages else None
    off = 0 if first is None else int((diff[first] & ~tied[first]).sum())
    return (diff.shape[1], int(diff.any(0).sum()), first,
            int(tied.any(0).sum()), off)


def codes_line(counts: tuple) -> str:
    n, differ, first, flagged, off = counts
    where = ("" if first is None else
             f", first at stage {first}, where {off} are outside the tie "
             "guard (the stages after it search another book)")
    return (f"{differ} of {n} positions' codes differ{where} ({flagged} "
            "positions tie-flagged at some stage)")


def one_window(torch, fn) -> tuple:
    """Device records of one call of `fn` (after a warm-up call) under
    torch.profiler, and the call's wall ms: {kernel: (launches, µs)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    records: dict = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            n, us = records.get(e.key, (0, 0.0))
            records[e.key] = (n + e.count, us + e.self_device_time_total)
    return records, wall_ms


def profile_step(torch, label: str, fn):
    """One profiled training step (`fn`) by kernel group: device busy time
    and idle share, then its six longest kernels."""
    window = kernel_window(torch, fn, 1, required=False)
    note = ""
    if window is None:   # one window, not held against a second one
        window = one_window(torch, fn)
        note = " (one profiler window: no two agreed)"
    records, wall_ms = window
    groups: dict = {}
    for key, (_, us) in records.items():
        g = train_group(key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
    busy = sum(groups.values())
    print(f"profile train step {label}{note}: wall {wall_ms:.1f} ms "
          f"(profiled), device busy {busy:.1f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}; by group: "
          + ", ".join(f"{g} {ms:.2f} ms" for g, ms in
                      sorted(groups.items(), key=lambda kv: -kv[1])))
    for ms, n, key in sorted(((us / 1e3, n, key[:70]) for key, (n, us)
                              in records.items()), reverse=True)[:6]:
        print(f"    {ms:9.3f} ms  x{round(n):<4d} {key}")


def phase_train(torch, kernels, dev):
    """Training default.yaml's model (the breathing tokenizer, H=1024, D=256,
    8 stages of one shared book of 1024, 32 nights of 4 h per batch) on
    the card. First the config as it is: the largest batch of 32, 24, 16,
    12 and 8 nights whose step fits the card, its peak memory, ms per step
    and one profiled step by kernel group (idle share); the first step
    from a fresh state (B=4) with every leaf's gradient finite and
    non-zero. default.yaml's own batch of 32 does not fit the card, so the
    B=32 runs that follow are a stand-in that departs from the config:
    they add `model.remat: true` (the JAX package's memory option: each
    SEANet stage recomputed in the backward, the same arithmetic).
    Counted as one path, `python -m encodec_tpu_torch.train`'s `main` on
    that JSON config over synthetic npz nights (through
    `build_dataloaders`, its epochs cut by `cut_epochs`) at B=32: 2 epochs
    of 2 steps with the k-means init, eval and save each epoch. Then: a
    fresh Trainer resumes the run directory bit for bit and steps on; ms
    per step at B=32 and the peak memory; one profiled step by kernel
    group; one step (B=4) from the state after epoch 1 on the kernels
    against the plain twins; K1 at the training shape (N=15,360, D=256,
    1024 bins: the row-block route), held against its twin and bit for bit
    against the cluster route, timed beside both, `cdist`+`argmin` and the
    bound: the `kernels` line's training row."""
    import tempfile

    from encodec_tpu_torch.train import (ConfigNamespace, Trainer,
                                         load_checkpoint, make_train_steps)
    from encodec_tpu_torch.train import __main__ as train_entry
    from encodec_tpu_torch.train.optim import tree_leaves
    from encodec_tpu_torch.train.trainer import state_to_device

    tmp = tempfile.TemporaryDirectory()
    base = Path(tmp.name)
    for c, chan in enumerate(("thorax", "abdominal")):
        (base / "data" / "synth" / chan).mkdir(parents=True)
        for i in range(8):
            np.savez(base / "data" / "synth" / chan / f"night{i}.npz",
                     data=breathing_signal(TRAIN_NIGHT, 1000 + 10 * i + c),
                     fs=10)
    cfg = train_config(str(base / "data"))
    config = ConfigNamespace(cfg)
    cfg_fit = json.loads(json.dumps(cfg))
    cfg_fit["model"]["remat"] = True
    cfg_path = base / "default_remat.json"
    cfg_path.write_text(json.dumps(cfg_fit))
    config_fit = ConfigNamespace(cfg_fit)
    run = base / "run"

    # -- the first step from a fresh state (B=4): k-means, every gradient
    t0 = time.perf_counter()
    loader, _, _ = cut_epochs(train_entry.build_dataloaders)(config)
    x32 = torch.from_numpy(next(iter(loader))[0]["x"]).to(dev)
    batch_s = time.perf_counter() - t0
    check(tuple(x32.shape) == (32, 144_000, 1), f"batch {tuple(x32.shape)}")
    x4 = x32[:4].contiguous()
    first = Trainer(config, [], [], str(base / "fresh"), device=dev)
    w1 = first.weights_for_epoch(1)
    for B in (32, 24, 16, 12, 8):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        xb = x32[:B].contiguous()
        try:
            t0 = time.perf_counter()
            s_b, _ = first.gen_step(first.state, xb, w1)
            torch.cuda.synchronize()
        except torch.OutOfMemoryError:
            print(f"train memory, default.yaml as it is: B={B} x 4 h does "
                  "not fit the card (out of memory)")
            continue
        step_ms = (time.perf_counter() - t0) * 1e3
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            first.gen_step(s_b, xb, w1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"train memory, default.yaml as it is: the largest batch that "
              f"fits is B={B} x 4 h: peak {peak:.2f} GiB "
              f"(max_memory_allocated); first step (k-means init) "
              f"{step_ms:.1f} ms, then {times[0]:.1f} / {times[1]:.1f} ms "
              f"per step (host clock, synchronized)"
              + ("" if B == 32 else "; B=32 does not fit in 80 GB"))
        profile_step(torch, f"B={B} (default.yaml as it is)",
                     lambda: first.gen_step(s_b, xb, w1))
        del s_b, xb
        break
    else:
        fail("default.yaml's step fits the card at none of B=32-8")
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    s1, m1 = first.gen_step(first.state, x4, w1, keep_grads=True)
    torch.cuda.synchronize()
    c1 = launch_counts(kernels)
    grads = tree_leaves(m1["grads"])
    bad = [i for i, g in enumerate(grads)
           if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0]
    enc_first = m1["grads"]["encoder"]["init_conv"]["w"]
    check(s1.qstate.inited and not bad and c1["lstm_scan_backward"] == 4,
          f"first step: k-means {s1.qstate.inited}, {len(bad)} of "
          f"{len(grads)} gradient leaves zero or not finite, launches {c1}")
    print(f"train first step (fresh state, B=4 x 4 h, k-means init on "
          f"{4 * 480} rows): loss {float(m1['loss']):.5f}; all {len(grads)} "
          f"gradient leaves finite and non-zero (the encoder's first conv: "
          f"max |g| {float(enc_first.abs().max()):.3g}); launches {c1}; one "
          f"batch of 32 crops loaded and preprocessed in {batch_s:.2f} s")
    del first, s1, m1, grads, enc_first

    # -- the train path, counted: the entry point a user runs -------------
    build = train_entry.build_dataloaders
    train_entry.build_dataloaders = cut_epochs(build)
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = train_entry.main(["--config", str(cfg_path), "--log_dir",
                                    str(run), "--max_epochs", "2",
                                    "--device", "cuda"])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        train_entry.build_dataloaders = build
    counts = launch_counts(kernels)
    counts["lstm_save"] = kernels.lstm_scan.save_launches
    steps = int(trainer.state.opt_state.count)
    check(steps == 4, f"2 epochs ran {steps} steps, not 4")
    check(counts["nearest_codebook"] > 0 and counts["rvq_encode_fused"] > 0
          and counts["nearest_rowblock"] > 0
          and counts["lstm_save"] == 4 * steps
          and counts["lstm_scan_backward"] == 4 * steps
          and counts["lstm_bwd_cluster"] == 0
          and counts["lstm_grid"] == counts["lstm_scan"],
          f"the train path did not launch K1 (its row-block route), K2, the "
          f"saving K3 and K3's grid backward as planned: {counts}")
    k1_kmeans = counts["nearest_codebook"] - 8 * steps
    print(f"train path launches (B=32 with remat, a stand-in for default.yaml, "
          f"2 epochs, {steps} steps, 2 evals): "
          f"{json.dumps(counts)}; K1 {counts['nearest_rowblock']} of "
          f"{counts['nearest_codebook']} on its row-block route; per step "
          f"K1 8 (+{k1_kmeans} for the "
          f"k-means init on the first), K3 saving forward "
          f"{counts['lstm_save'] // steps}, K3 backward "
          f"{counts['lstm_scan_backward'] // steps}; per eval batch K2 1, K3 "
          f"{(counts['lstm_scan'] - counts['lstm_save']) // 2}")
    print(f"train fit: 2 epochs in {fit_s:.1f} s (seconds per epoch of 3 "
          f"batches, data loading included: "
          + ", ".join(f"{s:.1f}" for s in trainer.epoch_seconds.values())
          + ")")

    # -- resume bit for bit, and a step on -----------------------------
    fresh = Trainer(config_fit, [], [], str(run), device=dev)
    fresh.resume()
    check(fresh.start_epoch == 3 and states_equal(torch, fresh.state,
                                                  trainer.state),
          "resume did not restore params, qstate, Adam state and generator "
          "state bit for bit")
    w3 = fresh.weights_for_epoch(3)
    state, m = fresh.gen_step(fresh.state, x32, w3)
    check(bool(torch.isfinite(m["loss"])), "the resumed step's loss")
    print(f"train resume: epoch 3 from {run.name}/model.ckpt; params, "
          f"qstate, Adam (count {int(fresh.state.opt_state.count)}, mu, nu) "
          f"and the generator state equal the saved ones bit for bit; one "
          f"more step: loss {float(m['loss']):.5f}")

    # -- ms per step at B=32, peak memory, one profiled step --------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        fresh.gen_step(state, x32, w3)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train step B=32 x 4 h with remat (a stand-in for default.yaml, "
          f"which does not fit B=32): {times[0]:.1f} / {times[1]:.1f} ms per "
          f"step (host clock, synchronized); peak memory {peak:.2f} GiB "
          f"(max_memory_allocated)")
    profile_step(torch, "B=32 (remat, a stand-in for default.yaml)",
                 lambda: fresh.gen_step(state, x32, w3))
    del state, m

    # -- the kernels against the plain twins, one step at B=4 ------------
    raw, epoch, _ = load_checkpoint(run / "model.ckpt.prev")
    check(epoch == 1, f"model.ckpt.prev holds epoch {epoch}")
    s_e1 = state_to_device(raw, dev)
    gen_plain = make_train_steps(fresh.model.cfg,
                                 freq_loss_kwargs=fresh.freq_kwargs,
                                 clip=fresh.clip, plain=True)[0]
    w2 = fresh.weights_for_epoch(2)
    _, mk = fresh.gen_step(s_e1, x4, w2, keep_grads=True)
    _, mp = gen_plain(s_e1, x4, w2, keep_grads=True)
    torch.cuda.synchronize()
    held = codes_off_ties(torch, mk, mp)
    loss_err = abs(float(mk["loss"]) - float(mp["loss"])) / abs(
        float(mp["loss"]))
    grad_err = max(float((g - r).abs().max()) / float(r.abs().max())
                   for g, r in zip(tree_leaves(mk["grads"]),
                                   tree_leaves(mp["grads"])))
    check(held[-1] == 0, "train step B=4: codes differ from the plain "
                         "twins' outside the tie guard")
    check(loss_err <= 1e-4, f"train step B=4: loss {loss_err:.3g} from the "
                            "plain twins' > 1e-4 relative")
    check(grad_err <= 1e-3, f"train step B=4: a gradient leaf {grad_err:.3g} "
                            "of its largest |value| from the plain twins'")
    print(f"train step B=4 from epoch 1's state, kernels vs plain twins: "
          f"{codes_line(held)}; loss {loss_err:.3g} relative; "
          f"gradient leaves within {grad_err:.3g} of their largest |value|")
    del mk, mp, s_e1, trainer, fresh

    # -- K1 at the training shape ----------------------------------------
    from encodec_tpu_torch.kernels import vq_cuda

    N, D, bins = 32 * 480, 256, 1024
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = vq_cuda.nearest_plan(N, bins, D, sms)
    e = books(torch, (bins, D), 66, dev)
    x = gauss(torch, (N, D), 67, dev, 0.3)
    idx, margin = kernels.nearest_codebook(x, e)
    ref_idx, ref_margin = kernels.nearest_codebook_plain(x, e)
    torch.cuda.synchronize()
    safe = ref_margin >= TIE_THRESHOLD
    n_bad = int((idx[safe] != ref_idx[safe]).sum())
    err = float((margin - ref_margin).abs().max())
    check(n_bad == 0 and err <= 1e-4,
          f"K1 N={N} D={D}: {n_bad} indices differ outside the tie guard, "
          f"margin max|d| {err}")
    k1_against_cluster_route(torch, kernels, x, e, f"K1 N={N} D={D}")
    ms, how = device_or_event_ms(
        torch, lambda: kernels.nearest_codebook(x, e), 20, "vq_nearest")
    cl_ms, how_c = device_or_event_ms(
        torch, lambda: kernels.nearest_codebook(x, e, _route="cluster"), 20,
        "vq_nearest")
    plain_ms, how_p = device_or_event_ms(
        torch, lambda: kernels.nearest_codebook_plain(x, e), 5)
    lib_ms, how_l = device_or_event_ms(
        torch, lambda: torch.cdist(x, e).argmin(1), 5)
    b_ms, b_by = bound(2.0 * N * bins * D, (N * D + bins * D + 2 * N) * 4)
    print(f"K1 nearest_codebook at the training shape N={N} D={D} "
          f"bins={bins}: plan {k1_plan_text(plan)}; idx equal outside "
          f"margins < {TIE_THRESHOLD} ({int((~safe).sum())} rows flagged), "
          f"margin max|d|={err:.3g}; idx, margin, score equal the cluster "
          f"route's bit for bit; device ms: kernel={ms:.4f} cluster route="
          f"{cl_ms:.4f} plain={plain_ms:.4f} library(cdist+argmin)="
          f"{lib_ms:.4f} bound={b_ms:.5f} ({b_by}); timed by {how} / "
          f"{how_c} / {how_p} / {how_l}")
    k1_row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                  bound_by=b_by, max_abs_err=err)
    # the run directory stays for phase_lm_train's export (the caller
    # cleans `tmp` up)
    return counts, tmp, run, k1_row


# gan.yaml's discriminator, and the night length of the chunked-vs-whole
# check (1 h)
GAN_DISC = dict(filters=32, n_ffts=(1024, 1024), hop_lengths=(20, 128),
                win_lengths=(100, 512))
CHECK_NIGHT = 36_000


def gan_config(root: str) -> dict:
    """params/gan.yaml as written (`published_config`: default.yaml's
    generator with the discriminator on, 512-frame chunks)."""
    return published_config("gan", root)


def gan_disc512_config(root: str) -> dict:
    """params/gan_disc512.yaml as written: B=8, ratios [5, 5, 2, 1] (H=512),
    512 bins, one 512-FFT discriminator (hop 50, window 300), no
    `disc_time_chunk` (the whole-signal route), no L2 or commit loss."""
    return published_config("gan_disc512", root)


def conv_split(torch, fn) -> dict:
    """Device ms of the cuDNN convolutions in one call of `fn` (warm: it
    follows `one_window`'s calls), from one profiler window with CPU ops and their input
    shapes: a kernel belongs to the aten op that launched it, and that op
    is a 2-D conv (the discriminator's) when one of its 4-D operands spans
    both spatial dims, else a 1-D conv (the SEANet's, which cuDNN runs as
    [B, C, 1, T])."""
    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            fn()
            torch.cuda.synchronize()
    out = {"cuDNN conv2d forward": 0.0, "cuDNN conv2d backward": 0.0,
           "conv1d": 0.0}
    for e in prof.events():
        kern = getattr(e, "kernels", None)
        if not kern or "conv" not in e.name:
            continue
        shapes = [sh for sh in (e.input_shapes or [])
                  if isinstance(sh, (list, tuple)) and len(sh) == 4]
        if any(sh[2] > 1 and sh[3] > 1 for sh in shapes):
            key = ("cuDNN conv2d backward" if "backward" in e.name
                   else "cuDNN conv2d forward")
        else:
            key = "conv1d"
        out[key] += sum(k.duration for k in kern) / 1e3
    return out


def profile_gan_step(torch, label: str, fn) -> None:
    """One profiled GAN-phase step by kernel group: device busy time and
    idle share from one CUDA window (`one_window`), the convolutions split
    into the discriminator's 2-D and the generator's 1-D ones from a second
    window with CPU ops (`conv_split`)."""
    records, wall_ms = one_window(torch, fn)
    groups: dict = {}
    for key, (_, us) in records.items():
        g = train_group(key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
    busy = sum(groups.values())
    conv_total = (groups.pop("cuDNN conv forward", 0.0)
                  + groups.pop("cuDNN conv backward", 0.0))
    split = conv_split(torch, fn)
    split_total = sum(split.values())
    # the split window's shares of this window's convolution time
    for k, ms in split.items():
        groups[k] = conv_total * ms / split_total if split_total else 0.0
    print(f"profile gan step {label}: wall {wall_ms:.1f} ms (profiled), "
          f"device busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}; "
          "by group: " + ", ".join(
              f"{g} {ms:.2f} ms" for g, ms in
              sorted(groups.items(), key=lambda kv: -kv[1]))
          + f" (convolutions {conv_total:.2f} ms, split by a second window "
          f"that read {split_total:.2f})")
    for ms, n, key in sorted(((us / 1e3, n, key[:70]) for key, (n, us)
                              in records.items()), reverse=True)[:5]:
        print(f"    {ms:9.3f} ms  x{round(n):<4d} {key}")


def gan_steps_fit(torch, tr, x, w) -> tp.Optional[tuple]:
    """A GAN generator step and a discriminator step of trainer `tr` on
    batch `x` from its fresh state (the k-means init included); None when
    either runs out of memory. Returns (state after the generator step,
    first step ms, first disc ms)."""
    try:
        t0 = time.perf_counter()
        s_g, _ = tr.gen_step(tr.state, x, w, use_gan=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr.disc_step(s_g, x, w)
        torch.cuda.synchronize()
        return s_g, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3
    except torch.OutOfMemoryError:
        return None


def step_ms(torch, fn, n: int = 2) -> list:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_gan(torch, kernels, dev):
    """The GAN phase of training (params/gan.yaml: default.yaml's
    generator, H=1024, D=256, 8 stages of one shared book of 1024, with
    the MS-STFT discriminator: n_fft 1024/1024, hop 20/128, window
    100/512, 32 filters, 512-frame chunks; 4 h nights). First gan.yaml as
    written: the largest batch of 32, 24, 16, 12 and 8 nights at which a
    GAN generator step and a discriminator step both fit, their peak
    memory, ms per step and one profiled step of each by kernel group;
    then gan_disc512.yaml as written (B=8, the whole-signal route).
    Counted as one path, `python -m encodec_tpu_torch.train`'s `main` on
    the B=32 stand-in with `model.remat: true` (departing from the
    config) over synthetic npz nights (epochs cut by `cut_epochs`), 2
    epochs of 2 steps with the discriminator from epoch 1 (the config says
    60: a departure, so the phase reaches it), eval and save; a fresh
    Trainer resumes the run bit for bit, the discriminator, its Adam state
    and the balancer's included, and times one GAN generator step and one
    discriminator step of the stand-in from there. Then a GAN
    generator step and a discriminator step at B=4 from epoch 1's state
    on the kernels against the plain twins; the chunked discriminator
    against the whole-signal forward and `disc_remat` against the plain
    route on the card (B=2, 1 h nights)."""
    import tempfile

    from encodec_tpu_torch.models import msstftd
    from encodec_tpu_torch.train import (ConfigNamespace, Trainer,
                                         load_checkpoint, make_train_steps)
    from encodec_tpu_torch.train import __main__ as train_entry
    from encodec_tpu_torch.train.steps import gan_terms
    from encodec_tpu_torch.train.trainer import state_to_device

    tmp = tempfile.TemporaryDirectory()
    base = Path(tmp.name)
    for c, chan in enumerate(("thorax", "abdominal")):
        (base / "data" / "synth" / chan).mkdir(parents=True)
        for i in range(8):
            np.savez(base / "data" / "synth" / chan / f"night{i}.npz",
                     data=breathing_signal(TRAIN_NIGHT, 2000 + 10 * i + c),
                     fs=10)
    cfg = gan_config(str(base / "data"))
    config = ConfigNamespace(cfg)
    loader, _, _ = cut_epochs(train_entry.build_dataloaders)(config)
    x32 = torch.from_numpy(next(iter(loader))[0]["x"]).to(dev)
    check(tuple(x32.shape) == (32, cfg["dataset"]["max_length"], 1),
          f"batch {tuple(x32.shape)}")

    # -- gan.yaml as written: the largest batch that fits -----------------
    tr = Trainer(config, [], [], str(base / "asis"), device=dev)
    w = tr.weights_for_epoch(61)        # GAN on (epoch >= 60), commit on
    for B in (32, 24, 16, 12, 8):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        xb = x32[:B].contiguous()
        got = gan_steps_fit(torch, tr, xb, w)
        if got is None:
            print(f"gan memory, gan.yaml as written: B={B} x 4 h does not "
                  "fit the card (out of memory in the GAN generator step "
                  "or the discriminator step)")
            continue
        s_g, first_ms, first_d_ms = got
        gen_ms = step_ms(torch, lambda: tr.gen_step(s_g, xb, w,
                                                    use_gan=True))
        disc_ms = step_ms(torch, lambda: tr.disc_step(s_g, xb, w))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"gan memory, gan.yaml as written: the largest batch that fits "
              f"is B={B} x 4 h: peak {peak:.2f} GiB (max_memory_allocated, "
              f"both steps); GAN generator step (chunked discriminator) "
              f"{gen_ms[0]:.1f} / {gen_ms[1]:.1f} ms, discriminator step "
              f"{disc_ms[0]:.1f} / {disc_ms[1]:.1f} ms (host clock, "
              f"synchronized; the first, with the k-means init: "
              f"{first_ms:.1f} and {first_d_ms:.1f} ms)"
              + ("" if B == 32 else "; B=32 does not fit in 80 GB"))
        profile_gan_step(torch, f"B={B} GAN generator step (gan.yaml as "
                         "written)",
                         lambda: tr.gen_step(s_g, xb, w, use_gan=True))
        profile_gan_step(torch, f"B={B} discriminator step (gan.yaml as "
                         "written)", lambda: tr.disc_step(s_g, xb, w))
        del s_g, xb
        break
    else:
        fail("gan.yaml's steps fit the card at none of B=32-8")
    del tr
    torch.cuda.empty_cache()

    cfg_r = json.loads(json.dumps(cfg))
    cfg_r["model"]["remat"] = True
    cfg_r["model"]["train_discriminator_start_epoch"] = 1

    # -- gan_disc512.yaml as written: the whole-signal route, B=8 ---------
    cfg5 = gan_disc512_config(str(base / "data"))
    tr = Trainer(ConfigNamespace(cfg5), [], [], str(base / "d512"),
                 device=dev)
    check(tr.disc_cfg.time_chunk is None and tr.model.cfg.seanet.lstm,
          "gan_disc512's discriminator is not the whole-signal route")
    x8 = x32[:8].contiguous()
    w5 = tr.weights_for_epoch(101)
    torch.cuda.reset_peak_memory_stats()
    got = gan_steps_fit(torch, tr, x8, w5)
    check(got is not None, "gan_disc512.yaml at B=8 ran out of memory")
    s_g = got[0]
    gen_ms = step_ms(torch, lambda: tr.gen_step(s_g, x8, w5, use_gan=True))
    disc_ms = step_ms(torch, lambda: tr.disc_step(s_g, x8, w5))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"gan_disc512.yaml as written (B=8 x 4 h, H=512, one 512-FFT "
          f"discriminator, whole signal): GAN generator step "
          f"{gen_ms[0]:.1f} / {gen_ms[1]:.1f} ms, discriminator step "
          f"{disc_ms[0]:.1f} / {disc_ms[1]:.1f} ms; peak {peak:.2f} GiB")
    del tr, s_g, x8
    torch.cuda.empty_cache()

    # -- the GAN path, counted: the entry point a user runs ---------------
    cfg_path = base / "gan_remat.json"
    cfg_path.write_text(json.dumps(cfg_r))
    run = base / "run"
    build = train_entry.build_dataloaders
    train_entry.build_dataloaders = cut_epochs(build)
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = train_entry.main(["--config", str(cfg_path), "--log_dir",
                                    str(run), "--max_epochs", "2",
                                    "--device", dev.type])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        train_entry.build_dataloaders = build
    counts = launch_counts(kernels)
    counts["lstm_save"] = kernels.lstm_scan.save_launches
    steps = int(trainer.state.opt_state.count)
    n_disc = int(trainer.state.disc_opt_state.count)
    check(steps == 4 and 0 < n_disc < steps,
          f"2 epochs ran {steps} generator steps and {n_disc} "
          "discriminator steps; wanted 4 and at least one of each kind")
    evals = 2          # one batch of VAL_ITEMS per eval
    check(counts["nearest_codebook"] > 0 and counts["rvq_encode_fused"] > 0
          and counts["nearest_rowblock"] > 0
          and counts["lstm_save"] == 4 * steps
          and counts["lstm_scan_backward"] == 4 * steps
          and counts["lstm_bwd_cluster"] == 0
          and counts["lstm_scan"] == 4 * (steps + n_disc + evals)
          and counts["lstm_grid"] == counts["lstm_scan"],
          f"the GAN path did not launch K1 (its row-block route), K2, the "
          f"saving K3, K3's "
          f"backward and the plain K3 as planned: {counts}")
    print(f"gan path launches (B=32 with remat, a stand-in for gan.yaml; the "
          f"discriminator from epoch 1; 2 epochs, {steps} generator steps, "
          f"{steps - n_disc} of them with the GAN terms, {n_disc} "
          f"discriminator steps, 2 evals): {json.dumps(counts)}; per "
          f"discriminator step K3 4 (the generator's forward, plain launch), "
          f"K1 8")
    print(f"gan fit: 2 epochs in {fit_s:.1f} s (seconds per epoch of 3 "
          f"batches, data loading included: "
          + ", ".join(f"{v:.1f}" for v in trainer.epoch_seconds.values())
          + ")")

    # -- resume bit for bit ----------------------------------------------
    fresh = Trainer(ConfigNamespace(cfg_r), [], [], str(run), device=dev)
    fresh.resume()
    check(fresh.start_epoch == 3 and states_equal(torch, fresh.state,
                                                  trainer.state),
          "resume did not restore the generator, the discriminator, both "
          "Adam states and the generator state bit for bit")
    print(f"gan resume: epoch 3 from {run.name}/model.ckpt; params, qstate, "
          f"Adam (count {int(fresh.state.opt_state.count)}), the "
          f"discriminator and its Adam (count "
          f"{int(fresh.state.disc_opt_state.count)}) and the generator state "
          f"equal the saved ones bit for bit")
    del trainer

    # -- the B=32 stand-in's steps from the resumed state: one timed step
    # of each (the run's depth is cut to keep the script well inside its
    # time limit)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    w3 = fresh.weights_for_epoch(3)
    gen_ms = step_ms(torch, lambda: fresh.gen_step(fresh.state, x32, w3,
                                                   use_gan=True), 1)
    disc_ms = step_ms(torch, lambda: fresh.disc_step(fresh.state, x32, w3), 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"gan step B=32 x 4 h with remat (a stand-in departing from "
          f"gan.yaml, which does not fit B=32), from the resumed state: GAN "
          f"generator step {gen_ms[0]:.1f} ms, discriminator step "
          f"{disc_ms[0]:.1f} ms (host clock, synchronized); peak memory "
          f"{peak:.2f} GiB")

    # -- the kernels against the plain twins, B=4 -------------------------
    raw, epoch, _ = load_checkpoint(run / "model.ckpt.prev")
    check(epoch == 1, f"model.ckpt.prev holds epoch {epoch}")
    s_e1 = state_to_device(raw, dev)
    gen_p, disc_p = make_train_steps(fresh.model.cfg, fresh.disc_cfg,
                                     freq_loss_kwargs=fresh.freq_kwargs,
                                     clip=fresh.clip, plain=True)[:2]
    x4 = x32[:4].contiguous()
    w2 = fresh.weights_for_epoch(2)
    _, mk = fresh.gen_step(s_e1, x4, w2, use_gan=True, keep_grads=True)
    _, mp = gen_p(s_e1, x4, w2, use_gan=True, keep_grads=True)
    sk, dk = fresh.disc_step(s_e1, x4, w2)
    sp, dp = disc_p(s_e1, x4, w2)
    torch.cuda.synchronize()
    held = codes_off_ties(torch, mk, mp)
    errs = {k: abs(float(mk[k]) - float(mp[k])) / abs(float(mp[k]))
            for k in ("loss", "loss_gen", "loss_feat")}
    errs.update({k: abs(float(dk[k]) - float(dp[k])) / abs(float(dp[k]))
                 for k in ("loss_disc", "logits_real", "logits_fake")})
    check(held[-1] == 0, "gan step B=4: codes differ from the plain twins' "
                         "outside the tie guard")
    check(max(errs.values()) <= 1e-4,
          f"gan steps B=4: losses from the plain twins' beyond 1e-4: {errs}")
    print(f"gan steps B=4 from epoch 1's state, kernels vs plain twins: "
          f"{codes_line(held)}; relative differences "
          "(bound 1e-4): " + ", ".join(f"{k} {v:.3g}"
                                       for k, v in errs.items()))
    del mk, mp, sk, sp, s_e1, fresh

    # -- the chunked discriminator against the whole signal; remat -------
    x2 = torch.from_numpy(np.stack([
        breathing_signal(CHECK_NIGHT, 3000 + i) for i in range(2)])[..., None]
    ).to(dev)
    x2_hat = x2 + 0.2 * torch.from_numpy(np.random.RandomState(3001).randn(
        2, CHECK_NIGHT, 1).astype(np.float32)).to(dev)
    dcfg = msstftd.MSSTFTConfig(**GAN_DISC)
    disc = msstftd.init_msstftd(torch.Generator().manual_seed(5), dcfg,
                                dev)
    worst = 0.0
    with torch.no_grad():
        for i, sub in enumerate(disc["discs"]):
            sums = msstftd.msstftd_gan_sums_chunked(sub, x2, x2_hat, dcfg, i,
                                                    chunk=512)
            lr, fr = msstftd.msstftd_sub_forward(sub, x2, dcfg, i)
            lf, ff = msstftd.msstftd_sub_forward(sub, x2_hat, dcfg, i)
            whole = {"lg_real": (1 - lr).square().sum(),
                     "sum_real": lr.sum(), "lg_fake": (1 - lf).square().sum(),
                     "sq_fake": lf.square().sum(), "sum_fake": lf.sum(),
                     "feat_diff": torch.stack([(a - b).abs().sum()
                                               for a, b in zip(fr, ff)]),
                     "feat_real": torch.stack([a.abs().sum() for a in fr])}
            check(int(sums["n_logit"]) == lr.numel(), "n_logit")
            for k, v in whole.items():
                e = float(((sums[k] - v).abs() / v.abs()).max())
                worst = max(worst, e)
    check(worst <= 1e-5, f"chunked sums {worst:.3g} from the whole-signal "
                         "forward (relative) > 1e-5")
    routes = {}
    for remat in (False, True):
        y = x2_hat.clone().requires_grad_(True)
        l_g, l_feat = gan_terms(disc, dcfg, x2, y, disc_remat=remat)
        g, = torch.autograd.grad(3 * l_g + 3 * l_feat, y)
        routes[remat] = (l_g.detach(), l_feat.detach(), g)
    rerr = max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(routes[True], routes[False]))
    check(rerr <= 1e-5, f"disc_remat {rerr:.3g} from the plain route")
    print(f"gan discriminator on the card (B=2 x 1 h, gan.yaml's widths): "
          f"chunked sums (512 frames, ragged tails) vs the whole-signal "
          f"forward, worst relative {worst:.3g} (bound 1e-5); disc_remat vs "
          f"the plain route (l_g, l_feat and their gradient in x_hat) "
          f"{rerr:.3g} (bound 1e-5)")
    tmp.cleanup()
    return counts


# the six published configs `phase_configs` trains, in order; the stand-in
# options of a config whose own batch does not fit the card (l2 is
# default.yaml's model at its B=32, which `phase_train` finds out of memory;
# the others fit theirs: PERF.md §5); the GAN step's gradient bound against
# the twins (`tests/test_torch_gan.py`'s `GAN_GRAD_REL`)
CONFIG_RUNS = ("tokens_10s", "l2_weightnorm", "l2", "multires_disc",
               "bins512_commit", "disc256_bins256")
CONFIG_STANDIN = {"l2": {"remat": True}}
CONFIG_CHECK_B, CONFIG_CHECK_T = 2, 18_000   # the twin steps: B=2 x 0.5 h
CONFIG_K3_SLICE = 2_880            # K3's twins on the path's inputs, steps
GAN_GRAD_BOUND = 5e-3
# the twin steps hold each gradient leaf within the bound of its own plus
# the gradient's largest |value|, and within this many times the bound of
# its own (`held_leaves`)
OWN_FACTOR = 10
# the configs whose kernels' shapes get rows of their own in the table
CONFIG_ROWS = {"tokens_10s": ("K3",), "l2_weightnorm": ("K1", "K3"),
               "bins512_commit": ("K1", "K3"), "disc256_bins256": ("K1",)}
CONFIG_FIRST = 4000                # the seed of the phase's synthetic nights


def configs_loaders(build, root: str, model_overrides: dict):
    """`build_dataloaders` for `train.__main__.main` run on a published
    config file as written: the caller gives the data root (the files say
    `root: null`) and the synthetic dataset, cuts the virtual epochs to 2
    training batches and one eval batch (`cut_epochs`' depth), and, for a
    stand-in, sets `model_overrides` before the Trainer is built."""
    from encodec_tpu_torch.train import ConfigNamespace

    def cut(config, *shard):
        config.dataset.root = root
        config.dataset.datasets = ConfigNamespace({"synth": 1.0})
        for key, value in model_overrides.items():
            setattr(config.model, key, value)
        train, val, mapping = build(config, *shard)
        B = config.dataset.batch_size
        train.dataset.size, val.dataset.size = TRAIN_ITEMS // 32 * B, B
        return train, val, mapping
    return cut


def run_once(torch, fn) -> tuple:
    """(`fn()`, its ms by CUDA events): one call, for a plain twin too slow
    to repeat."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def config_k1_row(torch, kernels, seen: dict, label: str) -> dict:
    """K1 on the first stage search a training step gave it: held against
    its twin as `hold_captured` holds a path's inputs (indices equal where
    the twin's margin is outside the tie guard, margins within the guard:
    they are differences of squared distances at the trained latents'
    scale) and, on the row-block route, against the cluster route bit for
    bit; timed beside the twin, the cluster route, `cdist`+`argmin` and the
    bound."""
    from encodec_tpu_torch.kernels import vq_cuda

    (x, e, *rest), kw = seen["nearest_codebook"]
    idx, margin = kernels.nearest_codebook(x, e, *rest, **kw)
    ref_idx, ref_margin = kernels.nearest_codebook_plain(x, e, *rest, **kw)
    torch.cuda.synchronize()
    safe = ref_margin >= TIE_THRESHOLD
    n_bad = int((idx[safe] != ref_idx[safe]).sum())
    err = float((margin - ref_margin).abs().max())
    N, D = x.shape
    bins = e.shape[0]
    check(n_bad == 0 and err <= TIE_THRESHOLD,
          f"K1 {label} N={N} D={D} bins={bins}: {n_bad} indices off the "
          f"twin's outside the tie guard, margin max|d| {err}")
    plan = vq_cuda.nearest_plan(N, bins, D, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    vs_cluster = ""
    if plan.route == "rowblock":
        k1_against_cluster_route(torch, kernels, x, e, f"K1 {label}")
        cl_ms, how_c = device_or_event_ms(
            torch, lambda: kernels.nearest_codebook(x, e, _route="cluster"),
            20, "vq_nearest")
        vs_cluster = (f"; idx, margin, score equal the cluster route's bit "
                      f"for bit, whose device ms={cl_ms:.4f} ({how_c})")
    ms, how = device_or_event_ms(
        torch, lambda: kernels.nearest_codebook(x, e), 20, "vq_nearest")
    plain_ms, how_p = device_or_event_ms(
        torch, lambda: kernels.nearest_codebook_plain(x, e), 5)
    lib_ms, how_l = device_or_event_ms(
        torch, lambda: torch.cdist(x, e).argmin(1), 5)
    b_ms, b_by = bound(2.0 * N * bins * D, (N * D + bins * D + 2 * N) * 4)
    print(f"K1 nearest_codebook on {label}'s first stage search (N={N}, "
          f"D={D}, bins={bins}): plan {k1_plan_text(plan)}; idx equal "
          f"outside margins < {TIE_THRESHOLD} ({int((~safe).sum())} rows "
          f"flagged), margin max|d|={err:.3g}; device ms: kernel={ms:.4f} "
          f"plain={plain_ms:.4f} library(cdist+argmin)={lib_ms:.4f} bound="
          f"{b_ms:.5f} ({b_by}); timed by {how} / {how_p} / {how_l}"
          f"{vs_cluster}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err, shape=f"N={N}, D={D}, "
                f"bins={bins}", k1_route=plan.route)


def config_k3_rows(torch, kernels, dev, seen: dict, label: str) -> tuple:
    """K3's saving forward and its backward kernel on the first LSTM
    layer's inputs a training step gave them: held against the twins (h
    and c within 1e-4; dgates, dh0 and dc0 within 1e-4 of their largest
    |value|), timed beside the twins (one call each by CUDA events: the
    twin steps T times from Python), cuDNN's LSTM forward with gradients
    on (the yardstick of the saving forward) and the bound, 8·B·T·H² FLOPs
    each. Past `CONFIG_K3_SLICE` steps the twins run a slice: the forward
    the first steps (the kernel's own launch held on them), the backward
    the last (from the saved c before them; the launch's dgates held
    there), and their one-call times are scaled by T over the slice."""
    from encodec_tpu_torch.kernels import lstm_cuda

    (xp, w_hh, *state), _ = seen["lstm_scan"]
    h0, c0 = (state + [None, None])[:2]
    B, T, H4 = xp.shape
    H = H4 // 4
    Ts = min(T, CONFIG_K3_SLICE)
    out, c_seq = kernels.lstm_scan(xp, w_hh, h0, c0, save_c=True)
    (p_out, p_c), fwd_plain_ms = run_once(torch, lambda: kernels.
                                          lstm_scan_plain(
                                              xp[:, :Ts].contiguous(), w_hh,
                                              h0, c0, save_c=True))
    fwd_err = max(float((out[:, :Ts] - p_out).abs().max()),
                  float((c_seq[:, :Ts] - p_c).abs().max()))
    check(fwd_err <= 1e-4, f"K3 saving forward {label} B={B} T={T} H={H}: "
                           f"max|d| {fwd_err:.3g} from its twin")
    del out, c_seq, p_out, p_c
    (pre, c_bwd, dy, w_b, *rest), kw = seen["lstm_scan_backward"]
    got = kernels.lstm_scan_backward(pre, c_bwd, dy, w_b, *rest, **kw)
    s0 = T - Ts
    if s0:
        c0_s, dc_last = c_bwd[:, s0 - 1].contiguous(), (rest + [None] * 2)[1]
        got = got[:1]
        suffix = [t[:, s0:].contiguous() for t in (pre, c_bwd, dy)]
    else:
        c0_s, dc_last = (rest + [None] * 2)[:2]
        suffix = [pre, c_bwd, dy]
    want, bwd_plain_ms = run_once(torch, lambda: kernels.
                                  lstm_scan_backward_plain(
                                      *suffix, w_b, c0_s, dc_last))
    got = [g if g is None or not s0 else g[:, s0:] for g in got]
    bwd_err = max(float((g - r).abs().max()) / float(r.abs().max())
                  for g, r in zip(got, want) if g is not None
                  and float(r.abs().max()) > 0)
    check(bwd_err <= 1e-4, f"K3 backward {label} B={B} T={T} H={H}: "
                           f"{bwd_err:.3g} of its largest |value| from its "
                           "twin")
    abs_bwd = float((got[0] - want[0]).abs().max())
    del got, want, suffix
    fwd_plain_ms *= T / Ts
    bwd_plain_ms *= T / Ts
    held_on = "" if not s0 else (
        f"; held on the first {Ts} steps (forward) and the last {Ts} "
        f"(backward), the twins' one-call times scaled by {T / Ts:g} from "
        "them")
    fwd_ms, how_f = device_or_event_ms(torch, lambda: kernels.lstm_scan(
        xp, w_hh, h0, c0, save_c=True), 3, "lstm_")
    bwd_ms, how_b = device_or_event_ms(
        torch, lambda: kernels.lstm_scan_backward(pre, c_bwd, dy, w_b,
                                                  *rest, **kw), 3, "lstm_bwd")
    cudnn = lstm_yardstick(torch, w_hh, dev)
    x_req = xp.clone().requires_grad_(True)
    state0 = None if h0 is None else (h0[None], c0[None])
    lib_ms = time_ms(torch, lambda: cudnn(x_req, state0)[0], 3)
    del cudnn, x_req
    flops = 8.0 * B * T * H * H
    f_ms, f_by = bound(flops, (B * T * 4 * H + 4 * H * H
                               + 2 * B * T * H) * 4)
    b_ms, b_by = bound(flops, (2 * B * T * 4 * H + 2 * B * T * H
                               + 4 * H * H + 3 * B * H) * 4)
    seqs = lstm_cuda.lstm_plan(B, H, lstm_cuda.max_active_clusters(
        H, xp.device)).seqs_per_cluster
    print(f"K3 on {label}'s first LSTM layer (B={B}, T={T}, H={H}; "
          f"{seqs} sequence(s) per cluster): saving forward max|d| "
          f"{fwd_err:.3g} from its twin, backward {bwd_err:.3g} of the "
          f"largest |value|; device ms: saving "
          f"forward={fwd_ms:.4f} ({fwd_ms / T * 1e3:.3f} us/step; plain "
          f"{fwd_plain_ms:.4f}, CUDA events, one call; cuDNN LSTM forward "
          f"with gradients on {lib_ms:.4f}, CUDA events; bound {f_ms:.5f} "
          f"({f_by})), {lstm_cuda.bwd_route(H)} backward kernel={bwd_ms:.4f} "
          f"({bwd_ms / T * 1e3:.3f} us/step; plain {bwd_plain_ms:.4f}, CUDA "
          f"events, one call; bound {b_ms:.5f} ({b_by})); timed by "
          f"{how_f} / {how_b}{held_on}")
    shape = f"B={B}, T={T}, H={H}"
    return (dict(ms=fwd_ms, plain_ms=fwd_plain_ms, library_ms=lib_ms,
                 bound_ms=f_ms, bound_by=f_by, max_abs_err=fwd_err,
                 shape=shape, k3_seqs=seqs),
            dict(ms=bwd_ms, plain_ms=bwd_plain_ms, library_ms=None,
                 bound_ms=b_ms, bound_by=b_by, max_abs_err=abs_bwd,
                 shape=shape, k3_bwd_route=lstm_cuda.bwd_route(H)))


def grad_gap(torch, a, b) -> tuple:
    """The largest gap between gradient trees `a` and `b`, each leaf's
    max |a - b| over its own largest |b|: (gap, leaf, that leaf's largest
    |value| over the tree's)."""
    pairs = [(path, g, r) for (path, g), (_, r) in zip(par_leaves(a),
                                                        par_leaves(b))]
    top = max(float(r.abs().max()) for _, _, r in pairs)
    return max((float((g - r).abs().max()) / max(float(r.abs().max()),
                                                  1e-30),
                path, float(r.abs().max()) / top) for path, g, r in pairs)


def gap_text(gap: tuple) -> str:
    return (f"{gap[0]:.3g} (at {gap[1]}, {gap[2]:.3g} of the top)" if gap[0]
            else "0")


def held_leaves(torch, mk, mp, mf, limit: float) -> tuple:
    """The kernels' gradient (`mk`) against the twins' (`mp`), leaf by
    leaf: each leaf within `limit` of its own plus the gradient's largest
    |value| (`tests/test_torch_train.py`'s measure) and within
    `OWN_FACTOR` x `limit` of its own. `mf` is the twins' step again with
    cuDNN free to pick its algorithms: how far that moves a leaf, beside
    the kernels' gap, is the leaf's own float32 spread (a leaf that is a
    small sum of large terms moves with any rounding). Returns (whether
    all hold, a summary)."""
    kern = dict(par_leaves(mk["grads"]))
    free = dict(par_leaves(mf["grads"]))
    rows = [(path, float((kern[path] - r).abs().max()),
             float((free[path] - r).abs().max()), float(r.abs().max()))
            for path, r in par_leaves(mp["grads"])]
    top = max(own for *_, own in rows)
    both = max(d / (own + top) for _, d, _, own in rows)
    own_gap, at, share = max((d / max(own, 1e-30), path, own / top)
                             for path, d, _, own in rows)
    over = sum(d > limit * own for _, d, _, own in rows)
    spread, spread_at = max((df / max(own, 1e-30), path)
                            for path, _, df, own in rows)
    ok = both <= limit and own_gap <= OWN_FACTOR * limit
    return ok, (f"gradient leaves within {both:.3g} of their own plus the "
                f"gradient's largest |value| (bound {limit:g}) and "
                f"{own_gap:.3g} of their own (bound {OWN_FACTOR * limit:g}; "
                f"at {at}, whose largest |value| is {share:.3g} of the "
                f"gradient's; {over} of {len(rows)} leaves beyond {limit:g} "
                f"of their own); the twins' step with cuDNN free moves "
                f"leaves by up to {spread:.3g} of their own (at {spread_at})")


def config_steps_vs_twins(torch, trainer, state, x, gan: bool,
                          control: bool = False) -> str:
    """A generator step (with `gan`, the GAN generator step and a
    discriminator step) from `state` on the kernels against the same steps
    on the plain twins, with cuDNN held to deterministic algorithms (each
    step then gives the same bits when repeated): codes stage by stage
    outside the tie guard (`codes_off_ties`), losses within 1e-4, gradient
    leaves as `held_leaves` holds them at 1e-3 (`GAN_GRAD_BOUND` in the
    GAN generator step). With `control`, each generator step also runs a
    second time, and the kernels' step twice and the twins' once as the
    path runs (cuDNN free to pick non-deterministic algorithms), whose
    gaps are printed beside the kernels'."""
    from encodec_tpu_torch.train import make_train_steps

    gen_p, disc_p = make_train_steps(trainer.model.cfg, trainer.disc_cfg,
                                     freq_loss_kwargs=trainer.freq_kwargs,
                                     clip=trainer.clip, plain=True)[:2]
    w = trainer.weights_for_epoch(2)

    def run(step):
        _, m = step(state, x, w, use_gan=gan, keep_grads=True)
        torch.cuda.synchronize()
        return m

    notes = []
    if control:
        ka, kb, pa = run(trainer.gen_step), run(trainer.gen_step), run(gen_p)
        notes.append(f"as the path runs (cuDNN free): kernels vs twins "
                     f"{gap_text(grad_gap(torch, ka['grads'], pa['grads']))}"
                     f", kernels repeated "
                     f"{gap_text(grad_gap(torch, ka['grads'], kb['grads']))}")
        del ka, kb, pa
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mk, mp = run(trainer.gen_step), run(gen_p)
        torch.backends.cudnn.deterministic = deterministic
        mf = run(gen_p)
        torch.backends.cudnn.deterministic = True
        if control:
            notes.insert(0, "repeated: kernels " + gap_text(grad_gap(
                torch, mk["grads"], run(trainer.gen_step)["grads"]))
                + ", twins " + gap_text(grad_gap(torch, mp["grads"],
                                                 run(gen_p)["grads"])))
        limit = GAN_GRAD_BOUND if gan else 1e-3
        grads_ok, grads_text = held_leaves(torch, mk, mp, mf, limit)
        held = codes_off_ties(torch, mk, mp)
        keys = ("loss", "loss_gen", "loss_feat") if gan else ("loss",)
        loss_err = max(abs(float(mk[k]) - float(mp[k])) / abs(float(mp[k]))
                       for k in keys)
        del mk, mp, mf
        if gan:
            _, dk = trainer.disc_step(state, x, w)
            _, dq = disc_p(state, x, w)
            d_err = max(abs(float(dk[k]) - float(dq[k])) / abs(float(dq[k]))
                        for k in ("loss_disc", "logits_real", "logits_fake"))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    what = "GAN generator step" if gan else "generator step"
    check(held[-1] == 0,
          f"{what}: codes off the plain twins' outside the tie guard")
    check(loss_err <= 1e-4, f"{what}: losses {loss_err:.3g} from the "
                            "plain twins' > 1e-4 relative")
    check(grads_ok, f"{what}: {grads_text}")
    out = [f"{what} (cuDNN deterministic): losses {loss_err:.3g} relative "
           f"(bound 1e-4); {codes_line(held)}; {grads_text}"]
    out += notes
    if gan:
        check(d_err <= 1e-4, f"discriminator step: {d_err:.3g} from the "
                             "plain twins' > 1e-4 relative")
        out.append(f"discriminator step: loss and logits {d_err:.3g} "
                   "relative (bound 1e-4)")
    return "; ".join(out)


def config_run(torch, kernels, dev, name: str, data: Path, base: Path,
               x32, rows: dict, control: bool = False) -> tuple:
    """One config of `phase_configs`: the first step's gradient, the
    counted entry-point run (a stand-in where the config's own batch does
    not fit), its resume, ms per step and peak memory at the run's batch
    with K1 and K3 on that step's inputs and K2 on the eval encode's, and
    the steps against the twins. Returns (launch counts, the run
    directory)."""
    from encodec_tpu_torch.train import (ConfigNamespace, Trainer,
                                         load_checkpoint)
    from encodec_tpu_torch.train import __main__ as train_entry
    from encodec_tpu_torch.train.optim import tree_leaves
    from encodec_tpu_torch.train.trainer import state_to_device

    cfg = published_config(name, str(data))
    B_file = cfg["dataset"]["batch_size"]
    tr = Trainer(ConfigNamespace(cfg), [], [], str(base / name / "asis"),
                 device=dev)
    m = tr.model
    H = m.params["encoder"]["lstm"]["layers"][0]["w_hh"].shape[1]
    hop = m.cfg.seanet.hop_length
    T = cfg["dataset"]["max_length"] // hop
    gan = tr._gan_active(1)
    w = tr.weights_for_epoch(1)
    disc = ("off" if tr.disc_cfg is None else
            f"n_fft {list(tr.disc_cfg.n_ffts)}, hop "
            f"{list(tr.disc_cfg.hop_lengths)}, from epoch "
            f"{cfg['model']['train_discriminator_start_epoch']}, "
            + ("whole signal" if tr.disc_cfg.time_chunk is None else
               f"{tr.disc_cfg.time_chunk}-frame chunks"))
    loss = cfg["loss"]
    print(f"configs {name} ({config_path(name)}): n_q {m.cfg.rvq.n_q} of "
          f"{m.cfg.rvq.bins} bins (D={m.cfg.rvq.dimension}), norm "
          f"{m.cfg.seanet.norm}, ratios {list(m.cfg.seanet.ratios)}, H={H} "
          f"(K3 {'grid' if H > 512 else 'cluster'} kernel), hop {hop}, "
          f"T={T} per 4 h night, batch {B_file}; losses l1 "
          f"{loss['weight_l1']}, l2 {loss['weight_l2']}, freq "
          f"{loss['weight_freq']}, commit {loss['weight_commit']}; the "
          f"discriminator {disc}")

    # -- the first step from a fresh state: every gradient leaf -----------
    x2 = x32[:CONFIG_CHECK_B].contiguous()
    s1, m1 = tr.gen_step(tr.state, x2, w, use_gan=gan, keep_grads=True)
    grads = tree_leaves(m1["grads"])
    bad = [i for i, g in enumerate(grads)
           if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0]
    check(s1.qstate.inited and not bad,
          f"configs {name} first step: k-means {s1.qstate.inited}, "
          f"{len(bad)} of {len(grads)} gradient leaves zero or not finite")
    print(f"configs {name} first step (fresh state, B={CONFIG_CHECK_B} x 4 "
          f"h, k-means on {CONFIG_CHECK_B * T} rows"
          + (", with the GAN terms" if gan else "") + f"): loss "
          f"{float(m1['loss']):.5f}; all {len(grads)} gradient leaves "
          "finite and non-zero")
    del s1, m1, grads

    overrides = CONFIG_STANDIN.get(name, {})
    del tr
    torch.cuda.empty_cache()

    # -- the entry point a user runs, counted -----------------------------
    run = base / name / "run"
    build = train_entry.build_dataloaders
    train_entry.build_dataloaders = configs_loaders(build, str(data),
                                                    overrides)
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = train_entry.main(["--config", config_path(name),
                                    "--log_dir", str(run), "--max_epochs",
                                    "2", "--device", dev.type])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        train_entry.build_dataloaders = build
    counts = launch_counts(kernels)
    counts["lstm_save"] = kernels.lstm_scan.save_launches
    steps = int(trainer.state.opt_state.count)
    n_disc = int(trainer.state.disc_opt_state.count) if gan else 0
    check(steps == 4 and (not gan or 0 < n_disc < steps),
          f"configs {name}: 2 epochs ran {steps} generator steps and "
          f"{n_disc} discriminator steps")
    k3 = (counts["lstm_grid"] if H > 512
          else counts["lstm_scan"] - counts["lstm_grid"])
    # the backward's route by H: the cluster kernel up to 512
    bwd = (counts["lstm_scan_backward"] - counts["lstm_bwd_cluster"]
           if H > 512 else counts["lstm_bwd_cluster"])
    check(counts["nearest_codebook"] > 0 and counts["rvq_encode_fused"] > 0
          and k3 > 0 and counts["lstm_save"] == 4 * steps
          and counts["lstm_scan_backward"] > 0
          and bwd == counts["lstm_scan_backward"],
          f"configs {name}: the path did not launch K1, K2, K3 (saving "
          f"forward and the backward of its route) as planned: {counts}")
    standin = (f" with {overrides}, a stand-in departing from the config, "
               "whose own batch does not fit the card" if overrides else
               ", as written")
    print(f"configs {name} path launches (train.__main__.main --config "
          f"{config_path(name)}, B={B_file}{standin}; 2 epochs, {steps} "
          "generator steps"
          + (f", {steps - n_disc} of them with the GAN terms, {n_disc} "
             f"discriminator steps" if gan else "")
          + f", 2 evals): {json.dumps(counts)}; fit {fit_s:.1f} s (s per "
          "epoch of 2 batches, data loading included: "
          + ", ".join(f"{v:.1f}" for v in trainer.epoch_seconds.values())
          + ")")

    # -- resume bit for bit (the GAN run: the discriminator's state too) --
    if gan:
        cfg_run = json.loads(json.dumps(cfg))
        cfg_run["model"].update(overrides)
        fresh = Trainer(ConfigNamespace(cfg_run), [], [], str(run),
                        device=dev)
        fresh.resume()
        check(fresh.start_epoch == 3 and states_equal(torch, fresh.state,
                                                      trainer.state),
              f"configs {name}: resume did not restore the generator, the "
              "discriminator, both Adam states and the generator state "
              "bit for bit")
        print(f"configs {name} resume: epoch 3 from {run.name}/model.ckpt "
              "in a fresh Trainer; params, qstate, Adam (count "
              f"{int(fresh.state.opt_state.count)}), the discriminator and "
              f"its Adam (count {int(fresh.state.disc_opt_state.count)}) "
              "and the generator state equal the saved ones bit for bit")
        del fresh

    # -- at the run's batch from epoch 1's state: the kernels on the
    # step's own inputs, ms per step and peak memory ----------------------
    raw, epoch, _ = load_checkpoint(run / "model.ckpt.prev")
    check(epoch == 1, f"model.ckpt.prev holds epoch {epoch}")
    s_e1 = state_to_device(raw, dev)
    del raw
    xb, w2 = x32[:B_file].contiguous(), trainer.weights_for_epoch(2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the timed steps before the capture: l2_weightnorm's GAN step at B=8
    # peaks near 74 GiB on an 80 GB H100, and the kernels' inputs that a
    # capture clones (GiBs, scattered over the allocator's segments) must
    # not be held while it runs
    gen = step_ms(torch, lambda: trainer.gen_step(s_e1, xb, w2,
                                                  use_gan=gan))
    disc_ms = (step_ms(torch, lambda: trainer.disc_step(s_e1, xb, w2))
               if gan else [])
    torch.cuda.empty_cache()
    _, seen = capture_first(torch, lambda: trainer.gen_step(s_e1, xb, w2))
    print(f"configs {name} B={B_file} x 4 h{standin}: "
          f"{statistics.median(gen):.1f} ms per "
          f"{'GAN generator ' if gan else ''}step (median of "
          f"{', '.join(f'{t:.1f}' for t in gen)}; host clock, synchronized)"
          + (f", discriminator step {statistics.median(disc_ms):.1f} ms"
             if gan else "")
          + f"; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          "(max_memory_allocated)")
    # the eval encode (K2) on the same batch, after the timed steps
    seen["rvq_encode_fused"] = capture_first(
        torch, lambda: trainer.eval_step(s_e1, xb, w2))[1]["rvq_encode_fused"]
    t0 = time.perf_counter()
    timed = CONFIG_ROWS.get(name, ())
    if "K1" in timed:
        rows["K1"].append((name, config_k1_row(torch, kernels, seen, name)))
    if "K3" in timed:
        f_row, b_row = config_k3_rows(torch, kernels, dev, seen, name)
        rows["K3 forward"].append((name, f_row))
        rows["K3 backward"].append((name, b_row))
    rest = {k: v for k, v in seen.items() if not (
        ("K1" in timed and k == "nearest_codebook")
        or ("K3" in timed and k.startswith("lstm_scan")))}
    if rest:
        print(f"configs {name} kernels on the path's inputs (B={B_file}): "
              + hold_captured(torch, kernels, rest, f"configs {name}"))
    print(f"configs {name} kernels held and timed in "
          f"{time.perf_counter() - t0:.1f} s")
    del seen, rest, xb
    torch.cuda.empty_cache()

    # -- the kernels against the plain twins, B=2 from epoch 1's state, on
    # the batch's first half hour: the twins step T times from Python (the
    # 4 h shapes were held kernel by kernel above, on the path's own inputs)
    x_h = x2[:, :CONFIG_CHECK_T].contiguous()
    t0 = time.perf_counter()
    held = config_steps_vs_twins(torch, trainer, s_e1, x_h, gan, control)
    print(f"configs {name} B={CONFIG_CHECK_B} x 0.5 h from epoch 1's state, "
          f"kernels vs plain twins: {held} [{time.perf_counter() - t0:.1f} "
          "s]")
    del trainer, s_e1
    torch.cuda.empty_cache()
    return counts, run


def config_inference(torch, kernels, dev, run: Path, data: Path,
                     out: Path) -> dict:
    """`python -m encodec_tpu_torch.tools.inference --config
    encodec_tpu_torch/params/default.yaml` on `run`'s checkpoint (the l2
    run: default.yaml's model) over the synthetic nights' test split, with
    its own launch counts."""
    from encodec_tpu_torch.tools import inference

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    inference.main(["--config", config_path("default"), "--checkpoint",
                    str(run / "model.ckpt"), "--data_root", str(data),
                    "--dataset", "synth", "--out", str(out), "--device",
                    dev.type])
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    counts = launch_counts(kernels)
    files = sorted((out / "thorax").glob("*.npz"))
    shapes = []
    for f in files:
        with np.load(f) as z:
            codes = z["codes"]
        check(codes.dtype == np.int32 and codes.shape[0] == 8
              and 0 <= int(codes.min()) and int(codes.max()) < 1024,
              f"inference {f.name}: codes {codes.dtype} {codes.shape}")
        shapes.append(codes.shape)
    check(files and counts["rvq_encode_fused"] > 0
          and counts["lstm_grid"] > 0,
          f"inference wrote {len(files)} files, launches {counts}")
    print(f"configs inference (tools.inference --config "
          f"{config_path('default')} on the l2 run's model.ckpt): "
          f"{len(files)} nights' codes {shapes} in {took:.1f} s; launches "
          f"{json.dumps(counts)}")
    return counts


def phase_configs(torch, kernels, dev, names=CONFIG_RUNS,
                  control: bool = False):
    """Six published configs never trained on the card before
    (`CONFIG_RUNS`, or `names` of them) through `python -m
    encodec_tpu_torch.train`'s `main` on
    `encodec_tpu_torch/params/<name>.yaml` as written, with PyYAML hidden
    as on a machine without it, each with its own launch counts (see the
    module's docstring, item 16), then `tools.inference` on default.yaml
    after l2. `control` adds the twin steps' repeats
    (`config_steps_vs_twins`). Returns ({path: launch counts}, {kernel:
    rows of the paths' own shapes})."""
    import tempfile

    from encodec_tpu_torch.train import ConfigNamespace
    from encodec_tpu_torch.train import __main__ as train_entry

    had_yaml, yaml_module = "yaml" in sys.modules, sys.modules.get("yaml")
    sys.modules["yaml"] = None          # `import yaml` fails, as on the card
    tmp = tempfile.TemporaryDirectory()
    base = Path(tmp.name)
    data = base / "data"
    paths, rows = {}, {"K1": [], "K3 forward": [], "K3 backward": []}
    try:
        for c, chan in enumerate(("thorax", "abdominal")):
            (data / "synth" / chan).mkdir(parents=True)
            for i in range(8):
                np.savez(data / "synth" / chan / f"night{i}.npz",
                         data=breathing_signal(TRAIN_NIGHT,
                                               CONFIG_FIRST + 10 * i + c),
                         fs=10)
        l2 = published_config("l2", str(data))
        loader, _, _ = cut_epochs(train_entry.build_dataloaders)(
            ConfigNamespace(l2))
        x32 = torch.from_numpy(next(iter(loader))[0]["x"]).to(dev)
        check(tuple(x32.shape) == (32, l2["dataset"]["max_length"], 1),
              f"batch {tuple(x32.shape)}")
        for name in names:
            t0 = time.perf_counter()
            paths[name], run = config_run(torch, kernels, dev, name, data,
                                          base, x32, rows, control)
            if name == "l2":
                paths["inference"] = config_inference(
                    torch, kernels, dev, run, data, base / "codes")
            print(f"configs {name}: {time.perf_counter() - t0:.1f} s")
    finally:
        if had_yaml:
            sys.modules["yaml"] = yaml_module
        else:
            del sys.modules["yaml"]
        tmp.cleanup()
    return paths, rows


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


def ac_lanes(torch, S: int, K: int, card: int, T: int, seed: int,
             spread: tuple = (4000, 60000)) -> tuple:
    """S host-coded streams of T steps x K symbols under the CDF rows of a
    seeded random LM head: its product `acc` [T, K, S, card] (integers, as
    float64), bias [K, card] int32, exponent e0 = 4 and the exp2 table;
    lane s's logits spread over `spread[s % 2]` A10 units (60000: extreme
    skew, nearly every row one symbol). Returns (acc, head_b, e0, lut, the
    streams, symbols [T, S, K]); acc and head_b numpy, lut a CPU tensor."""
    from encodec_tpu_torch.models import ilm
    from encodec_tpu_torch.stream.ac import ArithmeticCoder

    rng = np.random.RandomState(seed)
    e0 = 4
    acc = np.stack([rng.randint(-spread[s % 2] << e0,
                                (spread[s % 2] << e0) + 1, (T, K, card))
                    for s in range(S)], 2).astype(np.float64)
    head_b = rng.randint(-2000, 2001, (K, card)).astype(np.int32)
    lut = torch.from_numpy(ilm.exp2_table().astype(np.int64))
    rows = np.stack([ilm._head_tail(torch.from_numpy(a),
                                    torch.from_numpy(head_b), e0, lut).numpy()
                     for a in acc])                          # [T, S, K, card]
    syms = np.zeros((T, S, K), np.int64)
    datas = []
    for s in range(S):
        fo = io.BytesIO()
        coder = ArithmeticCoder(fo)
        for t in range(T):
            for k in range(K):
                p = np.diff(np.concatenate([[0], rows[t, s, k]]))
                syms[t, s, k] = rng.choice(card, p=p / p.sum())
                coder.push(int(syms[t, s, k]), rows[t, s, k])
        coder.flush()
        datas.append(fo.getvalue())
    return acc, head_b, e0, lut, datas, syms


def ac_buffers(torch, datas, Ts, T: int, K: int, dev) -> dict:
    """The range decoder's device buffers for streams `datas` of `Ts`
    steps, as the decode runner (`models.ilm._DecodeGraph`) holds them,
    the step counter at 0."""
    from encodec_tpu_torch.stream import device_ac

    S = len(datas)
    buf = np.zeros((S, max(1, max(len(d) for d in datas))), np.uint8)
    for s, d in enumerate(datas):
        buf[s, :len(d)] = np.frombuffer(d, np.uint8)
    return dict(
        state=device_ac.init_state(S, dev),
        data=torch.from_numpy(buf).to(dev),
        nbits=torch.tensor([8 * len(d) for d in datas], device=dev),
        ts=torch.tensor(list(Ts), device=dev),
        t=torch.zeros(1, dtype=torch.int64, device=dev),
        codes=torch.zeros((T, S, K), dtype=torch.int64, device=dev),
        feed=torch.zeros((S, K), dtype=torch.int64, device=dev),
        ok=torch.ones(S, dtype=torch.bool, device=dev),
        eof=torch.zeros(S, dtype=torch.bool, device=dev))


AC_FIELDS = ("state", "codes", "feed", "ok", "eof")


def ac_call(fn, b: dict, acc, head: tuple) -> None:
    """One `ac_head_pull` (or twin) call on buffers `b` at their step, from
    the head's product `acc` and `head` = (head_b, e0, lut)."""
    head_b, e0, lut = head
    fn(b["state"], acc, head_b, e0, lut, b["data"], b["nbits"], b["ts"],
       b["t"], b["codes"], b["feed"], b["ok"], b["eof"])


def ac_compare(torch, kernels, sides: dict, label: str, t: int) -> None:
    got, want = sides[kernels.ac_head_pull], sides[kernels.ac_head_pull_plain]
    torch.cuda.synchronize()
    for name in AC_FIELDS:
        check(torch.equal(got[name], want[name]),
              f"{label}: ac_head_pull {name} differs from the twin at step "
              f"{t}")


def ac_hold(torch, kernels, accs, head: tuple, datas, Ts, label: str) -> dict:
    """`ac_head_pull` and its plain twin, both on the card, from the same
    inputs step by step (`accs` [T, K, S, card] on the card): the state,
    symbols, feed, ok and eof equal after every step. Returns the kernel's
    buffers."""
    T, K = accs.shape[:2]
    dev = accs.device
    sides = {fn: ac_buffers(torch, datas, Ts, T, K, dev)
             for fn in (kernels.ac_head_pull, kernels.ac_head_pull_plain)}
    for t in range(T):
        for fn, b in sides.items():
            ac_call(fn, b, accs[t], head)
            b["t"] += 1
        ac_compare(torch, kernels, sides, label, t)
    return sides[kernels.ac_head_pull]


def ac_head_of(ilm, K: int) -> tuple:
    """(head_b, e0, lut) of an integer LM's first K codebooks, as the
    decode runner hands them to the kernel."""
    return (ilm.iparams["head_b"][:K].int(), ilm.exps[0],
            ilm.iparams["lut"]["exp2"])


def ac_hold_request(torch, kernels, ilm, datas, Ts, K: int, n: int,
                    label: str):
    """The decode's first `n` steps by the eager runner on the card (the
    LM's part of each step, then `ac_head_pull` on the runner's buffers),
    with the twin on a copy of the buffers from the same product: every
    field equal after every step. Returns the step-0 product [K, S, card]
    (the kernel's timing input)."""
    from encodec_tpu_torch.models.ilm import _DecodeGraph

    head = ac_head_of(ilm, K)
    with torch.inference_mode():
        runner = _DecodeGraph(ilm, len(Ts), K, max(len(d) for d in datas),
                              max(Ts))
        runner.reset(datas, Ts)
        twin = {name: getattr(runner, name).clone()
                for name in ("data", "nbits", "ts", "t", "codes")}
        twin.update(state=runner.ac.clone(), feed=runner.feed.clone(),
                    ok=runner.ok.clone(), eof=runner.eof.clone())
        acc0 = None
        for t in range(min(n, max(Ts))):
            runner.lm()
            if acc0 is None:
                acc0 = runner.acc.clone()
            mine = dict(state=runner.ac, data=runner.data,
                        nbits=runner.nbits, ts=runner.ts, t=runner.t,
                        codes=runner.codes, feed=runner.feed, ok=runner.ok,
                        eof=runner.eof)
            ac_call(kernels.ac_head_pull, mine, runner.acc, head)
            ac_call(kernels.ac_head_pull_plain, twin, runner.acc, head)
            runner.t += 1
            twin["t"] += 1
            ac_compare(torch, kernels, {kernels.ac_head_pull: mine,
                                        kernels.ac_head_pull_plain: twin},
                       label, t)
    return acc0


def lm_card_rows(torch, ilm, lanes, steps: int, chunk: int = 256):
    """The card's CDF rows for the decoded `lanes` ([K, T_s] codes each,
    teacher-forced in lockstep from a fresh state, finished lanes fed zeros:
    the rows the decode's steps saw, bit for bit), on the host as
    [S, steps, K, card]."""
    S, K = len(lanes), lanes[0].shape[0]
    shifted = np.zeros((S, K, steps), np.int64)
    for s, c in enumerate(lanes):
        shifted[s, :, 1:c.shape[1]] = 1 + c[:, :-1]
    x = torch.from_numpy(shifted).to(ilm.device)
    out = np.empty((S, steps, K, ilm.card), np.int64)
    with torch.inference_mode():
        state = ilm.init_stream(S)
        for t0 in range(0, steps, chunk):
            rows, state = ilm.chunk_forward(x[:, :, t0:t0 + chunk], state)
            out[:, t0:t0 + rows.shape[1]] = rows.cpu().numpy()
    return out


def host_decode_lanes(datas, rows: np.ndarray, Ts) -> list:
    """Each lane decoded by the host range decoder (`make_decoder`: the
    native one) over the given rows [S, steps, K, card]: [K, T_s] each."""
    from encodec_tpu_torch.stream.ac import make_decoder

    out = []
    for s, (d, T) in enumerate(zip(datas, Ts)):
        dec = make_decoder(d)
        out.append(np.array([[dec.pull(rows[s, t, k])
                              for k in range(rows.shape[2])]
                             for t in range(T)], np.int64).T)
    return out


def ac_kernel_times(torch, kernels, acc, head: tuple, datas, Ts,
                    label: str) -> dict:
    """Device ms of one `ac_head_pull` launch (a decode step) on a request's
    first-step product `acc` [K, S, card], from a fresh state each call,
    beside its plain twin on the card and the bound: the product, head_b
    and the exp2 table read, the state in and out, nbits, ts and the step,
    the codes and feed out, the flags and the stream bytes the step
    consumed, at the HBM rate (≈20 integer operations per row entry at the
    FP32 rate take less). The twin is timed by CUDA events over 3 calls:
    it synchronizes in every turn of its bit loops, so its cost is the
    host's."""
    K, S, card = acc.shape
    b = ac_buffers(torch, datas, Ts, 1, K, acc.device)
    state0 = b["state"].clone()

    def run(fn):
        def call():
            b["state"].copy_(state0)
            ac_call(fn, b, acc, head)
        return call

    run(kernels.ac_head_pull)()
    torch.cuda.synchronize()
    bits = int((b["state"][:, 4] - state0[:, 4]).sum())
    ms = device_ms(torch, run(kernels.ac_head_pull), 50,
                   "ac_head_pull_kernel")
    call_ms = time_ms(torch, run(kernels.ac_head_pull), 50)
    plain_ms = time_ms(torch, run(kernels.ac_head_pull_plain), 3)
    nbytes = (S * K * card * 8 + K * card * 4 + 1024 * 8 + 2 * S * 5 * 8
              + 2 * S * 8 + 8 + 2 * S * K * 8 + 4 * S + -(-bits // 8))
    b_ms, b_by = bound(20.0 * S * K * card, nbytes)
    print(f"AC ac_head_pull {label} (S={S}, K={K}, card={card}; "
          f"{bits} stream bits): device ms: kernel={ms:.4f} "
          f"plain (events)={plain_ms:.4f} library=none bound={b_ms:.6f} "
          f"({b_by}, {nbytes} B); per wrapper call (events)={call_ms:.4f}; "
          f"{ms * 1e3 / K:.3f} us per pull with its row")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by)


def ac_synthetic(torch, kernels, dev) -> None:
    """The kernel against its twin on synthetic streams under a seeded
    random head's rows: card 16 and 1024, extreme skew, ragged lanes
    (inactive ones), a cut stream (eof), flipped bytes and a stream of
    0xFF bytes (past every interval at its first pull: ok false) beside
    an intact lane."""
    t0 = time.perf_counter()
    for card in (16, 1024):
        for S, K in ((2, 32), (11, 16)):
            T = 6
            acc, head_b, e0, lut, datas, syms = ac_lanes(
                torch, S, K, card, T, seed=card + S)
            Ts = [T - (s % 3) for s in range(S)]
            b = ac_hold(torch, kernels, torch.from_numpy(acc).to(dev),
                        (torch.from_numpy(head_b).to(dev), e0, lut.to(dev)),
                        datas, Ts, f"synthetic card={card} S={S} K={K}")
            codes = b["codes"].cpu().numpy()
            check(all(np.array_equal(codes[:n, s], syms[:n, s])
                      and not codes[n:, s].any() for s, n in enumerate(Ts))
                  and bool(b["ok"].all()) and not bool(b["eof"].any()),
                  f"ac_head_pull card={card} S={S}: symbols differ from the "
                  "coded ones")
    T, K, card = 8, 16, 1024
    acc, head_b, e0, lut, datas, syms = ac_lanes(torch, 5, K, card, T,
                                                 seed=9)
    bad = list(datas)
    bad[1] = datas[1][:len(datas[1]) // 2]
    for s in (2, 3):
        flipped = bytearray(datas[s])
        flipped[(s - 1) * len(flipped) // 5] ^= 0xFF
        bad[s] = bytes(flipped)
    bad[4] = b"\xff" * len(datas[4])
    b = ac_hold(torch, kernels, torch.from_numpy(acc).to(dev),
                (torch.from_numpy(head_b).to(dev), e0, lut.to(dev)), bad,
                [T] * 5, "cut and corrupt streams")
    ok, eof = b["ok"].cpu(), b["eof"].cpu()
    check(bool(ok[0]) and not bool(eof[0]) and np.array_equal(
        b["codes"][:, 0].cpu().numpy(), syms[:, 0]) and bool(eof[1])
          and not bool(ok[4]),
          f"ac_head_pull: bad streams not flagged (ok {ok.tolist()}, eof "
          f"{eof.tolist()})")
    print(f"AC ac_head_pull vs twin on the card: synthetic card 16 and 1024 "
          f"(logit spreads 4000 / 60000 A10), S=2 K=32 and S=11 K=16, "
          f"ragged lanes, every field equal every step; cut stream eof "
          f"{eof.tolist()}, flipped bytes and 0xFF ok {ok.tolist()} "
          f"({time.perf_counter() - t0:.1f} s)")


def phase_lm(torch, kernels, model, model48, wav24, wav48):
    """LM entropy coding (lmv=3) on the card, counted as one path: the
    integer LMs at the published widths (24 kHz: dim 200, 8 heads, 5
    layers, card 1024, n_q 32, W=262; 48 kHz: n_q 16, W=525) with seeded
    random weights; the 10 s 24 kHz request at 6 and 24 kbps with
    `lm_restart="auto"` (2 lanes of 375 steps) and at 6 kbps unblocked (one
    lane of 750), and the 10 s 48 kHz request at 24 kbps (11 segments in
    lockstep, the `fl` index), each compressed and decompressed on the
    card, the decode step a replayed CUDA graph per (lanes, codebooks)
    whose range decoder is `ac_head_pull` (the LM's CDF head fused in; one
    launch per decode step, replays counted). Checks: decoded codes equal
    the writer's (tie-guarded) codes and the `cc` CRC passes, and equal
    the host range decoder's over the card's own rows at every position;
    `ac_head_pull` launched once per decode step; the kernel equals its
    twin on the card on the requests' first 12 steps of the eager runner
    and on synthetic streams (card 16 and 1024, extreme skew, inactive
    lanes, a cut and a corrupt stream); the audio equals the raw path's
    decode of the same codes; each file equals, byte for byte, the one the
    port's CPU LM writes from the same codes; CUDA CDF rows equal the
    CPU's. Returns (launch counts, the kernel's JSON metrics)."""
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

    # and a spy on the lockstep decode keeps its streams, codes, time and
    # the range decoder's launches
    lockstep = IntLMModel.decode_lockstep
    lockstep_calls = []

    def lockstep_spy(self, datas, K, Ts):
        before = kernels.ac_head_pull.launches
        t0 = time.perf_counter()
        codes = lockstep(self, datas, K, Ts)
        lockstep_calls.append(dict(
            datas=list(datas), K=K, Ts=list(Ts), codes=codes,
            seconds=time.perf_counter() - t0,
            launches=kernels.ac_head_pull.launches - before))
        return codes

    compress_module.read_frames = spy
    IntLMModel.decode_lockstep = lockstep_spy
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
    IntLMModel.decode_lockstep = lockstep
    check(len(decoded) == len(served) == len(lockstep_calls),
          "decompress did not read its frames through read_frames and one "
          "lockstep decode")
    print(f"lm path launches: {json.dumps(counts)}")
    steps_all = sum(max(c["Ts"]) for c in lockstep_calls)
    check(counts["nearest_codebook"] > 0 and counts["lstm_scan"] > 0
          and counts["rvq_encode_fused"] == 0
          and counts["ac_head_pull"] == steps_all,
          f"the LM path did not launch K1 and K3 (and no K2), or not one "
          f"ac_head_pull per decode step ({counts['ac_head_pull']} for "
          f"{steps_all} steps)")

    # -- verification, not counted --------------------------------------
    for r, (frames, al, decode_s), call in zip(served, decoded,
                                               lockstep_calls):
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
        check(call["Ts"] == Ts and call["launches"] == steps
              and all(np.array_equal(call["codes"][s, :, :T], b)
                      for s, (T, b) in enumerate(zip(Ts, blocks))),
              f"{r['label']}: the lockstep decode's lanes or its "
              f"{call['launches']} ac_head_pull launches for {steps} steps")
        # the graph is captured: a second decode is replays only
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = gpu.decode_lockstep(call["datas"], call["K"], Ts)
        again_s = time.perf_counter() - t0
        check(np.array_equal(again, call["codes"]),
              f"{r['label']}: a second decode gave other codes")
        # the host range decoder over the card's own rows: every position
        t0 = time.perf_counter()
        rows_host = lm_card_rows(torch, gpu, blocks, steps)
        host = host_decode_lanes(call["datas"], rows_host, Ts)
        check(all(np.array_equal(h, b) for h, b in zip(host, blocks)),
              f"{r['label']}: the card's codes differ from the host "
              "decoder's over the card's rows")
        n_hold = 12
        acc0 = ac_hold_request(torch, kernels, gpu, call["datas"], Ts,
                               call["K"], n_hold, r["label"])
        host_s = time.perf_counter() - t0
        r.update(Ts=Ts, blocks=blocks, meta=meta, datas=call["datas"],
                 acc0=acc0, first_s=call["seconds"], again_s=again_s)
        del rows_host
        dl_s = call["seconds"]
        print(f"lm request {r['label']}: K={meta['nc']}, {len(Ts)} lanes x "
              f"{steps} steps; {len(data)} B vs raw {len(raw)} B ("
              f"{len(data) / len(raw):.4f}); compress {r['compress_s'] * 1e3:.1f}"
              f" ms, decompress {r['decompress_s'] * 1e3:.1f} ms; teacher-"
              f"forced LM encode {encode_s * 1e3:.1f} ms; range decode "
              f"(decode_lockstep, the graph's capture included) "
              f"{dl_s * 1e3:.1f} ms = {dl_s / steps * 1e3:.3f} ms per step, "
              f"{dl_s / seconds * 1e3:.1f} ms per s of audio, "
              f"{call['launches']} ac_head_pull launches = steps (read_frames "
              f"{decode_s * 1e3:.1f} ms); a second decode (replays only) "
              f"{again_s * 1e3:.1f} ms = {again_s / steps * 1e3:.3f} ms per "
              f"step, {again_s / seconds * 1e3:.1f} ms per s of audio; "
              f"codes = written = host decoder's over the card's rows, "
              f"kernel = twin over the eager runner's first {n_hold} steps, cc "
              f"ok, audio = raw decode, file = CPU writer's (CPU writer "
              f"{cpu_s * 1e3:.1f} ms, raw decode and checks "
              f"{check_s * 1e3:.1f} ms, host decoder and twin checks "
              f"{host_s * 1e3:.1f} ms)")
    t0 = time.perf_counter()
    print(f"lm portability: 24 kHz "
          f"{lm_rows_equal(torch, IntLMModel.from_lm(lm24), cpu24, served[1]['blocks'])}"
          f"; 48 kHz {lm_rows_equal(torch, IntLMModel.from_lm(lm48), cpu48, served[3]['blocks'])}"
          f" ({(time.perf_counter() - t0) * 1e3:.1f} ms)")
    t0 = time.perf_counter()

    # the range decoder: against its twin on synthetic streams, and timed
    # at the requests' shapes (24 kbps: S=2, K=32; 48 kHz: S=11, K=16)
    ac_synthetic(torch, kernels, model.device)
    ac_times = {}
    for i in (1, 3):
        r = served[i]
        ac_times[i] = ac_kernel_times(
            torch, kernels, r["acc0"],
            ac_head_of(IntLMModel.from_lm(r["lm"]), r["meta"]["nc"]),
            r["datas"], r["Ts"], r["label"])
    ac_s = time.perf_counter() - t0

    # per request: the decode step as graph replays and as the eager
    # runner's steps, profiled (the request's own streams, from step 0)
    for r in served:
        gpu = IntLMModel.from_lm(r["lm"])
        S, K = len(r["Ts"]), r["meta"]["nc"]
        line = []
        with torch.inference_mode():
            runner = gpu._decode_graphs[S, K]
            check(runner.graph is not None,
                  f"{r['label']}: the decode captured no graph")
            for name, fn in (("graph replay", lambda: runner.run(1)),
                             ("eager runner", runner.step)):
                line.append(f"{name}: " + decode_profile(
                    torch, runner, cycling(runner, fn, r["datas"], r["Ts"])))
        print(f"lm decode profile, {r['label']} (S={S}, K={K}): "
              f"{'; '.join(line)}; first decode (capture included) "
              f"{r['first_s'] * 1e3:.1f} ms, again {r['again_s'] * 1e3:.1f} "
              f"ms")
    print(f"lm profiles {time.perf_counter() - t0:.1f} s (the range "
          f"decoder's checks and times {ac_s:.1f} s); lm phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts, dict(ac_times[1], max_abs_err=0)


def cycling(runner, fn, datas, Ts):
    """`fn` (one decode step of `runner`) that returns the runner to step 0
    of the streams every max(Ts) calls, so that every profiled step decodes
    active lanes."""
    done = [0]
    runner.reset(datas, Ts)

    def call():
        if done[0] == max(Ts):
            runner.reset(datas, Ts)
            done[0] = 0
        fn()
        done[0] += 1
    return call


def decode_profile(torch, runner, fn, n: int = 8) -> str:
    """One decode step (`fn`) profiled over windows of `n` steps: wall per
    step, device busy, launches per step (the kernel's among them) and the
    idle share, and the CUDA-event span per step of 50 back-to-back steps
    (for graph replays, the device's time per step with the gaps between
    the graph's nodes)."""
    window = kernel_window(torch, fn, n, required=False)
    span = time_ms(torch, fn, 50)
    if window is None:
        return (f"profiler windows unusable (not measured); CUDA-event "
                f"span {span:.3f} ms per step")
    records, wall = window
    busy = sum(us for _, us in records.values()) / n / 1e3
    launches = sum(k for k, _ in records.values()) / n
    ac_us = sum(us for key, (_, us) in records.items()
                if "ac_head_pull_kernel" in key) / n
    return (f"wall {wall / n:.3f} ms per step, device busy {busy:.4f} ms "
            f"(ac_head_pull {ac_us / 1e3:.4f}), {launches:.1f} launches per "
            f"step, idle share {1 - busy * n / wall:.3f}; CUDA-event span "
            f"{span:.3f} ms per step")


LM_TRAIN_LR = 1e-3     # 20 steps on one batch must lower the entropy


def lm_step_split(torch, fn, attention_batch: int) -> tuple:
    """Device ms of one LM training step (`fn`, after a warm-up call) by
    group, from one profiler window with CPU ops and their input shapes: a
    kernel belongs to the aten op that launched it. Groups: `Adam` (the
    step's `lm_train.adam` range), `attention` (the score and value
    matmuls, whose batch is B·heads = `attention_batch`, their softmax and
    mask, forward and backward), `head matmul` (the per-codebook head's
    batched matmuls), `linear matmul` (the trunk's q/k/v/out/FFN
    matmuls), `loss` (log-softmax and NLL of the cross-entropy, forward
    and backward), `embedding` (the gather and its scatter-add) and
    `other` (norms, GELU, layout copies, elementwise). Returns ({group:
    ms}, wall ms, launches)."""
    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    def in_range(e, name):
        while e is not None:
            if e.name == name:
                return True
            e = e.cpu_parent
        return False

    out: dict = {}
    launches = 0
    for e in prof.events():
        kern = getattr(e, "kernels", None)
        if not kern:
            continue
        launches += len(kern)
        shapes = [sh for sh in (e.input_shapes or [])
                  if isinstance(sh, (list, tuple)) and sh]
        lead = shapes[0][0] if shapes else None
        name = e.name
        if in_range(e, "lm_train.adam"):
            group = "Adam"
        elif name in ("aten::bmm", "aten::baddbmm"):
            group = "attention" if lead == attention_batch else "head matmul"
        elif name in ("aten::mm", "aten::addmm"):
            group = "linear matmul"
        elif "softmax" in name and any(len(sh) == 4 and sh[1] != 1024
                                       for sh in shapes):
            group = ("loss" if "log_softmax" in name else "attention")
        elif "softmax" in name or "nll_loss" in name:
            group = "loss"
        elif "masked_fill" in name:
            group = "attention"
        elif "index" in name or "embedding" in name:
            group = "embedding"
        else:
            group = "other"
        out[group] = out.get(group, 0.0) + sum(k.duration for k in kern) / 1e3
    return out, wall_ms, launches


def phase_lm_train(torch, kernels, model, registry, run_dir):
    """Training an entropy prior on the port's own codes, then coding with
    it, at full width (`lm_config_for` the 24 kHz codec: n_q 32, card 1024,
    dim 200, 8 heads, 5 layers, W=262), counted as one path: the 24 kHz
    model encodes 16 seeded 10 s requests at 24 kbps (codes [16, 32, 750]:
    K2, K3); a seeded LM takes 20 steps of `make_lm_train_step` on them
    (B=16 x T=750); the trained LM codes a held-out 10 s request
    (`compress`, lmv=3 in 375-token blocks: K1 in the tie guard, K3) and
    the file is read back
    (`read_frames`) and decoded on the card; `tools.export` writes the
    `.th` of `phase_train`'s run directory; `tools.batch` compresses 4 wavs
    of different lengths (one shorter than a chunk) at 6 kbps through the
    streaming extractor (K3 from a carried state, K2) and decompresses
    them; `tools.benchmark.bench` runs once. Checks, not counted: the
    training lowers bits per code; one step (B=4) on the card against the
    CPU port from the same state; `forward_batch` against `scan` and
    `__call__`; the card's decoded codes and the CPU's against the written
    ones and the file against the CPU writer's; the export and the LM's
    state dict reloaded bit for bit; the batch files against per-file
    `compress_to_file` and `decompress`."""
    import tempfile

    from encodec_tpu_torch.models.ilm import IntLMModel
    from encodec_tpu_torch.models.lm import LMModel, init_lm, lm_config_for
    from encodec_tpu_torch.models.model import (encode_frame,
                                                encode_frame_margins)
    from encodec_tpu_torch.models.zoo import (load_pretrained,
                                              lm_params_from_state,
                                              torch_state_from_lm_params)
    from encodec_tpu_torch.stream import binary, compress, decompress
    from encodec_tpu_torch.stream.compress import (compress_to_file,
                                                   read_frames,
                                                   write_lm_payload)
    from encodec_tpu_torch.tools import batch, benchmark, export
    from encodec_tpu_torch.train import load_checkpoint, load_config
    from encodec_tpu_torch.train.lm_train import (create_lm_train_state,
                                                  make_lm_train_step,
                                                  shift_codes)
    from encodec_tpu_torch.train.optim import AdamState, tree_leaves, tree_map
    from encodec_tpu_torch.train.trainer import (model_from_config,
                                                 state_to_device)
    from encodec_tpu_torch.utils.audio import convert_audio, load_wav, save_wav

    t_phase = time.perf_counter()
    dev = model.device
    cfg = lm_config_for(model)
    check((cfg.n_q, cfg.card, cfg.dim, cfg.num_heads, cfg.num_layers,
           cfg.past_context) == (32, 1024, 200, 8, 5, 262),
          f"not the published LM widths: {cfg}")
    tmp = tempfile.TemporaryDirectory()
    base = Path(tmp.name)
    wavs = np.stack([request_audio(10.0, 24000, 300 + i) for i in range(16)])
    sr = model.sample_rate
    lengths = (2 * sr, int(5.3 * sr), 7 * sr + 100, 10 * sr + 17)
    (base / "in").mkdir()
    for i, n in enumerate(lengths):
        save_wav(request_audio(n / sr, sr, 400 + i), base / "in" / f"w{i}.wav",
                 sr)
    chunk_hops = 256            # 81,920 samples: the 2 s file is shorter

    # -- the lm_train path, counted: nothing but user calls in here ---------
    model.set_target_bandwidth(24.0)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes = model.encode(wavs)[0][0]                     # [16, 32, 750]
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    counts_codes = launch_counts(kernels)
    params = init_lm(torch.Generator().manual_seed(80), cfg, device=dev)
    opt, opt_state = create_lm_train_state(params, lr=LM_TRAIN_LR)
    step = make_lm_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    step_ms, bits = [], []
    for i in range(20):
        if i == 19:
            before = (params, opt_state)
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, codes)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        bits.append(float(m["bits_per_code"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lm = LMModel(cfg, params, device=dev)
    wav = request_audio(10.0, sr, 316)          # not in the training batch
    torch.cuda.synchronize()
    t_c = time.perf_counter()
    data = compress(model, wav, use_lm=True, lm=lm, models=registry,
                    lm_restart="auto")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, decoded, al = read_frames(io.BytesIO(data), models=registry, lm=lm)
    audio = model.decode(decoded)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    th = export.export_run(str(run_dir), out_dir=str(base / "export"),
                           device=dev)
    model.set_target_bandwidth(6.0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t3 = time.perf_counter()
        ecdcs = batch.compress_directory(
            model, str(base / "in"), str(base / "ecdc"), models=registry,
            chunk_hops=chunk_hops)
        outs = batch.decompress_directory(str(base / "ecdc"),
                                          str(base / "out"), models=registry)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t3
    bench = benchmark.bench(model, lm=lm, seconds=10.0, bandwidth=12.0)
    counts = launch_counts(kernels)
    print(f"lm_train path launches: {json.dumps(counts)}; the training "
          f"codes alone: {json.dumps(counts_codes)}")
    check(counts_codes["rvq_encode_fused"] > 0
          and counts_codes["lstm_scan"] > 0,
          f"the training codes did not launch K2 and K3: {counts_codes}")
    check(counts["nearest_codebook"] > 0 and counts["lstm_scan_backward"] == 0,
          f"the lm_train path did not launch K1 (or ran K3's backward): "
          f"{counts}")

    # -- verification, not counted ------------------------------------------
    check(tuple(codes.shape) == (16, 32, 750)
          and bool(((codes >= 0) & (codes < 1024)).all()),
          f"training codes {tuple(codes.shape)}")
    # the training codes (K2 at N=12,000, K3 at B=16) against the plain
    # twins on the same [16, 1, 240000] input: equal outside the positions
    # the plain search flags as near-ties
    x16 = torch.from_numpy(wavs).to(dev).transpose(1, 2)
    with torch.inference_mode():
        plain, _ = encode_frame(model.infer_params, model.qstate, x16,
                                model.cfg, 32, plain=True)
        _, _, _, margins = encode_frame_margins(
            model.infer_params, model.qstate, x16, model.cfg, 32, plain=True)
    flagged = (margins < TIE_THRESHOLD).any(1)                  # [16, T']
    diff = (plain != codes).any(1)                              # [16, T']
    n_unflagged = int((diff & ~flagged).sum())
    check(n_unflagged == 0, f"training codes: {n_unflagged} positions differ "
                            "from the plain twins outside the tie guard")
    print(f"lm train codes [16, 32, 750] vs plain twins on the same input: "
          f"{int(diff.sum())} of {diff.numel()} positions differ, all inside "
          f"the {int(flagged.sum())} tie-flagged ones")
    del x16, plain, margins
    check(all(math.isfinite(b) for b in bits) and bits[-1] < bits[0],
          f"LM training did not lower bits per code: {bits}")
    warm = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    groups, wall_ms, n_launch = lm_step_split(
        torch, lambda: step(params, opt_state, codes), 16 * cfg.num_heads)
    busy = sum(groups.values())
    print(f"lm train (B=16 x T=750, K=32, full width, Adam lr "
          f"{LM_TRAIN_LR}): codes encoded in {encode_s * 1e3:.1f} ms; 20 "
          f"steps, first {step_ms[0]:.1f} ms, warm median {warm:.2f} ms per "
          f"step (min {min(step_ms[1:]):.2f}, max {max(step_ms[1:]):.2f}); "
          f"peak memory {peak:.2f} GiB; bits per code {bits[0]:.4f} -> "
          f"{bits[-1]:.4f}")
    print(f"profile lm train step: wall {wall_ms:.1f} ms (profiled), "
          f"{n_launch} kernel launches, device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}; by group: " + ", ".join(
              f"{g} {ms:.2f} ms" for g, ms in sorted(groups.items(),
                                                     key=lambda kv: -kv[1])))

    # one step (B=4) on the card and on the CPU port from the same state:
    # the loss within 1e-4 relative, every parameter within 0.2 lr (Adam
    # divides each gradient entry by its second moment's root, so float32
    # noise of a small entry moves its weight by a fraction of lr)
    sub = codes[:4].contiguous()
    p_c, s_c, m_c = step(before[0], before[1], sub)
    cpu_state = AdamState(*tree_map(lambda t: t.cpu(), tuple(before[1])))
    p_h, s_h, m_h = step(tree_map(lambda t: t.cpu(), before[0]), cpu_state,
                         sub.cpu())
    loss_err = abs(m_c["nll"].item() - m_h["nll"].item()) / abs(
        m_h["nll"].item())
    p_err = max((a.cpu() - b).abs().max().item()
                for a, b in zip(tree_leaves(p_c), tree_leaves(p_h)))
    check(loss_err <= 1e-4 and p_err <= 0.2 * LM_TRAIN_LR,
          f"LM step, card vs CPU: loss {loss_err:.3g} relative, parameters "
          f"{p_err:.3g} (limits 1e-4, {0.2 * LM_TRAIN_LR:.3g})")
    idx = shift_codes(codes[:1].long())
    fb_ms = time_ms(torch, lambda: lm.forward_batch(idx), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan = lm.scan(idx)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    fb = lm.forward_batch(idx)
    called = lm(idx)[0]
    err_scan = (scan - fb).abs().max().item()
    err_call = (called - fb).abs().max().item()
    check(err_scan <= 1e-5 and err_call <= 1e-5,
          f"forward_batch vs scan {err_scan:.3g}, vs __call__ {err_call:.3g}")
    print(f"lm float paths on the card (one request, K=32, T=750): "
          f"forward_batch {fb_ms:.3f} ms, scan {scan_s * 1e3:.1f} ms = "
          f"{scan_s / 750 * 1e3:.3f} ms per step; |scan - forward_batch| "
          f"{err_scan:.3g}, |__call__ - forward_batch| {err_call:.3g}; one "
          f"step B=4 card vs CPU: loss {loss_err:.3g} relative, parameters "
          f"within {p_err:.3g}")

    # the trained LM's file: the card's and the CPU's decode give the
    # written codes, the CPU writer writes the same bytes
    model.set_target_bandwidth(24.0)
    written, _ = model.encode_guarded(wav[None], TIE_THRESHOLD)
    check(np.array_equal(decoded[0][0].numpy(), written[0][0].cpu().numpy()),
          "the card's decode differs from the written codes")
    check(tuple(audio.shape) == (1, 1, 240_000)
          and bool(torch.isfinite(audio).all()), "decoded audio")
    lm_cpu = LMModel(cfg, params, device="cpu")
    t0 = time.perf_counter()
    _, cpu_frames, _ = read_frames(io.BytesIO(data), models=registry,
                                   lm=lm_cpu)
    cpu_decode_s = time.perf_counter() - t0
    check(np.array_equal(cpu_frames[0][0].numpy(),
                         written[0][0].cpu().numpy()),
          "the CPU's decode differs from the written codes")
    meta = binary.read_ecdc_header(io.BytesIO(data))
    cpu_file = io.BytesIO()
    write_lm_payload(cpu_file, {k: meta[k] for k in ("m", "al", "nc", "lm")},
                     [(f[0].cpu(), f[1]) for f in written],
                     IntLMModel.from_lm(lm_cpu), meta.get("lmb"))
    check(cpu_file.getvalue() == data,
          "the card's lmv=3 file differs from the CPU writer's")
    raw = raw_ecdc(model, written, al)
    print(f"lm train coding: a held-out 10 s @ 24 kbps with the trained LM, "
          f"{len(meta['fl'])} blocks of {meta['lmb']}: {len(data)} B vs raw "
          f"{len(raw)} B ({len(data) / len(raw):.4f}); on the card compress "
          f"{(t1 - t_c) * 1e3:.1f} ms, read_frames + decode "
          f"{(t2 - t1) * 1e3:.1f} ms; CPU read_frames "
          f"{cpu_decode_s * 1e3:.1f} ms; codes = written (card and CPU), "
          f"file = CPU writer's")

    # the export and the LM's state dict, reloaded bit for bit
    fresh = model_from_config(load_config(export.run_config_path(
        str(run_dir))), device=dev)
    load_pretrained(fresh, Path(th).name, str(Path(th).parent))
    raw_state, epoch, _ = load_checkpoint(Path(run_dir) / "model.ckpt")
    saved = state_to_device(raw_state, dev)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(fresh.params), tree_leaves(saved.params))) and all(
        torch.equal(a, b) for a, b in zip(fresh.qstate[:3], saved.qstate[:3]))
    check(same, "the exported .th does not reload bit for bit")
    back = lm_params_from_state(torch_state_from_lm_params(params), cfg.n_q,
                                cfg.num_layers)
    check(all(torch.equal(a.to(dev), b) for a, b in zip(
        tree_leaves(back), tree_leaves(params))),
        "the LM's state dict does not reload bit for bit")
    print(f"export: {Path(th).name} ({Path(th).stat().st_size} B, epoch "
          f"{epoch} of phase_train's run) reloads bit for bit through "
          "load_pretrained on the card; the trained LM through "
          "torch_state_from_lm_params -> lm_params_from_state bit for bit")

    # the batch tool against per-file compression and decompression
    short = [w for w in caught if "shorter than the shared" in str(w.message)]
    check(len(short) == 1, f"the batch tool warned {len(short)} times of a "
                           "file shorter than a chunk, not once")
    model.set_target_bandwidth(6.0)
    n_equal = max_lsb = 0
    for i, (path, out) in enumerate(zip(ecdcs, outs)):
        w, wsr = load_wav(base / "in" / f"w{i}.wav")
        ref = io.BytesIO()
        compress_to_file(model, convert_audio(w, wsr, sr, 1), ref,
                         models=registry)
        got = Path(path).read_bytes()
        check(got == ref.getvalue(), f"batch file w{i}.ecdc differs from "
                                     "per-file compress_to_file")
        back_wav, _ = decompress(got, models=registry)
        save_wav(back_wav.cpu().numpy(), base / "ref.wav", sr)
        ours = np.frombuffer(Path(out).read_bytes()[44:], np.int16)
        ref_pcm = np.frombuffer((base / "ref.wav").read_bytes()[44:],
                                np.int16)
        check(ours.shape == ref_pcm.shape, f"batch wav w{i}: length")
        d = np.abs(ours.astype(np.int64) - ref_pcm)
        max_lsb = max(max_lsb, int(d.max()))
        n_equal += int(d.max() == 0)
    check(max_lsb <= 1, f"batch wavs {max_lsb} int16 steps from per-file "
                        "decompress")
    print(f"batch tool: {len(ecdcs)} files of {list(lengths)} samples at 6 "
          f"kbps (chunk {chunk_hops} hops; one shorter, warned once) in "
          f"{batch_s * 1e3:.1f} ms compress+decompress; bytes = per-file "
          f"compress_to_file; wavs vs per-file decompress: {n_equal} equal, "
          f"max {max_lsb} int16 steps")
    check(all(bench[k] > 0 for k in ("encode_s", "decode_s", "lm_batched_s",
                                     "ac_encode_s", "ac_decode_s")),
          f"benchmark: {bench}")
    print(f"benchmark: {json.dumps(bench)}")
    tmp.cleanup()
    print(f"lm_train phase {time.perf_counter() - t_phase:.1f} s")
    return counts


# -- the parallel phase ------------------------------------------------------
#
# torch.distributed on one card: (a) NCCL at world 1 in this process (the
# production backend and code path), (b) gloo at world 2, both ranks on
# cuda:0 (NCCL refuses two ranks on one device), CUDA tensors staged
# through host memory (`parallel.comm`). Two ranks sharing one card measure
# correctness, not scaling.

PAR_WORLD = 2
PAR_B_DP, PAR_B_GAN = 8, 4        # global batches of (b)'s DP and GAN checks
PAR_LM_LAYERS, PAR_LM_B, PAR_LM_M = 4, 16, 4
# The share of untied positions (every stage's top-2 margin >= 1e-3) whose
# codes may differ between the ranks' B=4 encoder passes and the single
# process's B=8 one: cuDNN picks algorithms per shape, and at the
# breathing latents' scale (squared distances of tens to hundreds) their
# rounding can exceed an absolute margin of 1e-3. Measured on NVIDIA H100
# 80GB HBM3, 700.00 W: 7 and 10 of ≈2,490 (0.28%, 0.40%) with cuDNN's
# default algorithms, 9 of 2,482 (0.36%) with the deterministic ones that
# (b) now runs, which repeat run to run; 0 in the GAN step. Held to 0.5%;
# the CPU tests hold every untied position.
PAR_CODES_OFF = 0.005


def par_leaves(tree, prefix: str = ""):
    """(path, tensor) of a tree's tensor leaves, in JAX's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from par_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from par_leaves(v, f"{prefix}/{i}")
    elif tree is not None and hasattr(tree, "shape"):
        yield prefix, tree


def par_cpu(tree):
    from encodec_tpu_torch.train.optim import tree_map
    return tree_map(lambda t: t.detach().cpu().clone()
                    if hasattr(t, "detach") else t, tree)


def par_record(torch, state, m) -> dict:
    """A step's result on the host: metrics, the state, the gradient."""
    out = {"metrics": {k: float(v) for k, v in m.items()
                       if hasattr(v, "dim") and v.dim() == 0},
           "params": par_cpu(state.params),
           "qstate": par_cpu(tuple(state.qstate[:3])),
           "rng": state.rng.clone(), "grads": par_cpu(m.get("grads"))}
    if state.disc_params is not None:
        out["disc"] = par_cpu(state.disc_params)
    if "codes" in m:
        out["codes"] = m["codes"].cpu()
        out["margins"] = m["margins"].cpu()
    return out


def par_codes(torch, codes, ref: dict) -> tuple:
    """The DP codes `[B, K, T]` (every rank's rows in rank order) against
    the single process's at the positions (b, t) where no stage's search
    is tie-flagged (a flip at one stage changes the residual of every
    later one); returns (untied positions, of which differ)."""
    K = codes.shape[1]
    margins = ref["margins"].reshape(K, codes.shape[0], -1)
    safe = (margins >= TIE_THRESHOLD).all(0)                 # [B, T]
    moved = (codes != ref["codes"]).any(1)                   # [B, T]
    return int(safe.sum()), int(moved[safe].sum())


def par_book_mask(torch, codes, ref: dict, start, rvq_cfg) -> tuple:
    """The codebook entries `[books, bins]` on which a DP step (codes
    `[B, K, T]`, every rank's rows in rank order) and the single process's
    step `ref`, both from the state `start`, must agree. A position whose
    code differs first at stage k0 brings other residuals to every later
    stage: from k0 on, the clusters it was assigned on either side are
    left out, in that stage's book. An expired cluster takes a row of the
    stage's residual, drawn over the global batch (the draws replayed here
    from `start`'s generator and checked against the state the step ends
    in): it is left out when that row's position differs at an earlier
    stage, and so is a cluster whose count comes within 1e-3 of the
    threshold. Returns (keep, then how many clusters were left out for a
    code, for a drawn row, at the threshold)."""
    from encodec_tpu_torch.quant.rvq import _draw

    B, K, T = codes.shape
    got = codes.permute(1, 0, 2).reshape(K, B * T).long()   # rows b·T + t
    want = ref["codes"].permute(1, 0, 2).reshape(K, B * T).long()
    differs = got != want
    first = torch.where(differs.any(0), differs.int().argmax(0),
                        torch.full((B * T,), K))
    bins = ref["qstate"][2].shape[1]
    by_code = torch.zeros(ref["qstate"][2].shape, dtype=torch.bool)
    by_draw, at_thr = by_code.clone(), by_code.clone()
    gen = torch.Generator()
    gen.set_state(start.rng)
    size = start.qstate.cluster_size.detach().cpu().clone()
    thr = rvq_cfg.threshold_ema_dead_code
    for k in range(K):
        b = 0 if rvq_cfg.shared_codebook else k
        fed = first <= k
        by_code[b, got[k, fed]] = True
        by_code[b, want[k, fed]] = True
        if thr > 0:
            rows = _draw(B * T, bins, gen, torch.device("cpu"))
            size[b] = (size[b] * rvq_cfg.decay
                       + torch.bincount(want[k], minlength=bins).float()
                       * (1 - rvq_cfg.decay))
            at_thr[b] |= (size[b] - thr).abs() < 1e-3
            by_draw[b] |= (size[b] < thr) & (first[rows] < k)
    check(torch.equal(gen.get_state(), ref["rng"]),
          "par_book_mask: the replayed draws do not end in the step's "
          "generator state")
    keep = ~(by_code | by_draw | at_thr)
    return (keep, int(by_code.sum()), int((by_draw & ~by_code).sum()),
            int((at_thr & ~by_code & ~by_draw).sum()))


def par_compare(torch, got: dict, ref: dict, lr: float, steps, what: str,
                key: str = "params", books=None) -> tuple:
    """`got` (a rank's step) against `ref` (the single process's on the
    global batch, from the same state) at JAX's mesh bounds: losses rtol
    1e-4 (the gradient norm 2e-3),
    the codebooks rtol 2e-3 atol 2e-5, the generator state equal; the
    parameters rtol 2e-3 atol 2e-5 where every step's gradient (`steps`,
    the reference records) is above its noise (1e-4 of its leaf's and the
    whole gradient's largest |value|), within 2·lr per step elsewhere
    (Adam's first update is ±lr·sign(g)). With `books` (`par_book_mask`),
    the codebook bound holds on its kept entries (the CPU tests hold
    every one). Returns (a summary of what was measured, the bounds it
    broke)."""
    bad, worst, gn = [], 0.0, 0.0
    for k, v in ref["metrics"].items():
        if k == "freq_acc":   # an argmax per frame: a near-tie moves one
            if abs(got["metrics"][k] - v) > 1e-2:
                bad.append(f"{what}: {k} {got['metrics'][k]} vs {v}")
            continue
        norm = k.endswith("grad_norm")
        bound = 2e-3 if norm else 1e-4
        rel = abs(got["metrics"][k] - v) / max(abs(v), 1e-30)
        if rel > bound:
            bad.append(f"{what}: {k} {got['metrics'][k]} vs {v} "
                       f"(rel {rel:.2e} > {bound:g})")
        if norm:
            gn = max(gn, rel)
        else:
            worst = max(worst, rel)
    if not torch.equal(got["rng"], ref["rng"]):
        bad.append(f"{what}: the generator state differs")
    q_err, q_far, q_n = 0.0, 0, 0
    keep = torch.ones(ref["qstate"][2].shape, dtype=torch.bool)  # [books, bins]
    left = ""
    if books is not None:
        keep, n_code, n_draw, n_thr = books
        left = (f"; left out: {n_code} fed by a position whose code "
                f"differs, {n_draw} expired with a row drawn from one, "
                f"{n_thr} at the expiry threshold")
    for (_, a), (_, b) in zip(par_leaves(got["qstate"]),
                              par_leaves(ref["qstate"])):
        m = keep if a.dim() == 2 else keep[..., None].expand_as(a)
        d = (a - b).abs()
        q_far += int((d > 2e-5 + 2e-3 * b.abs())[m].sum())
        q_err = max(q_err, float(d[m].max()) if bool(m.any()) else 0.0)
        q_n += int(m.sum())
    if q_far:
        bad.append(f"{what}: {q_far} codebook elements outside rtol 2e-3, "
                   "atol 2e-5")
    masks = {}
    for rec in steps:
        g = dict(par_leaves(rec["grads"]))
        top = max(float(t.abs().max()) for t in g.values())
        for k, t in g.items():
            m = t.abs() > 1e-4 * (float(t.abs().max()) + top)
            masks[k] = m if k not in masks else masks[k] & m
    p_err, moved, flipped, outside, n = 0.0, 0.0, 0, 0, 0
    for (k, a), (_, b) in zip(par_leaves(got[key]), par_leaves(ref[key])):
        d = (a - b).abs()
        m = masks[k]
        far = d > 2e-5 + 2e-3 * b.abs()
        outside += int((far & m).sum())
        flipped += int(far.sum())
        moved = max(moved, float(d.max()))
        p_err = max(p_err, float(d[m].max()) if bool(m.any()) else 0.0)
        n += d.numel()
    if outside:
        bad.append(f"{what}: {outside} {key} elements outside rtol 2e-3, "
                   "atol 2e-5 where the gradient is above its noise")
    if moved > 2 * lr * len(steps):
        bad.append(f"{what}: a {key} element moved {moved:.3g} > 2·lr per "
                   "step")
    return (f"losses max rel {worst:.2e} (bound 1e-4), gradient "
            f"norm {gn:.2e}, codebooks max|d| {q_err:.2e} over {q_n} "
            f"elements ({int(keep.sum())} of {keep.numel()} clusters{left}"
            f"), {key} max|d| "
            f"{p_err:.2e} where the gradient is above its noise, {flipped} "
            f"of {n} elements beyond rtol 2e-3 (largest move {moved:.2e}, "
            f"2·lr per step {2 * lr * len(steps):.1e}: Adam's first update "
            f"±lr·sign(g)), generator state "
            f"{'equal' if torch.equal(got['rng'], ref['rng']) else 'DIFFERS'}"
            ), bad


def par_checksum(torch, tree) -> list:
    """Per leaf, the sum of its float32 bit patterns (ranks' states equal
    bit for bit ⇔ equal sums here, up to collisions)."""
    return [int(t.detach().float().contiguous().view(torch.int32).long()
                .sum()) for _, t in par_leaves(tree)]


def par_rank(rank: int, world: int, store: str, base: str) -> None:
    """One rank of (b): the gloo world of 2 on cuda:0. Runs the DP, GAN,
    tp, sp and pp checks; rank 0 holds them against the single-process
    results (the parent's, or its own on the same card) and prints; each
    rank writes its launch counts and times to `<base>/rank<r>.json`."""
    import torch
    import torch.distributed as dist

    from encodec_tpu_torch import kernels, parallel
    from encodec_tpu_torch.device import set_fp32_policy
    from encodec_tpu_torch.models import breathing_model
    from encodec_tpu_torch.models.lm import (LMConfig, init_lm,
                                             lm_forward_batch)
    from encodec_tpu_torch.models.seanet import (seanet_decoder,
                                                 seanet_encoder)
    from encodec_tpu_torch.parallel import comm
    from encodec_tpu_torch.quant import rvq_decode, rvq_encode_margins
    from encodec_tpu_torch.train import ConfigNamespace, Trainer
    from encodec_tpu_torch.train.lm_train import (create_lm_train_state,
                                                  lm_loss, shift_codes)
    from encodec_tpu_torch.train.steps import _grads, _with_grad

    torch.set_num_threads(2)
    base_p = Path(base)
    ref = torch.load(base_p / "ref.pt", weights_only=False)
    dev = torch.device(ref["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    set_fp32_policy()
    # cuDNN's deterministic algorithms: the ranks' and the single process's
    # steps then give the same bits run to run, so the comparisons below
    # read the same differences every run (per-shape rounding only)
    torch.backends.cudnn.deterministic = True
    parallel.initialize_multihost(init_method=f"file://{store}",
                                  world_size=world, rank=rank,
                                  backend="gloo", timeout_s=600)
    out = {"counts": {}, "ms": {}, "transport": comm.transport()}
    say = print if rank == 0 else (lambda *a, **k: None)
    problems: list = []   # every path runs; the rank fails at the end
    t_all = time.perf_counter()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def empty():
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out["ms"][name] = (time.perf_counter() - t0) * 1e3
        return res

    def same_on_ranks(tree, what):
        sums = torch.tensor(par_checksum(torch, tree), dtype=torch.int64)
        every = comm.all_gather(sums[None])
        check(bool((every == every[0]).all()),
              f"(b) {what}: the ranks' states differ")

    kernels.reset_launch_counts()
    # -- DP: default.yaml's model as written, B=8 (4 per rank). Step 1
    # from a fresh state (k-means on the gathered rows), against the
    # single process's on the global batch (rank 0 runs it while rank 1
    # waits): the losses and the generator state. k-means (50 passes of
    # 3,840 rows over 1,024 clusters) turns the rounding difference of a
    # B=4 and a B=8 encoder pass (cuDNN picks algorithms per shape) into
    # other books, so the state is held from a common one: step 2, from
    # the DP step 1's state, against the single process's step 2 from it.
    mesh = parallel.make_mesh()
    config = ConfigNamespace(ref["dp_config"])
    tr = Trainer(config, [], [], str(base_p / f"dp{rank}"), device=dev,
                 mesh=mesh)
    w = tr.weights_for_epoch(1)
    x_all = ref["x"][:PAR_B_DP].to(dev)
    x = parallel.shard_batch(mesh, x_all)
    s1, m = timed("dp step 1", lambda: tr.gen_step(tr.state, x, w))
    dp1 = {k: float(v) for k, v in m.items()
           if hasattr(v, "dim") and v.dim() == 0}
    del m
    same_on_ranks((s1.params, tuple(s1.qstate[:3])), "DP step 1")
    s2, m = timed("dp step 2", lambda: tr.gen_step(s1, x, w,
                                                   keep_grads=True))
    rec = par_record(torch, s2, m)
    del m, s2
    same_on_ranks((rec["params"], rec["qstate"]), "DP step 2")
    # the path's launches; rank 0's single-process references follow
    out["counts"]["dp"] = launch_counts(kernels)
    codes = comm.all_gather(rec["codes"])
    empty()
    if rank == 0:
        plain = Trainer(config, [], [], str(base_p / "dp_plain"), device=dev)
        p1, pm1 = plain.gen_step(plain.state, x_all, w)
        book_d = float((p1.qstate.embed - s1.qstate.embed).abs().max())
        rows_d = int(((p1.qstate.embed - s1.qstate.embed).abs().amax(-1)
                      > 1e-3).sum())
        one = {k: float(v) for k, v in pm1.items()
               if hasattr(v, "dim") and v.dim() == 0}
        l1 = max(abs(dp1[k] - v) / abs(v) for k, v in one.items()
                 if k.startswith("loss") and v != 0)
        if l1 > 1e-4:
            problems.append(f"(b) DP step 1: losses rel {l1:.3g} > 1e-4")
        if not torch.equal(p1.rng, s1.rng):
            problems.append("(b) DP step 1: the generator state differs")
        del p1, pm1
        empty()
        p2, pm2 = plain.gen_step(s1, x_all, w, keep_grads=True)
        want = par_record(torch, p2, pm2)
        del p2, pm2, plain
        empty()
        n_safe, n_bad = par_codes(torch, codes, want)
        summary, bad = par_compare(
            torch, rec, want, w.lr, [want], "(b) DP step 2",
            books=par_book_mask(torch, codes, want, s1, tr.model.cfg.rvq))
        problems.extend(bad + ([f"(b) DP: codes differ at {n_bad} untied "
                                "positions"]
                               if n_bad > PAR_CODES_OFF * n_safe else []))
        say(f"parallel (b) DP gloo world {world} ({comm.transport()} "
            f"transport), default.yaml's model as written, global B="
            f"{PAR_B_DP} x 4 h ({PAR_B_DP // world} per rank), against the "
            f"single process on the card: step 1 from a fresh state (k-means "
            f"on the gathered rows)")
        say(f"    step 1: losses max rel {l1:.2e} (bound 1e-4), generator "
            f"state equal; the books: {rows_d} of "
            f"{s1.qstate.embed.shape[1]} rows differ by more than 1e-3 (max "
            f"|d| {book_d:.3g}): k-means amplifies the encoder's "
            "per-shape rounding")
        say(f"    step 2 from step 1's state: {summary}; codes equal at "
            f"{n_safe - n_bad} of {n_safe} untied positions (of "
            f"{codes.shape[0] * codes.shape[2]}, held to "
            f"{PAR_CODES_OFF:.1%}); ranks' states equal; ms per step per "
            f"rank (cuDNN's deterministic algorithms) "
            f"{out['ms']['dp step 1']:.1f} / {out['ms']['dp step 2']:.1f}")
    comm.barrier()

    # -- GAN: gan.yaml's GAN generator step and discriminator step, B=4,
    # from the DP step 1's generator (its books initialised)
    kernels.reset_launch_counts()
    gt = Trainer(ConfigNamespace(ref["gan_config"]), [], [],
                 str(base_p / f"gan{rank}"), device=dev, mesh=mesh)
    start = gt.state._replace(params=s1.params, qstate=s1.qstate)
    del tr, s1
    w = gt.weights_for_epoch(1)
    x_all = ref["x"][:PAR_B_GAN].to(dev)
    x = parallel.shard_batch(mesh, x_all)
    g1, m1 = timed("gan step", lambda: gt.gen_step(start, x, w,
                                                   use_gan=True,
                                                   keep_grads=True))
    g = par_record(torch, g1, m1)
    g2, m2 = timed("disc step", lambda: gt.disc_step(start, x, w,
                                                     keep_grads=True))
    d = par_record(torch, g2, m2)
    del g1, g2, m1, m2
    same_on_ranks((g["params"], d["disc"]), "GAN")
    out["counts"]["gan"] = launch_counts(kernels)
    gan_codes = comm.all_gather(g["codes"])
    empty()
    if rank == 0:
        plain = Trainer(ConfigNamespace(ref["gan_config"]), [], [],
                        str(base_p / "gan_plain"), device=dev)
        q1, qm1 = plain.gen_step(start, x_all, w, use_gan=True,
                                 keep_grads=True)
        want_g = par_record(torch, q1, qm1)
        del q1, qm1
        q2, qm2 = plain.disc_step(start, x_all, w, keep_grads=True)
        want_d = par_record(torch, q2, qm2)
        del q2, qm2, plain
        empty()
        g_safe, g_bad = par_codes(torch, gan_codes, want_g)
        sg, bad_g = par_compare(
            torch, g, want_g, w.lr, [want_g], "(b) GAN generator step",
            books=par_book_mask(torch, gan_codes, want_g, start,
                                gt.model.cfg.rvq))
        if g_bad > PAR_CODES_OFF * g_safe:
            bad_g.append(f"(b) GAN: codes differ at {g_bad} untied positions")
        sd, bad_d = par_compare(torch, d, want_d, w.disc_lr, [want_d],
                                "(b) discriminator step", key="disc")
        problems.extend(bad_g + bad_d)
        say(f"parallel (b) GAN gloo world {world}, gan.yaml as written, "
            f"global B={PAR_B_GAN}, from DP step 1's generator: GAN "
            f"generator step {sg}; codes equal at {g_safe - g_bad} of "
            f"{g_safe} untied positions (held to {PAR_CODES_OFF:.1%})")
        say(f"    discriminator step {sd}; ms per step per rank "
            f"{out['ms']['gan step']:.1f} / {out['ms']['disc step']:.1f}")
    del gt, start, x, x_all
    comm.barrier()
    empty()

    # -- tp: the 24 kHz codebooks as 512 + 512 bins, a 10 s request
    kernels.reset_launch_counts()
    tmesh = parallel.make_mesh(axis_name="model")
    qstate = ref["tp_qstate"].__class__(
        *(t.to(dev) for t in tuple(ref["tp_qstate"])[:3]), inited=True)
    z = ref["tp_z"].to(dev)
    codes = timed("tp", lambda: parallel.rvq_encode_tp(
        qstate, z, ref["tp_cfg"], tmesh))
    if rank == 0:
        n_bad = int((codes.cpu() != ref["tp_codes"]).sum())
        if n_bad:
            problems.append(f"(b) tp: {n_bad} codes differ from K2's")
        say(f"parallel (b) tp gloo world {world}: the 24 kHz model's 10 s "
            f"request at 24 kbps (N={z.shape[1]}, n_q={codes.shape[0]}, "
            f"bins {qstate.embed.shape[1]} as {world} x "
            f"{qstate.embed.shape[1] // world}): codes equal to K2's at "
            f"every position ({codes.numel()}); {out['ms']['tp']:.1f} ms "
            "per rank")
    out["counts"]["tp"] = launch_counts(kernels)

    # -- sp: the breathing model at full width on a 4 h night
    kernels.reset_launch_counts()
    smesh = parallel.make_mesh(axis_name="seq")
    bm = breathing_model(kmeans_init=False, device=dev)
    night = ref["sp_x"].to(dev)
    zs = timed("sp encode", lambda: parallel.seanet_encode_sp(
        bm.params["encoder"], night, bm.cfg.seanet, smesh))
    cs = timed("sp codes", lambda: parallel.encode_sp(
        bm.params, bm.qstate, night, bm.cfg, smesh))
    audio = timed("sp decode", lambda: parallel.decode_sp(
        bm.params, bm.qstate, cs, bm.cfg, smesh))
    out["counts"]["sp"] = launch_counts(kernels)
    if rank == 0:
        with torch.no_grad():
            z1 = seanet_encoder(bm.params["encoder"], night, bm.cfg.seanet)
            c1, margins = rvq_encode_margins(bm.qstate, z1, bm.cfg.rvq)
            a1 = seanet_decoder(bm.params["decoder"],
                                rvq_decode(bm.qstate, cs.permute(1, 0, 2),
                                           bm.cfg.rvq), bm.cfg.seanet)
        z_rel = float((zs - z1).abs().max() / z1.abs().max())
        a_rel = float((audio - a1).abs().max() / a1.abs().max())
        safe = (margins >= TIE_THRESHOLD).permute(1, 0, 2)
        c1 = c1.permute(1, 0, 2)
        n_bad = int((cs[safe] != c1[safe]).sum())
        if not (z_rel <= 1e-4 and a_rel <= 1e-4 and n_bad == 0):
            problems.append(
                f"(b) sp: latents {z_rel:.3g}, audio {a_rel:.3g} of their "
                f"largest |value| (bound 1e-4), {n_bad} codes differ "
                "outside tie flags")
        say(f"parallel (b) sp gloo world {world}: the breathing model "
            f"(H=1024) on a 4 h night ({night.shape[1]} samples, "
            f"{z1.shape[1]} frames, {z1.shape[1] // world} per shard): "
            f"latents max|d| {z_rel:.3g} and audio {a_rel:.3g} of their "
            f"largest |value| (held to 1e-4; 1e-5 expected), codes equal at "
            f"{int(safe.sum())} of {safe.numel()} untied positions; ms per "
            f"rank: encode {out['ms']['sp encode']:.1f}, encode+codes "
            f"{out['ms']['sp codes']:.1f}, decode {out['ms']['sp decode']:.1f}")
    del bm, zs, cs, audio

    # -- pp: the published 24 kHz LM width at 4 layers over 2 stages
    pmesh = parallel.make_mesh(axis_name="pipe")
    lcfg = LMConfig(**ref["lm_cfg"])
    params = init_lm(torch.Generator().manual_seed(0), lcfg, device=dev)
    lm_codes = ref["lm_codes"].to(dev)
    inputs = shift_codes(lm_codes)
    stacked, other = parallel.stack_lm_layers(params, world)
    stage = parallel.shard_stacked_layers(stacked, pmesh)
    logits = timed("pp forward", lambda: parallel.lm_forward_batch_pp(
        stage, other, inputs, lcfg, pmesh, PAR_LM_M, return_logits=True))
    opt, opt_state = create_lm_train_state((stage, other), lr=3e-4)
    step = parallel.make_lm_pp_train_step(lcfg, opt, pmesh, PAR_LM_M)
    _, _, pm = timed("pp step", lambda: step((stage, other), opt_state,
                                             lm_codes, keep_grads=True))
    if rank == 0:
        with torch.no_grad():
            want = lm_forward_batch(params, inputs, lcfg, return_logits=True)
        l_err = float((logits - want).abs().max())
        del want, logits
        leaves = _with_grad(params)
        with torch.enable_grad():
            loss, _ = lm_loss(leaves, lm_codes, lcfg)
            grads = _grads(loss, leaves)
        loss = float(loss.detach())
        nll_rel = abs(float(pm["nll"]) - loss) / loss
        gs, go = parallel.stack_lm_layers(grads, world)
        want_g = list(par_leaves((parallel.shard_stacked_layers(gs, pmesh),
                                  go)))
        # the port's gradient bound: 1e-4 of the leaf's and the whole
        # gradient's largest |value|
        top = max(float(b.abs().max()) for _, b in want_g)
        g_err, ok = 0.0, True
        for (_, a), (_, b) in zip(par_leaves(pm["grads"]), want_g):
            err = float((a - b).abs().max())
            ok &= err <= 1e-4 * (float(b.abs().max()) + top)
            g_err = max(g_err, err / top)
        if not (l_err <= 2e-5 and nll_rel <= 1e-5 and ok):
            problems.append(f"(b) pp: logits max|d| {l_err}, nll rel "
                            f"{nll_rel}, gradient within its bound: {ok}")
        say(f"parallel (b) pp gloo world {world}: the published 24 kHz LM "
            f"width (dim {lcfg.dim}, K={lcfg.n_q}, card {lcfg.card}) at "
            f"{lcfg.num_layers} layers, S={world}, M={PAR_LM_M}, codes "
            f"B={PAR_LM_B} x T={lm_codes.shape[-1]}: logits max|d| "
            f"{l_err:.3g} (2e-5), one step's nll rel {nll_rel:.3g} (1e-5), "
            f"stage 0's gradient and the replicated one's max|d| "
            f"{g_err:.3g} of the largest |g| (1e-4 of a leaf's and the "
            f"largest |g|); ms per rank: forward "
            f"{out['ms']['pp forward']:.1f}, step {out['ms']['pp step']:.1f}")
    out["ms"]["all"] = (time.perf_counter() - t_all) * 1e3
    (base_p / f"rank{rank}.json").write_text(json.dumps(out))
    check(not problems, "; ".join(problems))
    dist.barrier()
    dist.destroy_process_group()


def par_nights(root: Path, n: int = 4) -> None:
    """`n` seeded synthetic nights per channel under `root/synth`."""
    for c, chan in enumerate(("thorax", "abdominal")):
        (root / "synth" / chan).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            np.savez(root / "synth" / chan / f"night{i}.npz",
                     data=breathing_signal(TRAIN_NIGHT, 2000 + 10 * i + c),
                     fs=10)


def par_loaders(build, config, sizes):
    train, val, mapping = build(config)
    train.dataset.size, val.dataset.size = sizes
    return train, val, mapping


def phase_parallel(torch, kernels, dev, model24):
    """The parallel package on torch.distributed. (a) NCCL at world 1 in
    this process: default.yaml's model as written at B=16, the
    data-parallel generator step against the plain step, bit for bit
    (an all-reduce over one rank and a division by 1 are exact), then a
    one-epoch fit (3 batches) of the mesh trainer with
    `checkpoint.async_save: true` and an eval after it, its checkpoint
    against a synchronous save of the same state, and the synchronous
    save's seconds, the asynchronous save's blocking seconds and the
    epoch's seconds. (b) a gloo world of 2 spawned on this card
    (`par_rank`), after this process releases its cached blocks, against
    single-process references computed there: DP, GAN, tp, sp, pp.
    Returns the launch counts: (a)'s DP step and mesh fit, and (b) per
    rank."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from encodec_tpu_torch import parallel
    from encodec_tpu_torch.models.lm import lm_config_for
    from encodec_tpu_torch.models.seanet import seanet_encoder
    from encodec_tpu_torch.parallel import comm
    from encodec_tpu_torch.train import (AsyncCheckpointer, ConfigNamespace,
                                         Trainer, load_checkpoint,
                                         save_checkpoint)
    from encodec_tpu_torch.train import __main__ as train_entry
    from encodec_tpu_torch.train.trainer import state_to_device

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    base = Path(tmp.name)
    par_nights(base / "data")
    cfg = train_config(str(base / "data"))
    cfg["dataset"]["batch_size"] = 16
    config = ConfigNamespace(cfg)
    loader, _, _ = par_loaders(train_entry.build_dataloaders, config,
                               (48, 16))
    x32 = torch.from_numpy(next(iter(loader))[0]["x"])
    x16 = x32[:16].to(dev)

    # -- (a) NCCL, world 1 --------------------------------------------------
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    empty = torch.cuda.empty_cache if cuda else (lambda: None)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{base}/nccl",
                            world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh(1)
        plain = Trainer(config, [], [], str(base / "plain"), device=dev)
        dp = Trainer(config, [], [], str(base / "dp"), device=dev, mesh=mesh)
        w = plain.weights_for_epoch(1)
        # cuDNN's default algorithms are not deterministic (two runs of the
        # same plain step differ in the last bits): the comparison runs
        # both steps with deterministic ones
        torch.backends.cudnn.deterministic = True
        try:
            s_p, m_p = plain.gen_step(plain.state, x16, w)
            sync()
            # the column counts the data-parallel path's own launches: this
            # step, then the fit below
            kernels.reset_launch_counts()
            s_d, m_d = dp.gen_step(dp.state, x16, w)
            sync()
            counts_step = launch_counts(kernels)
        finally:
            torch.backends.cudnn.deterministic = False
        same = states_equal(torch, s_p, s_d) and all(
            torch.equal(m_p[k], m_d[k]) for k in m_p)
        check(same, "(a) NCCL world 1: the DP step differs from the plain "
                    "step")
        times = {"plain": [], "dp": []}
        for name in ("plain", "dp", "dp", "plain"):
            fn, st = ((plain.gen_step, s_p) if name == "plain"
                      else (dp.gen_step, s_d))
            sync()
            t0 = time.perf_counter()
            fn(st, x16, w)
            sync()
            times[name].append((time.perf_counter() - t0) * 1e3)
        print(f"parallel (a) NCCL world 1 ({comm.transport()} transport), "
              f"default.yaml's model as written, B=16 x 4 h: the DP "
              f"generator step (k-means init) == the plain step, bit for "
              f"bit (state, generator state, metrics; both with cuDNN's "
              f"deterministic algorithms); ms per step (default algorithms, "
              f"host "
              f"clock, second steps, plain/dp/dp/plain): plain "
              f"{times['plain'][0]:.1f} / {times['plain'][1]:.1f}, DP "
              f"{times['dp'][0]:.1f} / {times['dp'][1]:.1f}")
        del plain, dp, s_p, s_d, m_p, m_d
        empty()

        # one epoch of 3 batches with asynchronous saves, on the mesh: the
        # trainer's data-parallel path (the preemption vote, eval's
        # gathers, rank 0's save, the barrier after the write) under NCCL
        cfg_a = json.loads(json.dumps(cfg))
        cfg_a["checkpoint"]["async_save"] = True
        cfg_a["distributed"]["data_parallel"] = True
        conf_a = ConfigNamespace(cfg_a)
        tl, vl, mapping = par_loaders(train_entry.build_dataloaders, conf_a,
                                      (48, 16))
        tr = Trainer(conf_a, tl, vl, str(base / "fit"), label_mapping=mapping,
                     device=dev, mesh=mesh)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tr.fit(max_epochs=1)
        fit_s = time.perf_counter() - t0
        val = tr.evaluate(2, save_figure=False)
        counts_fit = launch_counts(kernels)
        epoch_s = tr.epoch_seconds[1]
        n_books = len(val.get("code_entropy", []))
        check(np.isfinite(val["Loss"]) and n_books > 0,
              f"(a) the mesh trainer's eval: {val}")
        t0 = time.perf_counter()
        save_checkpoint(tr.state, 1, base / "sync.ckpt")
        sync_s = time.perf_counter() - t0
        ck = AsyncCheckpointer()
        block_s, async_s = [], []
        for _ in range(2):   # the first allocates its pinned buffers
            t0 = time.perf_counter()
            ck.save(tr.state, 1, base / "async.ckpt")
            block_s.append(time.perf_counter() - t0)
            ck.wait()
            async_s.append(time.perf_counter() - t0)
        want = state_to_device(load_checkpoint(base / "sync.ckpt")[0], dev)
        for name in ("fit/model.ckpt", "async.ckpt"):
            got = state_to_device(load_checkpoint(base / name)[0], dev)
            check(states_equal(torch, got, want),
                  f"(a) {name} does not load equal to a synchronous save")
        size = (base / "sync.ckpt").stat().st_size / 2 ** 20
        print(f"parallel (a) async checkpoints: a one-epoch fit on the mesh "
              f"of 3 batches (B=16, eval with gathered codes: val loss "
              f"{val['Loss']:.4f}, {n_books} code entropies; an asynchronous "
              f"save by rank 0, then the barrier) in {fit_s:.2f} s, "
              f"the epoch's training loop {epoch_s:.2f} s; its checkpoint "
              f"and a second asynchronous save load equal to a synchronous "
              f"save of the state, bit for bit; synchronous save "
              f"{sync_s:.3f} s ({size:.0f} MiB; {100 * sync_s / epoch_s:.1f}% "
              f"of the epoch), asynchronous save blocking {block_s[0]:.3f} "
              f"s the first time (pinned buffers allocated), "
              f"{block_s[1]:.3f} s the next, written after "
              f"{async_s[0]:.3f} / {async_s[1]:.3f} s")
        del tr, want, got
    finally:
        dist.destroy_process_group()
    empty()

    # -- (b) the gloo world of 2; its inputs ---------------------------------
    ref = {"device": str(dev), "x": x32, "dp_config": cfg,
           "gan_config": gan_config(str(base / "data"))}
    model24.set_target_bandwidth(24.0)
    wav = torch.from_numpy(request_audio(10.0, 24000, 5)[None]).to(dev)
    with torch.no_grad():
        z = seanet_encoder(model24.infer_params["encoder"],
                           wav.transpose(1, 2), model24.cfg.seanet)
    n_q = min(model24.n_q_active, model24.cfg.rvq.n_q)
    q = model24.qstate
    ref.update(tp_qstate=q._replace(embed=q.embed.cpu(),
                                    embed_avg=q.embed_avg.cpu(),
                                    cluster_size=q.cluster_size.cpu()),
               tp_z=z.cpu(),
               tp_cfg=model24.cfg.rvq,
               tp_codes=kernels.rvq_encode_fused(
                   z[0].contiguous(), model24.qstate.embed.contiguous(),
                   n_q, model24.cfg.rvq.shared_codebook).cpu()[:, None])
    check(n_q == model24.cfg.rvq.n_q, f"tp: n_q {n_q} at 24 kbps")
    ref["sp_x"] = torch.from_numpy(
        breathing_signal(144_000, 7)[None, :, None])
    lcfg = lm_config_for(model24)
    ref["lm_cfg"] = dict(n_q=lcfg.n_q, card=lcfg.card, dim=lcfg.dim,
                         num_heads=lcfg.num_heads, num_layers=PAR_LM_LAYERS,
                         past_context=lcfg.past_context)
    ref["lm_codes"] = torch.from_numpy(np.random.RandomState(9).randint(
        0, lcfg.card, (PAR_LM_B, lcfg.n_q, 750)).astype(np.int64))
    torch.save(ref, base / "ref.pt")
    del ref, z, wav
    empty()
    t0 = time.perf_counter()
    mp.spawn(par_rank, args=(PAR_WORLD, str(base / "gloo"), str(base)),
             nprocs=PAR_WORLD, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [json.loads((base / f"rank{r}.json").read_text())
             for r in range(PAR_WORLD)]
    counts_b = []
    for r, res in enumerate(ranks):
        total: dict = {}
        for path, c in res["counts"].items():
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
        counts_b.append(total)
        check(res["transport"] == "host", f"rank {r}: transport "
              f"{res['transport']}")
        for k in ("nearest_codebook", "rvq_encode_fused", "lstm_grid",
                  "lstm_scan_backward"):
            check(total.get(k, 0) > 0, f"(b) rank {r}: {k} never launched")
        print(f"parallel (b) rank {r}: launches by path "
              + "; ".join(f"{p} K1 {c['nearest_codebook']}, K2 "
                          f"{c['rvq_encode_fused']}, K3 {c['lstm_scan']} "
                          f"(grid {c['lstm_grid']}), K3 backward "
                          f"{c['lstm_scan_backward']}"
                          for p, c in res["counts"].items())
              + f"; {res['ms']['all'] / 1e3:.1f} s in the rank")
    for what, counts, names in (
            ("the DP step", counts_step, ("nearest_codebook", "lstm_grid",
                                          "lstm_scan_backward")),
            ("the mesh fit", counts_fit, ("nearest_codebook", "lstm_grid",
                                          "lstm_scan_backward",
                                          "rvq_encode_fused"))):
        for k in names:
            check(counts.get(k, 0) > 0, f"(a) {what}: {k} never launched")
    counts_a = {k: v + counts_step.get(k, 0) for k, v in counts_fit.items()}
    print("parallel (a) launches by path: " + "; ".join(
        f"{what} K1 {c['nearest_codebook']}, K2 {c['rvq_encode_fused']}, K3 "
        f"{c['lstm_scan']} (grid {c['lstm_grid']}), K3 backward "
        f"{c['lstm_scan_backward']}"
        for what, c in (("DP step", counts_step), ("mesh fit", counts_fit))))
    print(f"parallel: two ranks share one card here: these runs measure "
          f"correctness, not scaling; the gloo world took {spawn_s:.1f} s "
          f"(spawn included), the phase {time.perf_counter() - t_phase:.1f} s")
    tmp.cleanup()
    return counts_a, counts_b


SEQ_WORLD = 2
SEQ_B = 4                   # gan.yaml's rows in (b): one data rank
SEQ_NIGHT = 144_000         # 4 h at 10 Hz = 2 shards x hop 300 x 240
DAC_SHAPE = (4, 750, 512)   # (c): the reference DAC's input width


def seq_rank(rank: int, world: int, store: str, base: str) -> None:
    """One rank of a data×seq world, gan.yaml as written at B=4 on 4 h
    nights; `<base>/seq_ref.pt` gives the batch, the transport and the
    data axis's size: the phase's (b) is a gloo world of 2 on cuda:0, data
    1 x seq 2; `probes/seq_nccl.py` runs an NCCL world, one card per rank.
    The steps (a first generator step with the k-means init, then from its
    state a second one, a GAN generator step and a discriminator step) run
    on every rank; rank 0 then runs them in one process on the whole batch
    and holds the world's (codes gathered over data) against them. Each
    rank writes its ms, peak memory, launch counts and the problems found
    to `<base>/seq<r>.json`."""
    import os

    import torch
    import torch.distributed as dist

    from encodec_tpu_torch import kernels, parallel
    from encodec_tpu_torch.device import set_fp32_policy
    from encodec_tpu_torch.parallel import comm
    from encodec_tpu_torch.train import ConfigNamespace, Trainer

    torch.set_num_threads(2)
    base_p = Path(base)
    ref = torch.load(base_p / "seq_ref.pt", weights_only=False)
    backend, n_data = ref.get("backend", "gloo"), ref.get("data", 1)
    dev = torch.device(ref["device"])
    cuda = dev.type == "cuda"
    if cuda:
        dev = torch.device("cuda", rank if backend == "nccl"
                           else dev.index or 0)
        torch.cuda.set_device(dev)
        os.environ["LOCAL_RANK"] = str(dev.index)
    set_fp32_policy()
    torch.backends.cudnn.deterministic = True   # as in phase_parallel (b)
    parallel.initialize_multihost(init_method=f"file://{store}",
                                  world_size=world, rank=rank,
                                  backend=backend,
                                  timeout_s=600 if backend == "gloo" else 300)
    out = {"ms": {}, "gib": {}, "transport": comm.transport()}
    say = print if rank == 0 else (lambda *a, **k: None)
    problems: list = []
    t_all = time.perf_counter()

    def timed(name, fn):
        """`fn()`, its ms and its peak memory above what was allocated
        before it (the activations and the step's new state)."""
        if not cuda:
            t0 = time.perf_counter()
            res = fn()
            out["ms"][name] = (time.perf_counter() - t0) * 1e3
            out["gib"][name] = 0.0
            return res
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["ms"][name] = (time.perf_counter() - t0) * 1e3
        out["gib"][name] = (torch.cuda.max_memory_allocated()
                            - before) / 2 ** 30
        return res

    def same_on_ranks(tree, what):
        sums = torch.tensor(par_checksum(torch, tree), dtype=torch.int64)
        every = comm.all_gather(sums[None])
        check(bool((every == every[0]).all()),
              f"seq (b) {what}: the ranks' states differ")

    mesh = parallel.make_mesh_2d(n_data, world // n_data)
    data_group = mesh.get_group("data")
    config = ConfigNamespace(ref["config"])
    tr = Trainer(config, [], [], str(base_p / f"seq{rank}"), device=dev,
                 mesh=mesh)
    w = tr.weights_for_epoch(1)
    x = parallel.shard_batch(mesh, ref["x"], "data").to(dev)
    kernels.reset_launch_counts()
    s1, m = timed("gen 1", lambda: tr.gen_step(tr.state, x, w))
    step1 = {k: float(v) for k, v in m.items()
             if hasattr(v, "dim") and v.dim() == 0}
    del m
    recs = {}
    for name, fn in (
            ("gen 2", lambda: tr.gen_step(s1, x, w, keep_grads=True)),
            ("gan", lambda: tr.gen_step(s1, x, w, use_gan=True,
                                        keep_grads=True)),
            ("disc", lambda: tr.disc_step(s1, x, w, keep_grads=True))):
        st, m = timed(name, fn)
        recs[name] = par_record(torch, st, m)
        if "codes" in recs[name]:       # every data rank's rows, in order
            recs[name]["codes"] = comm.all_gather(recs[name]["codes"],
                                                  data_group)
        del st, m
    out["counts"] = dict(launch_counts(kernels),
                         lstm_save=kernels.lstm_scan.save_launches)
    same_on_ranks((s1.params, tuple(s1.qstate[:3])), "step 1")
    for name, rec in recs.items():
        same_on_ranks((rec["params"], rec["qstate"], rec.get("disc")), name)
    comm.barrier()
    if rank == 0:
        plain = Trainer(config, [], [], str(base_p / "seq_plain"),
                        device=dev)
        x = ref["x"].to(dev)            # the whole batch
        p1, pm = timed("one 1", lambda: plain.gen_step(plain.state, x, w))
        one = {k: float(v) for k, v in pm.items()
               if hasattr(v, "dim") and v.dim() == 0}
        l1, l1_key = max((abs(step1[k] - v) / abs(v), k)
                         for k, v in one.items()
                         if k.startswith("loss") and v != 0)
        rows_d = int(((p1.qstate.embed - s1.qstate.embed).abs().amax(-1)
                      > 1e-3).sum())
        if l1 > 1e-4:
            problems.append(f"seq (b) step 1: losses rel {l1:.3g} "
                            f"({l1_key}) > 1e-4")
        if not torch.equal(p1.rng, s1.rng):
            problems.append("seq (b) step 1: the generator state differs")
        del p1, pm
        n_seq = world // n_data
        say(f"seq (b) {backend} world {world} ({comm.transport()} "
            f"transport), data {n_data} x seq {n_seq}, gan.yaml as written, "
            f"B={SEQ_B} x 4 h ({SEQ_NIGHT // n_seq} samples per shard), "
            "against one process "
            f"on the card: step 1 from a fresh state (k-means): losses max "
            f"rel {l1:.2e} ({l1_key}; bound 1e-4), generator state equal; "
            f"{rows_d} book rows of {s1.qstate.embed.shape[1]} per book "
            "differ by more than 1e-3")
        for name, fn in (
                ("gen 2", lambda: plain.gen_step(s1, x, w, keep_grads=True)),
                ("gan", lambda: plain.gen_step(s1, x, w, use_gan=True,
                                               keep_grads=True)),
                ("disc", lambda: plain.disc_step(s1, x, w,
                                                 keep_grads=True))):
            st, m = timed("one " + name, fn)
            want = par_record(torch, st, m)
            del st, m
            got = recs[name]
            disc = name == "disc"
            summary, bad = par_compare(
                torch, got, want, w.disc_lr if disc else w.lr, [want],
                f"seq (b) {name}", key="disc" if disc else "params",
                books=None if disc else par_book_mask(
                    torch, got["codes"], want, s1, tr.model.cfg.rvq))
            if not disc:
                n_safe, n_bad = par_codes(torch, got["codes"], want)
                if n_bad > PAR_CODES_OFF * n_safe:
                    bad.append(f"seq (b) {name}: codes differ at {n_bad} "
                               "untied positions")
                summary += (f"; codes equal at {n_safe - n_bad} of {n_safe} "
                            f"untied positions (held to {PAR_CODES_OFF:.1%})")
            problems.extend(bad)
            say(f"    {name} step: {summary}")
        del plain
    out["ms"]["all"] = (time.perf_counter() - t_all) * 1e3
    out["problems"] = problems          # `seq_world` fails on them
    (base_p / f"seq{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def dac_tie_flags(torch, params, z, cfg) -> "np.ndarray":
    """`[B, N, T]` True where a stage's cosine lookup, in float64 on the
    CPU along the float32 forward's residuals, has its top two within 1e-5
    (a near-tie that float32 rounding may turn), or an earlier stage of
    that position has."""
    from encodec_tpu_torch.quant import dac_vq

    res = z.double()
    flags = []
    for stage in params["stages"][:cfg.n_codebooks]:
        st = {k: ({q: t.double() for q, t in v.items()}
                  if isinstance(v, dict) else v.double())
              for k, v in stage.items()}
        z_e = dac_vq._wn_linear(st["in_proj"], res)
        enc = z_e.reshape(-1, z_e.shape[-1])
        enc = enc / enc.norm(dim=1, keepdim=True)
        cb = st["codebook"] / st["codebook"].norm(dim=1, keepdim=True)
        top = torch.topk(enc @ cb.t(), 2, dim=1).values
        flags.append((top[:, 0] - top[:, 1] < 1e-5).reshape(z.shape[:2]))
        z_q, _ = dac_vq._decode_latents(st["codebook"], z_e)
        res = res - dac_vq._wn_linear(st["out_proj"], z_q)
    flags = torch.stack(flags, dim=1)                     # [B, N, T]
    return (flags.int().cumsum(1) > 0).numpy()


def seq_world(torch, dev, base: Path, world: int, backend: str = "gloo",
              n_data: int = 1) -> list:
    """A data×seq world of `world` ranks (`seq_rank`): data `n_data` x seq
    `world // n_data`, gloo on this card or NCCL with a card per rank;
    gan.yaml as written at B=4 on 4 h nights, each step against one
    process. Checks and prints each rank's launches, ms and peak memory
    beside the single process's; returns the launch counts per rank."""
    import torch.multiprocessing as mp

    x = np.stack([breathing_signal(SEQ_NIGHT, 3000 + i)
                  for i in range(SEQ_B)])[..., None]
    torch.save({"config": gan_config(str(base / "data")),
                "x": torch.from_numpy(x), "device": str(dev),
                "backend": backend, "data": n_data},
               base / "seq_ref.pt")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(seq_rank, args=(world, str(base / backend), str(base)),
             nprocs=world, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [json.loads((base / f"seq{r}.json").read_text())
             for r in range(world)]
    wire = "host" if backend == "gloo" else "device"
    counts = []
    for r, res in enumerate(ranks):
        c = res["counts"]
        counts.append(c)
        check(res["transport"] == wire, f"seq rank {r}: transport "
              f"{res['transport']}")
        for k in ("nearest_codebook", "lstm_grid", "lstm_scan_backward",
                  "lstm_save"):
            check(c.get(k, 0) > 0, f"seq (b) rank {r}: {k} never launched")
        print(f"seq (b) rank {r}: launches K1 {c['nearest_codebook']}, K3 "
              f"grid {c['lstm_grid']} (saving forward {c['lstm_save']}), "
              f"K3 backward {c['lstm_scan_backward']}, K2 "
              f"{c['rvq_encode_fused']}; ms per step " + ", ".join(
                  f"{n} {res['ms'][n]:.1f}" for n in ("gen 1", "gen 2",
                                                      "gan", "disc"))
              + "; peak GiB above the state " + ", ".join(
                  f"{n} {res['gib'][n]:.2f}" for n in ("gen 1", "gen 2",
                                                       "gan", "disc"))
              + f"; {res['ms']['all'] / 1e3:.1f} s in the rank")
    one = ranks[0]
    shared = ("two ranks on one card: correctness and the memory split, "
              "not scaling; the seq collectives crossed gloo here, NCCL "
              "only between cards (probes/seq_nccl.py)"
              if backend == "gloo" else
              f"{world} ranks on {world} cards, NCCL")
    print(f"seq (b) one process at B={SEQ_B} on the card: ms per step "
          + ", ".join(f"{n} {one['ms']['one ' + n]:.1f}"
                      for n in ("1", "gen 2", "gan", "disc"))
          + "; peak GiB above the state " + ", ".join(
              f"{n} {one['gib']['one ' + n]:.2f}"
              for n in ("1", "gen 2", "gan", "disc"))
          + f" ({shared}; the world took {spawn_s:.1f} s, spawn included)")
    problems = [p for res in ranks for p in res["problems"]]
    check(not problems, "; ".join(problems))
    return counts


def phase_seq_parallel(torch, kernels, dev):
    """The data×seq training step (`distributed.seq_parallel`), then the
    DAC-style RVQ. (A 1 x 1 mesh is the data-parallel step, which
    `phase_parallel`'s (a) holds to the plain step.) (b) a gloo world of 2
    on this card (`seq_world`), data 1 x seq 2, gan.yaml as written at B=4
    on 4 h nights: the generator, GAN
    generator and discriminator steps against one process on the card,
    ms and peak memory per rank beside the single process's, launches per
    rank. (c) `dac_rvq_forward` at the reference DAC shape (input_dim
    512, 9 books of 1024 x 8) on a `[4, 750, 512]` input, on the card
    against the CPU port. Returns (b)'s launch counts per rank."""
    import tempfile

    from encodec_tpu_torch.quant import dac_vq

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    counts = seq_world(torch, dev, Path(tmp.name), SEQ_WORLD)

    # (c) the DAC-style RVQ on the card against the CPU port
    cfg = dac_vq.DacRVQConfig()
    params = dac_vq.init_dac_rvq(torch.Generator().manual_seed(0), cfg)
    z = torch.randn(*DAC_SHAPE, generator=torch.Generator().manual_seed(1))
    want = dac_vq.dac_rvq_forward(params, z, cfg)
    on = {"stages": [{k: ({q: t.to(dev) for q, t in v.items()}
                          if isinstance(v, dict) else v.to(dev))
                      for k, v in st.items()} for st in params["stages"]]}
    zd = z.to(dev)
    got = dac_vq.dac_rvq_forward(on, zd, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        dac_vq.dac_rvq_forward(on, zd, cfg)
    torch.cuda.synchronize()
    dac_ms = (time.perf_counter() - t0) / 5 * 1e3
    ties = dac_tie_flags(torch, params, z, cfg)
    codes, wcodes = got["codes"].cpu().numpy(), want["codes"].numpy()
    n_bad = int((codes != wcodes)[~ties].sum())
    # a position's latents are compared where no stage up to it is flagged
    lat_ok = ~ties.any(1)                                    # [B, T]
    lat_err = float((got["latents"].cpu() - want["latents"]).abs()[
        torch.from_numpy(lat_ok)].max())
    z_err = float((got["z"].cpu() - want["z"]).abs()[
        torch.from_numpy(lat_ok)].max())
    check(n_bad == 0 and lat_err <= 1e-5,
          f"seq (c) dac_rvq_forward on the card: {n_bad} codes differ "
          f"outside near-ties, latents max|d| {lat_err:.3g} (bound 1e-5)")
    print(f"seq (c) dac_rvq_forward (input_dim {cfg.input_dim}, "
          f"{cfg.n_codebooks} books of {cfg.codebook_size} x "
          f"{cfg.codebook_dim}) on {list(DAC_SHAPE)}: the card's codes equal "
          f"the CPU port's at {codes.size - int(ties.sum())} of {codes.size} "
          f"(stage, position) pairs ({int(ties.sum())} flagged as near-ties "
          f"in float64, {int((codes != wcodes).sum())} differ in all); "
          f"latents max|d| {lat_err:.3g} (bound 1e-5) and z {z_err:.3g} "
          f"where unflagged; {dac_ms:.2f} ms per forward on the card (host "
          f"clock, cuBLAS float32 lookups)")
    print(f"seq: the phase took {time.perf_counter() - t_phase:.1f} s")
    tmp.cleanup()
    return counts


PREC_B = 4                  # the bf16 steps' batch of 4 h nights
PREC_LOSS_REL = 2e-2        # bf16 losses off the plain twins'


PREC_WRAPPED = (("encodec_tpu_torch.quant.rvq", "nearest_codebook"),
                ("encodec_tpu_torch.quant.rvq", "rvq_encode_fused"),
                ("encodec_tpu_torch.ops.lstm", "lstm_scan"),
                ("encodec_tpu_torch.ops.lstm", "lstm_scan_backward"))


def capture_first(torch, fn) -> tuple:
    """`fn()`, and the arguments of the first call it made to each kernel
    wrapper of `PREC_WRAPPED` (cloned), by the wrapper's name."""
    import importlib

    seen: dict = {}
    mods = [(importlib.import_module(m), n) for m, n in PREC_WRAPPED]
    origs = [getattr(mod, name) for mod, name in mods]
    for (mod, name), orig in zip(mods, origs):
        def spy(*a, _orig=orig, _name=name, **k):
            seen.setdefault(_name, ([t.detach().clone()
                                     if torch.is_tensor(t) else t
                                     for t in a], k))
            return _orig(*a, **k)
        setattr(mod, name, spy)
    try:
        out = fn()
    finally:
        for (mod, name), orig in zip(mods, origs):
            setattr(mod, name, orig)
    return out, seen


def hold_captured(torch, kernels, seen: dict, what: str) -> str:
    """Each captured kernel call against its plain twin on the same
    inputs: K1's and K2's codes equal where the twin chain's margins are
    untied (K1's margins within the tie threshold of the twin's), K3's
    outputs within 1e-4, K3's backward within 1e-4 of its largest |value|.
    Fails on a difference; returns a summary."""
    out = []
    if "nearest_codebook" in seen:
        a, k = seen["nearest_codebook"]
        idx_k, m_k = kernels.nearest_codebook(*a, **k)
        idx_p, m_p = kernels.nearest_codebook_plain(*a, **k)
        untied = (m_k >= TIE_THRESHOLD) & (m_p >= TIE_THRESHOLD)
        off = int((idx_k != idx_p)[untied].sum())
        m_err = float((m_k - m_p).abs().max())
        check(off == 0 and m_err <= TIE_THRESHOLD,
              f"{what}: K1 off its twin at {off} untied rows, margins "
              f"max|d| {m_err:.3g}")
        out.append(f"K1 {off} of {int(untied.sum())} untied rows off, "
                   f"margins max|d| {m_err:.3g}")
    if "rvq_encode_fused" in seen:
        (x, embed, n_q, *rest), k = seen["rvq_encode_fused"]
        shared = bool(rest[0]) if rest else k.get("shared", False)
        got = kernels.rvq_encode_fused(x, embed, n_q, shared)
        codes, margins = plain_stage_margins(torch, kernels, x, embed, n_q,
                                             shared)
        # a row may differ only from a stage the twin's margin flags as
        # tied; its later stages search other residuals
        diff = got != codes
        differs = diff.any(0)
        first_tied = (margins < TIE_THRESHOLD).gather(
            0, diff.int().argmax(0)[None])[0]
        off = int((differs & ~first_tied).sum())
        check(off == 0, f"{what}: K2 off its twin at {off} rows first at an "
                        "untied stage")
        out.append(f"K2 (N={x.shape[0]}, n_q={n_q}, bins={embed.shape[-2]}) "
                   f"{int(differs.sum())} of {differs.numel()} rows differ, "
                   f"{off} first at an untied stage")
    if "lstm_scan" in seen:
        a, k = seen["lstm_scan"]
        got, want = kernels.lstm_scan(*a, **k), kernels.lstm_scan_plain(*a,
                                                                        **k)
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        err = max(float((g - r).abs().max()) for g, r in zip(got, want))
        check(err <= 1e-4, f"{what}: K3 max|d| {err:.3g} from its twin")
        out.append(f"K3 max|d| {err:.3g}")
    if "lstm_scan_backward" in seen:
        a, k = seen["lstm_scan_backward"]
        d_k = kernels.lstm_scan_backward(*a, **k)[0]
        d_p = kernels.lstm_scan_backward_plain(*a)[0]
        err = float((d_k - d_p).abs().max() / d_p.abs().max())
        check(err <= 1e-4, f"{what}: K3 backward {err:.3g} of its largest "
              "|value| from its twin")
        out.append(f"K3 backward {err:.3g} of its largest |value|")
    torch.cuda.synchronize()
    return ", ".join(out)


def tf32_flags(torch) -> tuple:
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def phase_precision(torch, kernels, dev, model, registry):
    """The reduced-precision modes (see the module's docstring, item 21).
    Returns the launch counts of (a)'s bf16 steps and of (b)'s requests.

    In bf16 a float32 rounding difference (K3 against its twin) can move a
    trunk's output by a bf16 step, so a path's codes on the kernels and on
    the twins are compared but not held outside the float32 tie flags;
    each kernel is held to its twin on the very inputs the path gave it
    (the first call of each, `capture_first`, `hold_captured`)."""
    import copy
    import tempfile

    from encodec_tpu_torch.device import precision_scope
    from encodec_tpu_torch.models.model import (decode_frame, encode_frame,
                                                encode_frame_margins)
    from encodec_tpu_torch.stream import compress
    from encodec_tpu_torch.train import ConfigNamespace, Trainer
    from encodec_tpu_torch.train.optim import tree_leaves
    from encodec_tpu_torch.train.steps import make_train_steps

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    # -- (a) a bf16 step on gan.yaml's model ------------------------------
    cfg = gan_config(tmp.name)
    cfg16 = copy.deepcopy(cfg)
    cfg16["common"]["compute_dtype"] = "bfloat16"
    tr32 = Trainer(ConfigNamespace(cfg), [], [], tmp.name + "/a", device=dev)
    tr16 = Trainer(ConfigNamespace(cfg16), [], [], tmp.name + "/b",
                   device=dev)
    x = torch.from_numpy(np.stack([
        breathing_signal(SEQ_NIGHT, 5000 + i) for i in range(PREC_B)])[
            ..., None]).to(dev)
    w = tr32.weights_for_epoch(61)          # commit and GAN terms on
    s0, _ = tr32.gen_step(tr32.state, x, w)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    steps16, seen = capture_first(torch, lambda: {
        "gen": tr16.gen_step(s0, x, w, keep_grads=True),
        "gan": tr16.gen_step(s0, x, w, use_gan=True, keep_grads=True),
        "disc": tr16.disc_step(s0, x, w)})
    torch.cuda.synchronize()
    bf16_ms = (time.perf_counter() - t0) * 1e3
    counts_train = dict(launch_counts(kernels),
                        lstm_save=kernels.lstm_scan.save_launches)
    for k in ("nearest_codebook", "lstm_grid", "lstm_scan_backward",
              "lstm_save"):
        check(counts_train.get(k, 0) > 0,
              f"precision (a): {k} never launched in the bf16 steps")
    plain16 = make_train_steps(
        tr16.model.cfg, tr16.disc_cfg, freq_loss_kwargs=tr16.freq_kwargs,
        clip=tr16.clip, compute_dtype=torch.bfloat16, plain=True)
    steps32 = {"gen": tr32.gen_step(s0, x, w),
               "gan": tr32.gen_step(s0, x, w, use_gan=True),
               "disc": tr32.disc_step(s0, x, w)}
    twins = {"gen": plain16[0](s0, x, w, keep_grads=True),
             "gan": plain16[0](s0, x, w, use_gan=True, keep_grads=True),
             "disc": plain16[1](s0, x, w)}
    torch.cuda.synchronize()
    for kind, (st, m) in steps16.items():
        scal = {k: float(v) for k, v in m.items()
                if hasattr(v, "dim") and v.dim() == 0}
        check(all(np.isfinite(v) for v in scal.values()),
              f"precision (a) {kind}: a metric is not finite: {scal}")
        check(all(t.dtype == torch.float32 for t in tree_leaves(
            (st.params, st.opt_state.mu, st.opt_state.nu, st.disc_params,
             st.disc_opt_state.mu, st.disc_opt_state.nu))),
              f"precision (a) {kind}: a master or Adam leaf is not float32")
    gan_rel = {k: abs(float(steps16[kd][1][k]) - float(steps32[kd][1][k]))
               / abs(float(steps32[kd][1][k]))
               for kd, ks in (("gan", ("loss_gen", "loss_feat")),
                              ("disc", ("loss_disc",))) for k in ks}
    check(max(gan_rel.values()) <= 0.1,
          f"precision (a): GAN terms beyond rtol 0.1 of float32: {gan_rel}")
    twin_rel, off = {}, {}
    for kind in steps16:
        m, mp = steps16[kind][1], twins[kind][1]
        for k in ("loss", "loss_gen", "loss_feat", "loss_disc"):
            if k in m:
                twin_rel[f"{kind} {k}"] = (abs(float(m[k]) - float(mp[k]))
                                           / abs(float(mp[k])))
        if "codes" in m:
            flagged = ((m["margins"] < TIE_THRESHOLD)
                       | (mp["margins"] < TIE_THRESHOLD)).any(0)
            diff = (m["codes"] != mp["codes"]).any(1).reshape(-1)
            off[kind] = (int((diff & ~flagged).sum()),
                         int((~flagged).sum()))
    check(max(twin_rel.values()) <= PREC_LOSS_REL,
          f"precision (a): bf16 losses off the plain twins' beyond "
          f"{PREC_LOSS_REL:g}: {twin_rel}")
    held = hold_captured(torch, kernels, seen, "precision (a)")
    print(f"precision (a) bf16 steps, gan.yaml as written at B={PREC_B} x "
          f"4 h, from a float32 state after the k-means step: generator, "
          f"GAN generator and discriminator steps finite, masters and Adam "
          f"float32; {bf16_ms:.1f} ms for the three (first calls); GAN "
          f"terms vs float32 (rtol 0.1): " + ", ".join(
              f"{k} {v:.3g}" for k, v in gan_rel.items())
          + "; vs the plain twins in bf16 (bound "
          f"{PREC_LOSS_REL:g}): " + ", ".join(
              f"{k} {v:.3g}" for k, v in twin_rel.items())
          + "; codes off the twins' at " + ", ".join(
              f"{k} {n} of {t}" for k, (n, t) in off.items())
          + " positions untied in float32 (reported); on the step's own "
          f"inputs against the twins: {held}; launches K1 "
          f"{counts_train['nearest_codebook']}, K3 grid "
          f"{counts_train['lstm_grid']} (saving forward "
          f"{counts_train['lstm_save']}), K3 backward "
          f"{counts_train['lstm_scan_backward']}")
    del steps16, steps32, twins, tr16, tr32, s0, x
    torch.cuda.empty_cache()

    # -- (b) set_precision on a 10 s 24 kHz request ------------------------
    wav = request_audio(10.0, model.sample_rate, 160)
    model.set_target_bandwidth(6.0)
    before = tf32_flags(torch)
    xin = torch.from_numpy(wav[None]).to(dev)
    kernels.reset_launch_counts()
    served = {}
    for mode in ("high", "fast"):
        model.set_precision(mode)
        t0 = time.perf_counter()
        (frames, audio), seen = capture_first(torch, lambda: (
            lambda f: (f, model.decode(f)))(model.encode(xin)))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(tf32_flags(torch) == before,
              f"precision (b) {mode}: the TF32 flags changed")
        served[mode] = (frames[0][0], audio, ms, seen)
        try:
            compress(model, wav, models=registry)
            refused = False
        except RuntimeError as exc:
            refused = str(exc).startswith(
                f"refusing to write .ecdc at set_precision({mode!r})")
        check(refused, f"precision (b): the writer did not refuse {mode!r}")
        if mode == "high":
            # the guard as a model call (K1 per stage); its codes decode
            (guarded, _), seen_k1 = capture_first(
                torch, lambda: model.encode_guarded(xin))
            seen.update(seen_k1)
            back = model.decode(guarded)
            check(tuple(back.shape) == tuple(xin.shape)
                  and bool(torch.isfinite(back).all()),
                  "precision (b): the guarded 'high' codes do not decode")
        check(tf32_flags(torch) == before,
              f"precision (b) {mode}: the TF32 flags changed")
    counts_req = launch_counts(kernels)
    model.set_precision("highest")
    for k in ("nearest_codebook", "rvq_encode_fused", "lstm_scan"):
        check(counts_req.get(k, 0) > 0,
              f"precision (b): {k} never launched at 'high' or 'fast'")
    # each mode's kernels against the plain twins at the same mode
    lines = []
    x3 = xin.transpose(1, 2)
    n_q = model.n_q_active
    for mode, (codes, audio, ms, seen) in served.items():
        model.set_precision(mode)
        dt = model.compute_dtype
        with precision_scope(mode), torch.inference_mode():
            pc, _ = encode_frame(model.infer_params, model.qstate, x3,
                                 model.cfg, n_q, plain=True,
                                 compute_dtype=dt)
            _, _, _, mg = encode_frame_margins(
                model.infer_params, model.qstate, x3, model.cfg, n_q,
                compute_dtype=dt)
            _, _, _, mgp = encode_frame_margins(
                model.infer_params, model.qstate, x3, model.cfg, n_q,
                plain=True, compute_dtype=dt)
            pa = decode_frame(model.infer_params, model.qstate, codes,
                              model.cfg, plain=True, compute_dtype=dt)
        flagged = ((mg < TIE_THRESHOLD) | (mgp < TIE_THRESHOLD)).any(1)[0]
        diff = (codes[0] != pc[0]).any(0)
        a_err = float((audio[0].transpose(0, 1) - pa[0]).abs().max())
        if mode == "high":      # float32 trunks rounded to TF32 inside cuDNN
            check(int((diff & ~flagged).sum()) == 0,
                  f"precision (b) {mode}: codes differ from the plain "
                  "twins' outside the tie flags")
            check(a_err <= 1e-3, f"precision (b) {mode}: audio {a_err:.3g} "
                  "from the plain twins' decode (bound 0.001)")
        held = hold_captured(torch, kernels, seen, f"precision (b) {mode}")
        lines.append(f"{mode} {ms:.1f} ms, codes vs twins {int(diff.sum())} "
                     f"of {diff.numel()} differ ({int(flagged.sum())} "
                     f"tie-flagged), audio max|d| {a_err:.3g}"
                     + (" (held: codes outside the flags, audio 1e-3)"
                        if mode == "high" else " (reported)")
                     + f"; on the path's inputs: {held}")
    model.set_precision("highest")
    print("precision (b) a 10 s 24 kHz request at 6 kbps: " + "; ".join(
        lines) + f"; .ecdc refused at 'high' and 'fast', the guarded 'high' "
          f"codes decoded; "
          f"TF32 flags {before} before and after every call; launches K1 "
          f"{counts_req['nearest_codebook']}, K2 "
          f"{counts_req['rvq_encode_fused']}, K3 {counts_req['lstm_scan']}")
    print(f"precision: the phase took {time.perf_counter() - t_phase:.1f} s")
    tmp.cleanup()
    return counts_train, counts_req


def launch_counts(kernels) -> dict:
    """The wrappers' launch counts, and those of K3's grid kernel, K3's
    cluster backward and K1's row-block route."""
    return dict(kernels.launch_counts(),
                lstm_grid=kernels.lstm_scan.grid_launches,
                lstm_bwd_cluster=kernels.lstm_scan_backward.cluster_launches,
                nearest_rowblock=kernels.nearest_codebook.rowblock_launches)


KERNEL_GROUPS = (("K2", "vq_rvq_kernel"), ("K1", "vq_nearest_kernel"),
                 ("K1", "vq_nearest_rowblock_kernel"),
                 ("K3", "lstm_scan_kernel"), ("K3", "lstm_grid_kernel"),
                 ("K3 backward", "lstm_bwd_kernel"),
                 ("K3 backward", "lstm_bwd_cluster_kernel"),
                 ("AC", "ac_head_pull_kernel"))


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
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"device: {card}")
    print(smi[0] if smi else "nvidia-smi: no output")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    t_phases = time.perf_counter()

    took = {}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        took[label] = time.perf_counter() - t0
        return out

    k1 = timed("K1", phase_k1, torch, kernels, dev)
    k2 = timed("K2", phase_k2, torch, kernels, dev)
    k3 = timed("K3", phase_k3, torch, kernels, dev)
    counts, model, registry, wav10 = timed("main path", phase_main_path,
                                           torch, kernels, dev)
    timed("profile", phase_profile, torch, kernels, model, registry, wav10,
          k2["ms"])
    counts48, model48, wav48 = timed("main path 48", phase_main_path_48,
                                     torch, kernels, dev)
    timed("profile 48", phase_profile_48, torch, model48, wav48)
    timed("CLI 48", phase_cli_48, model48)
    timed("K3 state", phase_k3_state, torch, kernels, dev)
    counts_stream = timed("stream", phase_stream, torch, kernels, model)
    k3_grid = timed("K3 grid", phase_k3_grid, torch, kernels, dev)
    counts_breathing = timed("breathing", phase_breathing, torch, kernels,
                             dev)
    counts_hires = timed("hires", phase_hires, torch, kernels, dev)
    k3_bwd, k3_bwd_cluster = timed("K3 backward", phase_k3_bwd, torch,
                                   kernels, dev)
    counts_train, train_tmp, train_run, k1_train = timed(
        "train", phase_train, torch, kernels, dev)
    counts_gan = timed("gan", phase_gan, torch, kernels, dev)
    counts_cfg, cfg_rows = timed("configs", phase_configs, torch, kernels,
                                 dev)
    counts_lm, ac = timed("lm", phase_lm, torch, kernels, model, model48,
                          wav10, wav48)
    counts_lm_train = timed("lm_train", phase_lm_train, torch, kernels,
                            model, registry, train_run)
    train_tmp.cleanup()
    counts_par, counts_ranks = timed("parallel", phase_parallel, torch,
                                     kernels, dev, model)
    counts_seq = timed("seq", phase_seq_parallel, torch, kernels, dev)
    counts_bf16, counts_prec = timed("precision", phase_precision, torch,
                                     kernels, dev, model, registry)
    print("phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in took.items())
          + f" (the build and the start {t_phases - t_start:.1f} s)")

    paths = {"24k": counts, "48k": counts48, "stream": counts_stream,
             "breathing": counts_breathing, "hires_tokens": counts_hires,
             "train": counts_train, "gan": counts_gan, "lm": counts_lm,
             "lm_train": counts_lm_train, "parallel_nccl_w1": counts_par}
    for r, c in enumerate(counts_ranks):
        paths[f"parallel_gloo_w2_rank{r}"] = c
    for r, c in enumerate(counts_seq):
        paths[f"seq_gloo_1x2_rank{r}"] = {k: v for k, v in c.items()
                                          if k != "lstm_save"}
    paths["bf16_train"] = {k: v for k, v in counts_bf16.items()
                           if k != "lstm_save"}
    paths["precision_high_fast"] = counts_prec
    for cfg_name, c in counts_cfg.items():
        paths[f"configs_{cfg_name}"] = c
    for c in paths.values():   # lstm_scan, nearest_codebook and
        # lstm_scan_backward count both of their kernels
        c["lstm_cluster"] = c["lstm_scan"] - c["lstm_grid"]
        c["nearest_cluster"] = c["nearest_codebook"] - c["nearest_rowblock"]
        c["lstm_bwd_grid"] = c["lstm_scan_backward"] - c["lstm_bwd_cluster"]
    rows = [
        ("K1 nearest_codebook (cluster route)", "vq_search.cu",
         "kernels/vq_pallas.py:43", "nearest_cluster", k1),
        ("K1 nearest_codebook (row-block route), N=15,360, D=256, bins=1024 "
         "(default.yaml training, B=32)", "vq_search.cu",
         "kernels/vq_pallas.py:43", "nearest_rowblock", k1_train),
        ("K2 rvq_encode_fused", "vq_search.cu", "kernels/vq_pallas.py:124",
         "rvq_encode_fused", k2),
        ("K3 lstm_scan (cluster kernel, H <= 512)", "lstm_scan.cu",
         "kernels/lstm_pallas.py:55", "lstm_cluster", k3),
        ("K3 lstm_scan (grid kernel, 512 < H <= 1024)", "lstm_grid.cu",
         "kernels/lstm_pallas.py:55", "lstm_grid", k3_grid),
        # no TPU kernel: JAX's trainer differentiates the LSTM's lax.scan
        ("K3 lstm_scan_backward (grid backward, 512 < H <= 1024)",
         "lstm_bwd.cu", "ops/lstm.py:56-72", "lstm_bwd_grid", k3_bwd),
        ("K3 lstm_scan_backward (cluster backward, H <= 512), B=8, T=1440, "
         "H=512", "lstm_bwd_cluster.cu", "ops/lstm.py:56-72",
         "lstm_bwd_cluster", k3_bwd_cluster),
        # no TPU kernel: JAX runs its CDF head and scans the range decoder
        # in XLA
        ("AC ac_head_pull", "ac_decode.cu",
         "stream/device_ac.py:222 + encodec_tpu/models/ilm.py:661",
         "ac_head_pull", ac),
    ]
    # the configs' own shapes (phase_configs), each on its path's inputs
    for kind, src, rep, fn, label in (
            ("K1", "vq_search.cu", "kernels/vq_pallas.py:43",
             "nearest_codebook", "K1 nearest_codebook"),
            ("K3 forward", "lstm_scan.cu", "kernels/lstm_pallas.py:55",
             "lstm_cluster", "K3 lstm_scan saving forward (cluster kernel)"),
            ("K3 backward", "lstm_bwd.cu", "ops/lstm.py:56-72",
             "lstm_scan_backward", "K3 lstm_scan_backward")):
        for cfg_name, m in cfg_rows[kind]:
            m = dict(m)
            name, counter, source = label, fn, src
            if kind == "K1":   # the route its plan took, and that counter
                route = m.pop("k1_route")
                counter = f"nearest_{route}"
                name = (f"{label} (row-block route)" if route == "rowblock"
                        else f"{label} (cluster route)")
            if kind == "K3 backward":   # the same for the backward
                route = m.pop("k3_bwd_route")
                counter = f"lstm_bwd_{route}"
                name = f"{label} ({route} backward)"
                source = ("lstm_bwd_cluster.cu" if route == "cluster"
                          else "lstm_bwd.cu")
            if kind == "K3 forward":
                name = f"{label}, {m.pop('k3_seqs')} sequence(s) per cluster"
            rows.append((f"{name}, {m.pop('shape')} ({cfg_name}.yaml)",
                         source, rep, counter, m))
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda",
         "source": f"encodec_tpu_torch/kernels/csrc/{src}",
         "replaces": f"encodec_tpu/{rep}",
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
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
