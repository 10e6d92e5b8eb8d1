#!/usr/bin/env python3
"""Where the device idles in the benchmark's two cells, named by the
port's own spans, and what each span costs with and without the profiler.

    python3 probes/idle_by_span.py [--cell recon|batch16 ...] [--seed N]
                                   [--out FILE]

Each cell is set up as `portbench/lib/<kind>_cell.py` sets it up (the
configuration's trainer or model from `portbench/configs/`, weights
drawn from the seed on the card, the book or books drawn from the first
batch's latents, the traffic's batches; no correctness check) and warmed
up on two units. Then the traced window's units of the cell (3 recon
generator iterations, one in flight and one synchronize at the end; 12
batch16 batches, each encode, decode and synchronize) run twice:

1. untraced: `profiling.tracing()` without a profiler, so each span's
   stream ms (CUDA events) and host ms are free of the profiler's per-op
   host cost;
2. traced: one `torch.profiler` window (CPU and CUDA activity, one unit
   in its warm-up phase first, as `portbench/lib/trace.py` records), the
   same spans' stream and host ms, and every idle gap between the
   device's merged intervals (kernels, copies, sets) inside the window,
   named by the innermost span open on the host when the CUDA runtime
   call that launched the gap's next device record was made (the
   record's correlation id); `(outside)` where the host was in no span,
   `(tail)` for the gap from the last record to the window's end.

Prints, per cell, the idle ms per unit by span (gaps, longest) and each
span's stream and host ms per unit traced and untraced, then a last JSON
line `{"idle_by_span": ...}` with the card's name and power limit; the
same JSON goes to `--out` (default `chiprun_out/idle_by_span.json`).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import typing as tp

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from encodec_tpu_torch.quant import RVQState  # noqa: E402
from encodec_tpu_torch.utils import profiling  # noqa: E402

CELLS = {"recon": "breathing_default.recon",
         "batch16": "encodec_24khz.batch16"}
EDGE_S = 0.05


def _sync() -> None:
    torch.cuda.synchronize()


def recon_units(seed: int, dev) -> tp.Tuple[tp.Callable[[int], None], int]:
    """`unit(i)`: one generator iteration on batch i of the pool, as the
    cell's window runs it (no synchronize); and the window's units."""
    from encodec_tpu_torch.models.seanet import seanet_encoder
    from encodec_tpu_torch.train import ConfigNamespace, Trainer
    from encodec_tpu_torch.train.steps import create_train_state
    from portbench.lib import inputs, spec
    from portbench.reference import rvq as ref_rvq

    wl = spec.workload(CELLS["recon"])
    cfg = spec.config(wl["config"])["config"]
    traffic = wl["traffic"]
    log_dir = tempfile.mkdtemp(prefix="idle-by-span-")
    try:
        trainer = Trainer(ConfigNamespace(cfg), None, None, log_dir,
                          device=dev)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    gen = inputs.device_generator(seed, dev)
    inputs.fill_weights(trainer.model.params, gen)
    trainer.model.params = trainer.model.params
    state = create_train_state(trainer.model, trainer.disc_cfg,
                               seed=cfg["common"]["seed"], clip=trainer.clip)
    batches = [inputs.breathing(gen, traffic["batch"], traffic["length"],
                                cfg["model"]["sample_rate"])[..., None]
               .contiguous() for _ in range(traffic["pool"])]
    with torch.no_grad():
        z = seanet_encoder(state.params["encoder"], batches[0],
                           trainer.model.cfg.seanet)
    drawn = ref_rvq.drawn_books(z, trainer.model.cfg.rvq.bins, gen)
    del z
    box = {"state": state._replace(qstate=RVQState(
        *(t[None].clone() for t in drawn), inited=True))}
    weights = trainer.weights_for_epoch(traffic["epoch"])

    def unit(i: int) -> None:
        box["state"], _ = trainer.gen_step(box["state"],
                                           batches[i % len(batches)],
                                           weights)

    return unit, wl["trace"]["iterations"]


def batch16_units(seed: int, dev) -> tp.Tuple[tp.Callable[[int], None],
                                               int]:
    """`unit(i)`: one batch of host clips encoded, decoded and waited
    for, as the cell's window runs it; and the window's units."""
    import encodec_tpu_torch.models as models
    from encodec_tpu_torch.models.seanet import seanet_encoder
    from portbench.lib import inputs, spec
    from portbench.lib.codec_batch_cell import _books

    wl = spec.workload(CELLS["batch16"])
    program = spec.config(wl["config"])["program"]
    traffic = wl["traffic"]
    model = getattr(models, program["factory"])(
        device=dev, **program.get("kwargs", {}))
    gen = inputs.device_generator(seed, dev)
    inputs.fill_weights(model.params, gen)
    model.params = model.params
    pool = [inputs.audio(gen, traffic["batch"], traffic["length"],
                         model.sample_rate)[:, None]
            for _ in range(traffic["pool"])]
    with torch.no_grad():
        z = seanet_encoder(model.infer_params["encoder"],
                           pool[0].transpose(1, 2), model.cfg.seanet)
    shape = tuple(model.qstate.embed.shape)
    books = _books(z, shape, gen)
    model.qstate = RVQState(books.clone(), books.clone(),
                            torch.zeros(shape[:2], device=dev), True)
    model.set_target_bandwidth(traffic["bandwidth_kbps"])
    host = [x.cpu() for x in pool]
    del pool, z

    def unit(i: int) -> None:
        model.decode(model.encode(host[i % len(host)]))
        _sync()

    return unit, wl["trace"]["batches"]


def by_span(recs, n: int) -> tp.Dict[str, dict]:
    """Per span name: calls, stream ms and host ms per unit."""
    out: tp.Dict[str, dict] = {}
    for r in recs:
        d = out.setdefault(r.name, {"calls": 0, "stream_ms": 0.0,
                                    "host_ms": 0.0})
        d["calls"] += 1
        d["stream_ms"] += (r.stream_ms or 0.0)
        d["host_ms"] += (r.end_ns - r.start_ns) / 1e6
    return {k: {"calls": v["calls"] / n, "stream_ms": v["stream_ms"] / n,
                "host_ms": v["host_ms"] / n} for k, v in out.items()}


def _span_at(recs, t: int) -> str:
    """The innermost span open at host time `t` (ns)."""
    best = None
    for r in recs:
        if r.start_ns <= t < r.end_ns and (best is None
                                           or r.start_ns >= best.start_ns):
            best = r
    return "(outside)" if best is None else best.name


def idle_gaps(events, recs, t0: int, t1: int):
    """The idle gaps of the device inside [t0, t1] (ns), each named by the
    span open at the launch of the record that ended it; and how the
    launches were found (runtime call, or only the launching operation)."""
    from torch.autograd import DeviceType

    runtime: tp.Dict[int, int] = {}
    ops: tp.Dict[int, int] = {}
    device = []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and \
                    not e.name().startswith("ProfilerStep") and \
                    e.end_ns() > t0 and e.start_ns() < t1:
                device.append(e)
        elif e.name().startswith("cu"):
            runtime[e.correlation_id()] = e.start_ns()
        else:
            ops[e.correlation_id()] = e.start_ns()
    device.sort(key=lambda e: e.start_ns())
    merged: tp.List[list] = []          # [start, end, first record]
    for e in device:
        s, f = max(e.start_ns(), t0), min(e.end_ns(), t1)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], f)
        else:
            merged.append([s, f, e])
    found = {"runtime": 0, "op": 0, "none": 0}

    def launched(e) -> tp.Optional[int]:
        t = runtime.get(e.correlation_id())
        if t is not None:
            found["runtime"] += 1
            return t
        t = ops.get(e.linked_correlation_id())
        found["op" if t is not None else "none"] += 1
        return t

    gaps = []
    prev_end = t0
    for s, f, first in merged:
        if s > prev_end:
            t = launched(first)
            gaps.append(("(no launch)" if t is None else _span_at(recs, t),
                         (s - prev_end) / 1e6))
        prev_end = max(prev_end, f)
    if t1 > prev_end:
        gaps.append(("(tail)", (t1 - prev_end) / 1e6))
    busy = sum(f - s for s, f, _ in merged) / 1e6
    return gaps, busy, found


def measure(cell: str, seed: int, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile, schedule

    unit, n = (recon_units if cell == "recon" else batch16_units)(seed, dev)
    unit(0)
    unit(1)
    _sync()
    i = 2

    profiling.reset()
    with profiling.tracing():
        t0 = time.time_ns()
        for _ in range(n):
            unit(i)
            i += 1
        _sync()
        untraced_ms = (time.time_ns() - t0) / 1e6
    untraced = by_span(profiling.records(), n)
    untraced_syncs = {k: v / n for k, v in profiling.counters().items()
                      if k.startswith("sync.")}

    profiling.reset()
    got: list = []
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: got.append(
                     p.profiler.kineto_results)) as prof:
        unit(i)
        i += 1
        _sync()
        prof.step()
        time.sleep(EDGE_S)
        t0 = time.time_ns()
        for _ in range(n):
            unit(i)
            i += 1
        _sync()
        t1 = time.time_ns()
        time.sleep(EDGE_S)
        prof.step()
    recs = profiling.records()
    traced = by_span(recs, n)
    gaps, busy, found = idle_gaps(got[0].events(), recs, t0, t1)
    idle: tp.Dict[str, dict] = {}
    for name, ms in gaps:
        d = idle.setdefault(name, {"gaps": 0, "ms": 0.0, "longest_ms": 0.0})
        d["gaps"] += 1
        d["ms"] += ms
        d["longest_ms"] = max(d["longest_ms"], ms)
    for d in idle.values():
        d["gaps"] /= n
        d["ms"] /= n
    window_ms = (t1 - t0) / 1e6
    return {"cell": CELLS[cell], "units": n,
            "window_ms_per_unit": {"traced": window_ms / n,
                                   "untraced": untraced_ms / n},
            "busy_ms_per_unit": busy / n,
            "idle_ms_per_unit": {k: idle[k] for k in sorted(
                idle, key=lambda k: -idle[k]["ms"])},
            "launches_found": found,
            "spans": {k: {"traced": traced.get(k), "untraced": v}
                      for k, v in untraced.items()},
            "syncs_per_unit": untraced_syncs}


def _print(res: dict) -> None:
    w = res["window_ms_per_unit"]
    print(f"{res['cell']}: {res['units']} units; window ms a unit traced "
          f"{w['traced']:.3f}, untraced {w['untraced']:.3f}; busy "
          f"{res['busy_ms_per_unit']:.3f}; launches found "
          f"{res['launches_found']}; syncs a unit {res['syncs_per_unit']}")
    print("  idle by span (ms a unit, gaps a unit, longest ms):")
    for name, d in res["idle_ms_per_unit"].items():
        print(f"    {name:16s} {d['ms']:9.4f} {d['gaps']:7.2f} "
              f"{d['longest_ms']:9.4f}")
    print("  span: calls a unit; stream ms traced / untraced; host ms "
          "traced / untraced")
    for name, d in res["spans"].items():
        t, u = d["traced"] or {}, d["untraced"]
        print(f"    {name:16s} {u['calls']:5.1f} "
              f"{t.get('stream_ms', float('nan')):10.4f} "
              f"{u['stream_ms']:10.4f} {t.get('host_ms', float('nan')):10.4f}"
              f" {u['host_ms']:10.4f}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="probes/idle_by_span.py")
    p.add_argument("--cell", nargs="+", choices=sorted(CELLS),
                   default=["recon", "batch16"])
    p.add_argument("--seed", type=int, default=3_000_000_211)
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "idle_by_span.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("idle_by_span: needs a CUDA card", file=sys.stderr)
        return 2
    from encodec_tpu_torch.kernels import build
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = None
    out = {"card": torch.cuda.get_device_name(0), "power_limit": limit,
           "torch": torch.__version__, "seed": args.seed, "cells": []}
    for cell in args.cell:
        res = measure(cell, args.seed, dev)
        _print(res)
        out["cells"].append(res)
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({"idle_by_span": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
