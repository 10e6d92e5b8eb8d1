"""One run of one cell: the command line, the card check, the driver, the
per-layer readers, the import check and the result's last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

A run needs a CUDA card (as many as the cell asks for): without one it
exits 2 and prints no result. `--control tf32` runs the correctness
check's control in the program's place (see `lib/train_cell.py`,
`lib/codec_batch_cell.py`) and prints its readings; the benchmark's own runs
never pass it. `main(..., allow_cpu=True, overrides=...)` runs on the CPU
at a size the overrides give, for the tests: it reports no metric.

The last line on standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (`--trace 0`: the cell's end-to-end
metrics; `--trace 1`: its per-layer metrics), `device`, with `--trace 1`
`breakdown`, and last `checks`: each number the correctness check
compared, with its limit. The checks are also the last lines on standard
error.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time
import typing as tp

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "encodec_tpu")


def forbidden_modules(modules: tp.Iterable[str]) -> tp.List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of `FORBIDDEN`, compared whole."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


class Run(tp.NamedTuple):
    cell: str
    seed: int
    seconds: float
    trace: bool
    control: tp.Optional[str]
    workload: dict
    config: dict
    device: tp.Any          # torch.device
    t_start: float


class Outcome(tp.NamedTuple):
    """What a driver hands back. `measured`: end-to-end readings by metric
    name; `checks`: {name: (value, limit)}; `metric_context`: what the
    per-layer readers read (traced runs)."""
    measured: dict
    checks: tp.Dict[str, tp.Tuple[float, tp.Optional[float]]]
    attempted: int
    failed: int
    memory_peak_bytes: int
    metric_context: tp.Any = None


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32", "half", "frozen"),
                   default=None)
    return p.parse_args(argv)


def power_limit_w() -> tp.Optional[float]:
    """The card's power limit from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _driver(kind: str):
    """The driver of a traffic kind: `lib/<kind>_cell.py`, found by name, so
    that a new kind is a new file."""
    if not kind.isidentifier():
        raise ValueError(f"bad traffic kind {kind!r}")
    try:
        return importlib.import_module(f"{__package__}.{kind}_cell")
    except ModuleNotFoundError as e:
        if e.name != f"{__package__}.{kind}_cell":
            raise
        raise ValueError(f"no driver lib/{kind}_cell.py for traffic kind "
                         f"{kind!r}") from None


def main(argv=None, t_start: tp.Optional[float] = None,
         allow_cpu: bool = False, overrides: tp.Optional[dict] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    bench = spec.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    over = overrides or {}
    wl = spec.merge(spec.workload(args.workload), over.get("workload"))
    cfg = spec.merge(spec.config(wl["config"]), over.get("config"))
    chips = cells[args.workload]["chips"]

    import torch
    if torch.cuda.is_available() and torch.cuda.device_count() >= chips:
        device = torch.device("cuda")
    elif allow_cpu:
        device = torch.device("cpu")
    else:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    run = Run(args.workload, args.seed, args.seconds, bool(args.trace),
              args.control, wl, cfg, device, t_start)
    out = _driver(wl["traffic"]["kind"]).run(run)

    bad = forbidden_modules(sys.modules)
    if bad:
        print("portbench: the run loaded " + ", ".join(bad), file=sys.stderr)
        return 3

    on_card = device.type == "cuda"
    metrics: dict = {}
    breakdown = None
    dev: dict = {"platform": "gpu" if on_card else "cpu",
                 "kind": (torch.cuda.get_device_name(0) if on_card
                          else "cpu"),
                 "count": chips if on_card else 0,
                 "memory_peak_bytes": int(out.memory_peak_bytes)}
    if on_card:
        dev["power_limit_w"] = power_limit_w()
    if on_card and not args.trace and args.control is None:
        for m in spec.metrics_for(bench, args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": out.measured[m["name"]],
                                  "unit": m["unit"]}
    if args.trace:
        ctx = out.metric_context
        if on_card:
            for m in spec.metrics_for(bench, args.workload, "per_layer"):
                value = spec.reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            dev["busy_s"] = ctx.trace.busy_s
            dev["window_s"] = ctx.trace.window_s
        if ctx is not None:
            breakdown = {"device_ops": [list(x) for x in ctx.trace.top_ops],
                         "idle_gaps": [list(x) for x in ctx.trace.idle_gaps]}
            per_unit = {g: round(1e3 * s / max(ctx.units, 1), 4)
                        for g, s in ctx.trace.groups.items() if s > 0}
            print("device ms per unit by group " + json.dumps(per_unit)
                  + f" over {ctx.units} units; launches "
                  + json.dumps(ctx.launches) + ", records "
                  + json.dumps(ctx.trace.own_records), file=sys.stderr)

    correct = out.failed == 0 and bool(out.checks) and all(
        limit is not None and value <= limit
        for value, limit in out.checks.values())
    checks = {k: {"value": v, "limit": lim}
              for k, (v, lim) in out.checks.items()}
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


class MetricContext(tp.NamedTuple):
    """What a per-layer reader (`metrics/<name>.py`) reads: the cell's
    traffic kind, architecture, traffic and configuration file, the traced
    window (`lib.trace.Trace`), its units of work (`units`: training
    iterations or codec batches; `work`: the calls they made, one "batch"
    per codec batch), and the launches the port's own counters made in
    it, by kernel name."""
    kind: str
    arch: dict
    traffic: dict
    config: dict
    trace: tp.Any
    units: int
    work: tp.List[str]
    launches: tp.Dict[str, int]
