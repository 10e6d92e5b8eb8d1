"""One `torch.profiler` window of the timed path, reduced to what the
per-layer metrics read.

The window is the harness's `portbench.window` range. Inside it the
harness marks what the host is doing with `record_function` spans of its
own (`portbench.step`, `portbench.batch`, `portbench.encode`,
`portbench.decode`, `portbench.sync`). The profiler runs one unit of work
in its warm-up phase first (records on the H100 machine have come back
short at a window's start) and the harness waits a little at both edges.

From the records:
- `busy_s`: the union of the device intervals of every kernel, copy and
  set inside the window (not the ranges that mirror host spans on the
  device's timeline); `window_s` the window's length;
- `groups`: device seconds by `counts.names` group. The port's kernels by
  name; every other kernel by the aten operation that launched it; the
  rest is `elementwise`. A group is the sum of its kernels' durations.
  Operand shapes, which tell a 2-D conv from a 1-D one, are recorded only
  where the driver asks (`shapes`: a cell whose traffic runs 2-D convs),
  since recording them costs the host time inside the window; without
  them every conv counts as 1-D;
- `launches`: records of each of the port's kernels, held against the
  launches the port's own counters made, so a window that kept fewer
  records says so (`short`);
- `top_ops`: device seconds by kernel name; `idle_gaps`: each gap between
  device intervals, named by the innermost harness span the host was in
  when it opened.
"""

from __future__ import annotations

import time
import typing as tp
import warnings

import torch

from ..counts import names

EDGE_S = 0.05
SPANS = ("portbench.window", "portbench.step", "portbench.batch",
         "portbench.encode", "portbench.decode", "portbench.sync")


class Trace(tp.NamedTuple):
    window_s: float
    busy_s: float
    groups: tp.Dict[str, float]
    own_records: tp.Dict[str, int]
    top_ops: tp.List[tp.Tuple[str, float]]
    idle_gaps: tp.List[tp.Tuple[str, float]]


def record(warmup: tp.Callable[[], None], window: tp.Callable[[], None],
           sync: tp.Callable[[], None], shapes: bool = False) -> Trace:
    """Profile `window()` (which opens the `portbench.window` span itself)
    after `warmup()` in the profiler's warm-up phase; `sync` waits for the
    device; `shapes` records operand shapes."""
    from torch.profiler import ProfilerActivity, profile, schedule

    done: list = []
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=activities,
                     record_shapes=shapes,
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: done.append(p.events())) as prof:
            warmup()
            sync()
            prof.step()
            time.sleep(EDGE_S)
            window()
            sync()
            time.sleep(EDGE_S)
            prof.step()
    if not done:
        raise RuntimeError("the profiler returned no trace")
    return reduce(done[0])


def _merge(intervals: tp.List[tp.Tuple[float, float]]):
    out: tp.List[tp.List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events) -> Trace:
    """A `Trace` of a profile's events (µs time stamps)."""
    from torch.autograd import DeviceType

    spans = [e for e in events
             if e.name in SPANS and e.device_type != DeviceType.CUDA]
    win = [e for e in spans if e.name == "portbench.window"]
    if not win:
        raise RuntimeError("no portbench.window range in the trace")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and not _annotation(e)
               and e.time_range.end > w0 and e.time_range.start < w1]
    merged = _merge([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                     for e in kernels])
    busy = sum(e - s for s, e in merged)
    groups = {g: 0.0 for g in names.GROUPS}
    own: tp.Dict[str, int] = {}
    top: tp.Dict[str, float] = {}
    total = 0.0
    for e in kernels:
        dur = (e.time_range.end - e.time_range.start) / 1e6
        total += dur
        top[e.name[:80]] = top.get(e.name[:80], 0.0) + dur
        g = names.own_group(e.name)
        if g is not None:
            groups[g] += dur
            key = next(k for _, k in names.OWN_KERNELS if k in e.name)
            own[key] = own.get(key, 0) + 1
    attributed = 0.0
    for e in events:
        kern = getattr(e, "kernels", None)
        if not kern or e.device_type == DeviceType.CUDA:
            continue
        if not w0 <= e.time_range.start <= w1:
            continue
        g = names.op_group(e.name, getattr(e, "input_shapes", None))
        if g is None:
            continue
        for k in kern:
            if names.own_group(k.name) is None:
                groups[g] += k.duration / 1e6
                attributed += k.duration / 1e6
    own_total = sum(groups[g] for g in {g for g, _ in names.OWN_KERNELS})
    groups["elementwise"] = max(0.0, total - own_total - attributed)
    gaps = []
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        gaps.append((_span_at(spans, e0), (s1 - e0) / 1e6))
    if merged:
        gaps.append((_span_at(spans, w0), (merged[0][0] - w0) / 1e6))
        gaps.append(("sync", (w1 - merged[-1][1]) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, groups=groups,
                 own_records=own,
                 top_ops=sorted(top.items(), key=lambda kv: -kv[1])[:10],
                 idle_gaps=gaps[:10])


def _annotation(e) -> bool:
    """A range on the device's timeline that marks a host span (the
    harness's `record_function` ranges, the profiler's steps), not work."""
    return bool(getattr(e, "is_user_annotation", False)) or \
        e.name.startswith(("portbench.", "ProfilerStep"))


def _span_at(spans, t: float) -> str:
    """The innermost harness span open at `t` (µs), without its prefix."""
    best = None
    for e in spans:
        if e.time_range.start <= t < e.time_range.end:
            if best is None or e.time_range.start >= best.time_range.start:
                best = e
    return "other" if best is None else best.name.split(".", 1)[1]
