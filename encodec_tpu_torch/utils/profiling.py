"""The port's tracing: named spans and counters on its hot paths, on the
profiler's clock, and `torch.profiler` traces for TensorBoard or Perfetto.

Port of `encodec_tpu/utils/profiling.py`. CUDA work is asynchronous, so a
span does not read the host clock alone: it also records two CUDA events
on the current stream, and their elapsed time is the stream's time from
entry to exit, the device's idle inside the span included.

- `span(name)`: a named region. Off (the default) it is one shared no-op
  context, and its whole cost is a read of the profiler's enabled flag: no
  `record_function`, no CUDA event, no record. On, it opens a
  `torch.profiler.record_function(name)`, so the region lies in the
  profiler's trace beside the device's records, and keeps a `Record` (its
  name, its parent's name, the host clock at entry and exit in ns on the
  clock the profiler stamps its events with, the stream ms between its two
  events, None without CUDA, and the `sync.*` counts made inside it).
- On means that a `torch.profiler` is recording (its active phase; its
  warm-up phase does not count), or that `enable()` or `with tracing():`
  turned spans on without a profiler.
- `count(name, n=1)`: a counter, always on. `sync.<site>` counts a call of
  a hot path that waits for the device, where it really waits (a CUDA
  target), so that removing one shows.
- `records()`: the finished records, oldest first, their events resolved
  (one synchronize, at read time); `counters()`: the counters, beside the
  kernels' launch counts as `launch.<wrapper>`; `reset()` clears records
  and counters. At most `MAX_RECORDS` records are kept; those dropped
  are counted as `spans.dropped`.
- `device_trace(log_dir)`: a `torch.profiler` trace of a block, written
  for TensorBoard or Perfetto; the spans show in it by name.

The spans, where they are opened, and the benchmark's readers of them
(`portbench/metrics/`):
- `train.gen_step`, `train.disc_step` (`train/steps.py`, the whole step;
  the roots whose syncs `host_syncs.train` counts), inside them
  `train.forward`, `train.loss` and `train.backward`;
- `optim.adam` (`train/optim.py::adam_update`: the global norm, the clip
  and Adam): `optim_ms.train`;
- `seanet.encoder`, `seanet.decoder` (`models/model.py`, the conv trunks);
- `rvq.train`, `rvq.encode`, `rvq.decode` (`quant/rvq.py`):
  `rvq_ms.train`, `rvq_ms.codec`;
- `codec.encode`, `codec.decode`, `codec.input` (`models/model.py`,
  `EncodecModel`; the roots whose syncs `host_syncs.codec` counts);
- `lm_train.forward`, `.backward`, `.adam` (`train/lm_train.py`).

The counters: `sync.rvq_draw` (`quant/rvq.py::_draw`: an expiry or k-means
draw copied from the host), `sync.adam_scalar` (`train/optim.py`: the two
bias-correction scalars made on the host), `sync.codec_input`
(`models/model.py::_copy_in`: the caller's host audio, codes or scales
copied in).
"""

from __future__ import annotations

import contextlib
import threading
import time
import typing as tp

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_RECORDS = 100_000


class Record(tp.NamedTuple):
    name: str
    parent: tp.Optional[str]     # the enclosing span's name
    start_ns: int                # host clock (`time.time_ns`), the profiler's
    end_ns: int
    stream_ms: tp.Optional[float]  # CUDA events on the current stream
    syncs: int                   # `sync.*` counts made inside


_NULL = contextlib.nullcontext()
_forced = False
_lock = threading.Lock()
_local = threading.local()
_pending: list = []              # finished spans, events not yet resolved
_done: tp.List[Record] = []
_dropped = 0
_counters: tp.Dict[str, int] = {}
_syncs = 0


def span(name: str):
    """A named region: the shared no-op context when tracing is off, a
    recorded span when it is on (see the module's docstring)."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Span(name)


def _event() -> tp.Optional[torch.cuda.Event]:
    if not torch.cuda.is_initialized() or \
            torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("name", "parent", "fn", "t0", "ev0", "syncs0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        self.t0 = time.time_ns()
        self.ev0 = _event()
        self.syncs0 = _syncs
        return self

    def __exit__(self, *exc):
        global _dropped
        ev1 = _event() if self.ev0 is not None else None
        t1 = time.time_ns()
        self.fn.__exit__(*exc)
        _local.stack.pop()
        with _lock:
            if len(_pending) + len(_done) < MAX_RECORDS:
                _pending.append((self.name, self.parent, self.t0, t1,
                                 self.ev0, ev1, _syncs - self.syncs0))
            else:
                _dropped += 1
        return False


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` (always on)."""
    global _syncs
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
        if name.startswith("sync."):
            _syncs += n


def records() -> tp.List[Record]:
    """The finished spans, by entry time. Waits once for the device when a
    span's events have not been read yet."""
    with _lock:
        pending = _pending[:]
        del _pending[:]
    if any(p[4] is not None for p in pending):
        torch.cuda.synchronize()
    resolved = [Record(name, parent, t0, t1,
                       None if e0 is None else e0.elapsed_time(e1), syncs)
                for name, parent, t0, t1, e0, e1, syncs in pending]
    with _lock:
        _done.extend(resolved)
        return sorted(_done, key=lambda r: r.start_ns)


def counters() -> tp.Dict[str, int]:
    """The counters, the kernels' launches (`launch.<wrapper>`) and the
    records dropped past `MAX_RECORDS` (`spans.dropped`, when any)."""
    from ..kernels import launch_counts

    with _lock:
        out = dict(_counters)
        if _dropped:
            out["spans.dropped"] = _dropped
    out.update({f"launch.{k}": v for k, v in launch_counts().items()})
    return out


def reset() -> None:
    """Clear the records and the counters (not the kernels' own)."""
    global _dropped, _syncs
    with _lock:
        del _pending[:]
        del _done[:]
        _counters.clear()
        _dropped = _syncs = 0


def enable(on: bool = True) -> None:
    """Turn spans on (or off again) without a profiler."""
    global _forced
    _forced = on


@contextlib.contextmanager
def tracing():
    """Spans on inside the block, without a profiler."""
    global _forced
    before = _forced
    _forced = True
    try:
        yield
    finally:
        _forced = before


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A `torch.profiler` trace of the block (CPU activity, and CUDA
    activity when a GPU is present), written to `log_dir` for TensorBoard
    or Perfetto; spans are on inside it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield
