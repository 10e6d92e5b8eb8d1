"""Stage timers and traces in torch's idiom.

Port of `encodec_tpu/utils/profiling.py`. CUDA work is asynchronous: a
host clock around a block measures the launches, not the device work,
unless the device is synchronized before the clock is read. `StageTimer`
synchronizes the current CUDA device and those of the tensors registered
with `watch` when a stage exits, even when the stage raises;
`device_trace` records a `torch.profiler` trace (host and CUDA activity)
for TensorBoard or Perfetto; `annotate` names a region in it.
"""

from __future__ import annotations

import contextlib
import time
import typing as tp

import torch


def _cuda_devices(value, out: set) -> None:
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)


class _StageHandle:
    """Collects a stage's outputs, so the timer knows at exit which
    devices to wait for."""

    def __init__(self):
        self._watched: list = []

    def watch(self, value):
        """Register a tensor (or a tree of them); returns it unchanged."""
        self._watched.append(value)
        return value


class StageTimer:
    """Host-clock stage timer that waits for the device's work.

    >>> timer = StageTimer()
    >>> with timer.stage("encode") as s:
    ...     frames = s.watch(model.encode(x))
    >>> timer.report()          # mean seconds per stage

    At exit the timer synchronizes the current CUDA device (when CUDA is in
    use in this process) and every CUDA device of the watched tensors, then
    reads the clock. A stage that raises is recorded all the same."""

    def __init__(self):
        self.times: tp.Dict[str, float] = {}
        self.counts: tp.Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        handle = _StageHandle()
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            devices: set = set()
            if torch.cuda.is_initialized():
                devices.add(torch.device("cuda", torch.cuda.current_device()))
            _cuda_devices(handle._watched, devices)
            for dev in devices:
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> tp.Dict[str, float]:
        """Mean seconds per stage."""
        return {k: self.times[k] / self.counts[k] for k in self.times}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A `torch.profiler` trace of the block (CPU activity, and CUDA
    activity when a GPU is present), written to `log_dir` for TensorBoard
    or Perfetto."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield


def annotate(name: str):
    """A named region in a `torch.profiler` trace."""
    return torch.profiler.record_function(name)
