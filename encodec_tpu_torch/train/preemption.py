"""Graceful-preemption handling for long training runs.

A copy of `encodec_tpu/train/preemption.py`.

The reference has no failure handling at all (SURVEY §5: "failure
detection / elastic recovery: none" — a SIGTERM kills the run and loses
everything since the last periodic checkpoint). On shared clusters
preemption is routine — maintenance events and spot reclaims deliver
SIGTERM with a grace window — so the trainer treats it as a first-class
event: a `PreemptionGuard` flips a flag from the signal handler, the step loop
polls it at step boundaries (never mid-step: a step's update is atomic
from the loop's perspective), and `Trainer.fit` checkpoints before
returning. Combined with `Trainer.resume`'s self-contained run dir, a
preempted job restarted with the same command loses at most the
interrupted epoch.
"""

from __future__ import annotations

import logging
import signal
import threading
import typing as tp


class PreemptionGuard:
    """Installs signal handlers that request a graceful stop.

    Usage::

        with PreemptionGuard() as guard:
            for step in ...:
                if guard.requested:
                    save_checkpoint(...)
                    break
                state = train_step(state, ...)

    Handlers can only be installed from the main thread (a Python
    restriction); elsewhere the guard degrades to an inert flag and logs a
    warning rather than failing — the polling sites work unchanged.
    `request()` lets tests (or an external watchdog thread) trip the flag
    without an actual signal.
    """

    def __init__(self, signals: tp.Sequence[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._prev: tp.Dict[int, tp.Any] = {}
        self._requested = False

    # -- context manager ---------------------------------------------------
    def __enter__(self) -> "PreemptionGuard":
        self.install()
        return self

    def __exit__(self, *exc) -> None:
        self.restore()

    def install(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            logging.warning(
                "PreemptionGuard: not on the main thread; signal handlers "
                "not installed (flag-only mode)")
            return
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._on_signal)

    def restore(self) -> None:
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()

    # -- flag --------------------------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        logging.warning("received signal %d — will checkpoint and stop at "
                        "the next step boundary", signum)
        self._requested = True

    def request(self) -> None:
        """Trip the stop flag programmatically (tests, watchdogs)."""
        self._requested = True

    @property
    def requested(self) -> bool:
        return self._requested
