"""The batch reductions of the losses and the quantizer's training half.

A training step's losses are means over its batch, and the quantizer's
statistics and draws see every row of the batch. Under data parallelism a
rank holds only its rows of the global batch, so these reductions must
span the ranks. The functions that make them take a `dp` argument: the
single process passes `LOCAL` (the default), whose methods return their
input; a data-parallel step passes `parallel.comm.DataParallel`, the same
methods over its data group, which also checks at the end of the step
that every metric came out equal on every rank (a batch mean that skipped
`dp` differs between the ranks, so it fails at the first step).
"""

from __future__ import annotations

import typing as tp

import torch


class BatchReduce:
    """The single process's reductions: the batch is this process's rows."""

    def mean(self, m: torch.Tensor) -> torch.Tensor:
        """`m`, a mean over this process's rows, as the batch mean."""
        return m

    def sum(self, s: torch.Tensor) -> torch.Tensor:
        """`s`, a sum over this process's rows, as the batch sum."""
        return s

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows `x` → the batch's rows (no gradient)."""
        return x

    def rows(self) -> tp.Tuple[int, int]:
        """(this process's index, the process count) over the batch."""
        return 0, 1

    def check_replicated(self, metrics: tp.Mapping[str, tp.Any]) -> None:
        """Raise if a scalar metric is not the same on every process."""


LOCAL = BatchReduce()
