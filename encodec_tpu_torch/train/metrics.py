"""Metric accumulation (ref encodec/my_code/metrics.py — Metrics class).

A copy of `encodec_tpu/train/metrics.py` that also takes tensors (on any
device). Open key registry instead of the reference's fixed key dict: any
scalar (or per-item array, which is averaged) can be filled;
`compute_and_log_metrics` returns per-epoch means.
"""

from __future__ import annotations

import typing as tp
from collections import defaultdict

import numpy as np
import torch


def _mean(value) -> float:
    if isinstance(value, torch.Tensor):
        return float(value.detach().float().mean())
    return float(np.asarray(value).mean())


class Metrics:
    def __init__(self):
        self._sums: tp.Dict[str, float] = defaultdict(float)
        self._counts: tp.Dict[str, int] = defaultdict(int)

    def fill_metrics(self, values: tp.Mapping[str, tp.Any],
                     step: tp.Optional[int] = None) -> None:
        for key, value in values.items():
            self._sums[key] += _mean(value)
            self._counts[key] += 1

    def compute_and_log_metrics(self) -> tp.Dict[str, float]:
        return {k: self._sums[k] / max(1, self._counts[k]) for k in self._sums}

    def clear_metrics(self) -> None:
        self._sums.clear()
        self._counts.clear()
