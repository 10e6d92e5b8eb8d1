"""Offline dataset curation: blocklists and flat-signal patching.

Copy of `encodec_tpu/data/curation.py` (numpy only). Behavioral
reference: encodec/data/get_fns_to_ignore.py (sliding-std zero detection
→ blocklist) and encodec/data/filter_bwh.py (constant-window detection →
random-noise patching + start/end trim → `thorax_clipped` channel + CSV
metadata). These run once, offline, on the host.
"""

from __future__ import annotations

import json
import os
import typing as tp

import numpy as np


def sliding_std(data: np.ndarray, window_size: int) -> np.ndarray:
    """Rolling std via cumulative sums (ref get_fns_to_ignore.py:8-21)."""
    data = np.asarray(data, np.float64)
    c1 = np.concatenate([[0.0], np.cumsum(data)])
    c2 = np.concatenate([[0.0], np.cumsum(data ** 2)])
    s1 = c1[window_size:] - c1[:-window_size]
    s2 = c2[window_size:] - c2[:-window_size]
    mean = s1 / window_size
    var = s2 / window_size - mean ** 2
    return np.sqrt(np.maximum(var, 0.0))


def find_fns_to_ignore(data_dir: str, max_length: int,
                       fs: float = 10) -> tp.List[str]:
    """Blocklist nights that are too short or contain a zero-std window of
    `max_length` samples (ref get_fns_to_ignore.py main loop)."""
    ignore = []
    for fn in sorted(os.listdir(data_dir)):
        if not fn.endswith(".npz"):
            continue
        with np.load(os.path.join(data_dir, fn)) as z:
            breathing = np.asarray(z["data"]).squeeze()
        if breathing.shape[0] <= max_length:
            ignore.append(fn)
            continue
        if np.any(sliding_std(breathing, max_length) == 0):
            ignore.append(fn)
    return ignore


def find_constant_spans(x: np.ndarray, window: int) -> np.ndarray:
    """Start indices of windows whose samples are all equal to the window's
    first value (ref filter_bwh.py:27-31), without materializing the strided
    view comparison for the whole [N, window] matrix."""
    x = np.asarray(x)
    # a window starting at i is constant iff the diff run-length from i
    # covers at least `window` samples
    same_as_next = np.concatenate([x[1:] == x[:-1], [False]])
    # run[i] = number of consecutive "same" transitions starting at i
    # = distance to the next False at or after i (vectorized run length;
    # the python per-sample loop took tens of seconds on 8 h @ 200 Hz)
    idx = np.arange(len(x))
    false_pos = np.flatnonzero(~same_as_next)
    run = false_pos[np.searchsorted(false_pos, idx)] - idx
    return np.where(run >= window - 1)[0]


def clip_and_patch(x: np.ndarray, window: int,
                   min_valid: int,
                   rng: tp.Optional[np.random.RandomState] = None):
    """filter_bwh's curation for one night (ref filter_bwh.py:20-70):

    - if fewer than `min_valid` samples differ from the constant value,
      reject (return None);
    - trim leading constant region (within the first 25%) and trailing
      constant region (within the last 5%);
    - replace interior constant patches (25%..95%) with unit Gaussian noise.

    Returns (clipped_signal, start, end, patches) or None.
    """
    rng = rng or np.random.RandomState()
    x = np.asarray(x).copy()
    starts = find_constant_spans(x, window)
    if len(starts):
        val = x[starts[0]]
        if np.count_nonzero(x != val) < min_valid:
            return None
    n = x.shape[0]
    # `starts` is sorted — the three per-sample scans reduce to slices of
    # it (identical results; the python loops were tens of millions of
    # interpreted iterations per 8 h night)
    head = starts[starts < int(n * 0.25)]
    first_zero = int(head[-1]) + window if len(head) else 0
    tail = starts[starts > int(n * 0.95)]
    last_zero = int(tail[0]) if len(tail) else n
    patches: tp.List[tp.List[int]] = []
    mid = starts[(starts >= int(n * 0.25)) & (starts < int(n * 0.95))]
    for i in (int(v) for v in mid):
        if patches and i + window <= patches[-1][-1] + 1:
            patches[-1][-1] = i + window
        else:
            patches.append([i, i + window])
    for p0, p1 in patches:
        x[p0:p1] = rng.randn(p1 - p0)
    return x[first_zero:last_zero], first_zero, last_zero, patches


def curate_directory(data_dir: str, save_dir: str, *, fs: int = 200,
                     window_sec: float = 5.0, min_valid_hours: float = 4.0,
                     csv_path: tp.Optional[str] = None,
                     blocklist_path: tp.Optional[str] = None,
                     rng_seed: int = 0) -> tp.Tuple[dict, list]:
    """Run the full filter_bwh pipeline over a directory of npz nights."""
    os.makedirs(save_dir, exist_ok=True)
    window = int(fs * window_sec)
    min_valid = int(fs * 60 * 60 * min_valid_hours)
    mapping: dict = {}
    ignored: list = []
    rng = np.random.RandomState(rng_seed)
    for fn in sorted(os.listdir(data_dir)):
        if not fn.endswith(".npz"):
            continue
        try:
            with np.load(os.path.join(data_dir, fn)) as z:
                x = np.asarray(z["data"]).squeeze()
            result = clip_and_patch(x, window, min_valid, rng)
            if result is None:
                ignored.append(fn)
                continue
            clipped, start, end, patches = result
            np.savez(os.path.join(save_dir, fn), data=clipped, fs=fs)
            mapping[fn] = (start, end, patches)
        except Exception:
            ignored.append(fn)
    if csv_path:
        import csv
        with open(csv_path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["file", "start", "end", "patches"])
            for fn, (s, e, p) in mapping.items():
                w.writerow([fn, s, e, p])
    if blocklist_path:
        with open(blocklist_path, "w") as fh:
            fh.write(f"fns_to_ignore = {json.dumps(ignored)}")
    return mapping, ignored
