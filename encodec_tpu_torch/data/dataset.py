"""Breathing-signal datasets and batching.

A copy of `encodec_tpu/data/dataset.py` (numpy only).
Behavioral reference: encodec/data/dataset.py (BreathingDataset),
encodec/data/__init__.py (MergedDataset). Differences by design:
- the data root and blocklist are injected (no hard-coded cluster paths);
- bad files raise instead of `sys.exit` (the reference kills the worker);
- batching is a small self-contained loader producing numpy `[B, T, C]`
  arrays ready for the device, rather than torch's DataLoader.
"""

from __future__ import annotations

import os
import typing as tp

import numpy as np

from .preprocess import detect_motion_iterative, signal_crop, norm_sig


class BreathingDataset:
    """npz-per-night loader: `{root}/{dataset}/{channel}/*.npz` with keys
    `data` (signal) and `fs` (sampling rate)."""

    NumCv = 4
    supports_item_rng = True

    def __init__(self, root: str, dataset: str = "shhs2_new",
                 mode: str = "train", cv: int = 0,
                 channels: tp.Optional[tp.Dict[str, float]] = None,
                 max_length: int = 10 * 60 * 60 * 4,
                 blocklist: tp.Optional[tp.Iterable[str]] = None,
                 preprocessed: bool = False,
                 rng: tp.Optional[np.random.RandomState] = None):
        assert mode in ("train", "val", "test"), mode
        self.root = root
        self.dataset = dataset
        self.mode = mode
        self.cv = cv
        self.channels = channels or {"thorax": 1.0}
        self.max_length = max_length
        self.preprocessed = preprocessed  # skip motion/norm (cached data)
        self.rng = rng or np.random.RandomState()
        self.ds_dir = os.path.join(root, dataset)
        blocklist = set(blocklist or ())

        file_list: set = set()
        for channel in self.channels:
            chan_dir = os.path.join(self.ds_dir, channel)
            names = sorted(f for f in os.listdir(chan_dir)
                           if f.endswith(".npz"))
            file_list.update(f for f in names if f not in blocklist)
        file_list = sorted(file_list)

        train_list, val_list = self._split(file_list)
        self.file_list = {"train": train_list, "val": val_list,
                          "test": file_list}[mode]

    def _split(self, file_list):
        train, test = [], []
        for i, f in enumerate(file_list):
            (test if i % self.NumCv == self.cv else train).append(f)
        return train, test

    def __len__(self):
        return len(self.file_list)

    def process_signal(self, signal: np.ndarray, fs: float) -> np.ndarray:
        signal, _, _ = detect_motion_iterative(signal, fs)
        signal = signal_crop(signal)
        signal = norm_sig(signal)
        if fs != 10:
            from scipy.ndimage import zoom
            signal = zoom(signal, 10.0 / fs)
        return signal

    def __getitem__(self, idx: int,
                    rng: tp.Optional[np.random.RandomState] = None) -> dict:
        """`rng` makes the item's random draws (channel, crop start)
        self-contained and order-independent — required for deterministic
        multi-worker loading (DataLoader derives one per (seed, epoch,
        index)). Without it, draws mutate the shared `self.rng`."""
        rng = rng if rng is not None else self.rng
        filename = self.file_list[idx]
        names = list(self.channels.keys())
        probs = np.asarray([self.channels[c] for c in names], np.float64)
        probs = probs / probs.sum()
        selected = names[rng.choice(len(names), p=probs)]
        filepath = os.path.join(self.ds_dir, selected, filename)
        with np.load(filepath) as z:
            breathing = np.asarray(z["data"]).squeeze()
            fs = float(np.asarray(z["fs"]).reshape(-1)[0])

        if self.mode == "train":
            slack = breathing.shape[0] - self.max_length
            if slack < 0:
                raise ValueError(
                    f"{filename} in {self.dataset} is shorter "
                    f"({breathing.shape[0]}) than max_length {self.max_length}")
            start = rng.randint(0, slack + 1)
            breathing = breathing[start:start + self.max_length]
        elif self.mode == "val":
            breathing = breathing[:self.max_length]
        # test: full signal

        if not self.preprocessed:
            breathing = self.process_signal(breathing, fs)

        breathing = np.asarray(breathing, np.float32)
        # sign-flip so the majority of samples are negative (ref 115-118)
        if (breathing > 0).sum() > (breathing < 0).sum():
            breathing = -breathing

        if not np.isfinite(breathing).all():
            raise ValueError(f"bad file {filename}: NaN/Inf in signal")

        return {"x": breathing[None, :],  # [1, T] channel-first like the ref
                "y": 0,
                "filename": filename,
                "selected_channel": selected}


class MergedDataset:
    """Weighted multi-dataset sampler with a fixed virtual epoch
    (ref data/__init__.py:7-30)."""

    supports_item_rng = True

    def __init__(self, ds_list, weight_list, sfreq: float = 1.0,
                 debug: bool = False,
                 rng: tp.Optional[np.random.RandomState] = None):
        self.ds = list(ds_list)
        self.weight = np.asarray(weight_list, np.float64)
        self.weight /= self.weight.sum()
        assert self.weight[0] > 0
        self.size = round((512 if debug else 4096) * sfreq)
        self.mapping = {i: ds.dataset for i, ds in enumerate(self.ds)}
        self.rng = rng or np.random.RandomState()

    def __len__(self):
        return self.size

    def __getitem__(self, item: int,
                    rng: tp.Optional[np.random.RandomState] = None):
        rng = rng if rng is not None else self.rng
        ds_id = int(rng.choice(len(self.ds), p=self.weight))
        chosen = self.ds[ds_id]
        item_id = int(rng.randint(0, len(chosen)))
        if getattr(chosen, "supports_item_rng", False):
            return chosen.__getitem__(item_id, rng=rng), ds_id
        return chosen[item_id], ds_id


class DataLoader:
    """Minimal batching iterator → numpy `[B, T, C]` batches.

    Yields `(batch_dict, ds_ids)` where `batch_dict['x']` is `[B, T, C]`
    float32 (channels-last, device-ready). Short final batches are dropped
    to keep shapes jit-stable.

    `num_workers > 0` loads/preprocesses items on a thread pool and
    prefetches `prefetch` batches ahead of the training loop — the
    reference's DataLoader-worker role (its motion-detect preprocessing
    costs seconds per 4 h night); numpy/scipy release the GIL for the
    heavy parts.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 num_workers: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self._epoch = 0

    def _fetch_fn(self):
        """Per-item fetcher with order-independent randomness: each item's
        draws come from a RandomState derived from (seed, epoch, index), so
        threaded workers reproduce the serial path exactly — a shared
        mutable RandomState would interleave draws nondeterministically
        across threads."""
        epoch = self._epoch
        self._epoch += 1
        if not getattr(self.dataset, "supports_item_rng", False):
            return lambda j: self.dataset[int(j)]

        def fetch(j):
            ss = np.random.SeedSequence((self.seed, epoch, int(j)))
            rng = np.random.RandomState(ss.generate_state(4))
            return self.dataset.__getitem__(int(j), rng=rng)
        return fetch

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _collate(self, items):
        if isinstance(items[0], tuple):  # MergedDataset → (item, ds_id)
            ds_ids = np.asarray([it[1] for it in items])
            items = [it[0] for it in items]
        else:
            ds_ids = np.zeros(len(items), np.int32)
        xs = np.stack([it["x"] for it in items])      # [B, 1, T]
        batch = {
            "x": np.ascontiguousarray(xs.transpose(0, 2, 1)),  # [B, T, C]
            "filename": [it["filename"] for it in items],
            "selected_channel": [it["selected_channel"] for it in items],
        }
        return batch, ds_ids

    def _batched_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield idx

    def __iter__(self):
        fetch = self._fetch_fn()
        if self.num_workers <= 0:
            for idx in self._batched_indices():
                yield self._collate([fetch(j) for j in idx])
            return
        from concurrent.futures import ThreadPoolExecutor
        from collections import deque
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # flat per-item futures (no nested pool waits → no deadlock)
            def submit_batch(idx):
                return [pool.submit(fetch, int(j)) for j in idx]
            pending: deque = deque()
            it = self._batched_indices()
            try:
                for _ in range(self.prefetch):
                    pending.append(submit_batch(next(it)))
            except StopIteration:
                pass
            while pending:
                futures = pending.popleft()
                items = [f.result() for f in futures]
                try:
                    pending.append(submit_batch(next(it)))
                except StopIteration:
                    pass
                yield self._collate(items)
