"""BWH hospital dataset (200 Hz belts) loader.

Copy of `encodec_tpu/data/bwh.py` (numpy and scipy only; the port imports
nothing of the JAX package; its asserts raise ValueError here). Behavioral
reference: encodec/data/bwh.py — thorax-only (mapped to a
`thorax_clipped` curated channel), train mode reads a preprocessed 10 Hz
cache while val/test process the raw 200 Hz signal on the fly
(motion-detect → clip → normalize → 20x zoom-resample), modulo-4 CV split,
sign-flip convention, optional minimum-hours-of-sleep filter via stage
predictions (bwh.py:96-115).

Differences by design: paths are injected (the reference hard-codes cluster
paths), bad files raise, and the preprocessing cache is built by
`build_cache` here instead of by commented-out constructor code.
"""

from __future__ import annotations

import os
import typing as tp

import numpy as np

from .preprocess import detect_motion_iterative, signal_crop, norm_sig


class BwhDataset:
    NumCv = 4

    def __init__(self, root: str, dataset: str = "bwh_new",
                 mode: str = "train", cv: int = 0,
                 channels: tp.Optional[tp.Dict[str, float]] = None,
                 max_length: int = 10 * 60 * 60 * 4,
                 cache_dir: tp.Optional[str] = None,
                 stage_pred_dir: tp.Optional[str] = None,
                 min_sleep_hours: tp.Optional[float] = None,
                 blocklist: tp.Optional[tp.Iterable[str]] = None,
                 raw_channel: str = "thorax_clipped",
                 rng: tp.Optional[np.random.RandomState] = None):
        channels = channels or {"thorax": 1.0}
        if channels != {"thorax": 1.0}:
            raise ValueError("Only support thorax channel")
        if mode not in ("train", "val", "test"):
            raise ValueError(f"mode {mode!r}: expected train, val or test")
        self.dataset = dataset
        self.mode = mode
        self.cv = cv
        self.raw_channel = raw_channel
        self.root = root
        self.max_length = max_length
        self.max_length_200 = max_length * 20
        self.cache_dir = cache_dir or os.path.join(root, "bwh_encodec")
        self.rng = rng or np.random.RandomState()
        blocklist = set(blocklist or ())

        chan_dir = os.path.join(root, raw_channel)
        file_list = sorted(f for f in os.listdir(chan_dir)
                           if f.endswith(".npz") and f not in blocklist)
        if min_sleep_hours and stage_pred_dir:
            file_list = self._filter_by_sleep(file_list, stage_pred_dir,
                                              min_sleep_hours)

        train_list, val_list = self._split(file_list)
        self.file_list = {"train": train_list, "val": val_list,
                          "test": file_list}[mode]

    def _filter_by_sleep(self, file_list, stage_dir, min_hours):
        """Keep nights with more than `min_hours` of (predicted) sleep;
        stage predictions are 2 samples/minute (ref bwh.py:96-115)."""
        kept = []
        for filename in file_list:
            path = os.path.join(stage_dir, filename)
            try:
                with np.load(path) as z:
                    stages = np.asarray(z["data"])
            except Exception:
                continue
            sleep_epochs = int((stages != 0).sum())
            if sleep_epochs / (2 * 60) > min_hours:
                kept.append(filename)
        return kept

    def _split(self, file_list):
        train, test = [], []
        for i, f in enumerate(file_list):
            (test if i % self.NumCv == self.cv else train).append(f)
        return train, test

    def __len__(self):
        return len(self.file_list)

    def process_signal(self, signal: np.ndarray, fs: float) -> np.ndarray:
        if fs != 200:
            raise ValueError(f"fs is not 200 but {fs}")
        signal, _, _ = detect_motion_iterative(signal, fs)
        signal = signal_crop(signal)
        signal = norm_sig(signal)
        from scipy.ndimage import zoom
        return zoom(signal, 10.0 / fs)

    def build_cache(self, out_dir: tp.Optional[str] = None) -> int:
        """Preprocess raw 200 Hz nights into the 10 Hz training cache —
        the offline step the reference ran once (bwh.py:56-84)."""
        out_dir = out_dir or self.cache_dir
        os.makedirs(out_dir, exist_ok=True)
        written = 0
        for filename in self.file_list:
            path = os.path.join(self.root, self.raw_channel, filename)
            with np.load(path) as z:
                breathing = np.asarray(z["data"]).squeeze()
                fs = float(np.asarray(z["fs"]).reshape(-1)[0])
            processed = self.process_signal(breathing, fs)
            np.savez(os.path.join(out_dir, filename),
                     data=processed.astype(np.float32), fs=10)
            written += 1
        return written

    supports_item_rng = True

    def __getitem__(self, idx: int, rng=None) -> dict:
        # `rng` makes the crop draw order-independent for threaded loading
        # (see dataset.DataLoader._fetch_fn)
        rng = rng if rng is not None else self.rng
        filename = self.file_list[idx]
        if self.mode == "train":
            path = os.path.join(self.cache_dir, filename)
            with np.load(path) as z:
                breathing = np.asarray(z["data"]).squeeze()
            slack = breathing.shape[0] - self.max_length
            if slack < 0:
                raise ValueError(f"{filename} shorter than max_length")
            start = rng.randint(0, slack + 1)
            breathing = breathing[start:start + self.max_length]
        else:
            path = os.path.join(self.root, self.raw_channel, filename)
            with np.load(path) as z:
                breathing = np.asarray(z["data"]).squeeze()
                fs = float(np.asarray(z["fs"]).reshape(-1)[0])
            if self.mode == "val":
                breathing = breathing[:self.max_length_200]
            breathing = self.process_signal(breathing, fs)

        breathing = np.asarray(breathing, np.float32)
        if (breathing > 0).sum() > (breathing < 0).sum():
            breathing = -breathing
        if not np.isfinite(breathing).all():
            raise ValueError(f"bad file {filename}: NaN/Inf in signal")
        return {"x": breathing[None, :], "y": 0, "filename": filename,
                "selected_channel": "thorax"}
