"""Data pipeline: breathing datasets, preprocessing, sampling (copies of
`encodec_tpu/data/preprocess.py` and `dataset.py`)."""

from .preprocess import (  # noqa: F401
    label_to_interval,
    signal_std,
    signal_normalize,
    signal_crop,
    norm_sig,
    signal_crop_motion,
    detect_motion_iterative,
    detect_static_signal,
)
from .dataset import BreathingDataset, MergedDataset, DataLoader  # noqa: F401
