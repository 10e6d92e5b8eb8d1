"""Data pipeline: breathing datasets, preprocessing, sampling, the BWH
loader and the offline curation (copies of `encodec_tpu/data/`'s
`preprocess.py`, `dataset.py`, `bwh.py` and `curation.py`)."""

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
from .bwh import BwhDataset  # noqa: F401
from .curation import (  # noqa: F401
    clip_and_patch,
    curate_directory,
    find_constant_spans,
    find_fns_to_ignore,
    sliding_std,
)
