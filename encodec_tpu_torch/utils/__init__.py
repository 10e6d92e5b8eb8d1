"""Utility subpackage: audio IO (a copy of `encodec_tpu/utils/audio.py`),
the segments' overlap-add, and the port's spans, counters and traces
(`profiling`)."""

from .audio import load_wav, save_wav, convert_audio  # noqa: F401
from .overlap import linear_overlap_add  # noqa: F401
