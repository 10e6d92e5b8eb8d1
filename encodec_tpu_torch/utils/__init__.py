"""Utility subpackage: audio IO (a copy of `encodec_tpu/utils/audio.py`)."""

from .audio import load_wav, save_wav, convert_audio  # noqa: F401
