"""Native (C++) arithmetic coder, loaded with ctypes.

The port's copy of `encodec_tpu/native/`: `ac.cpp` is the JAX package's
source, the range coder's hot loop, writing and reading the bitstream of
the Python coder (`encodec_tpu_torch.stream.ac`) bit for bit; that coder
serves when this library cannot be built (`available()` says which).

`ac.cpp` is compiled with `g++` at first use into
`encodec_tpu_torch/kernels/_build/native-<hash>/` (git-ignored), keyed by a
hash of the source and flags, never next to the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import typing as tp
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "ac.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "kernels" / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib: tp.Optional[ctypes.CDLL] = None
_tried = False
_LOCK = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libencodec_ac.so"


def _build(so: Path) -> bool:
    """Compile into a temporary file beside `so` and rename it into place,
    so concurrent processes never load a half-written library."""
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> tp.Optional[ctypes.CDLL]:
    global _lib, _tried
    with _LOCK:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
            i64, i32 = ctypes.c_int64, ctypes.c_int32
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.ac_encode_bounds.restype = i64
            lib.ac_encode_bounds.argtypes = [i64p, i64p, i64, u8p, i64]
            lib.ac_dec_new.restype = ctypes.c_void_p
            lib.ac_dec_new.argtypes = [u8p, i64]
            lib.ac_dec_pull.restype = i32
            lib.ac_dec_pull.argtypes = [ctypes.c_void_p, i64p, i32]
            lib.ac_dec_free.restype = None
            lib.ac_dec_free.argtypes = [ctypes.c_void_p]
        except (OSError, AttributeError):
            return None
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def _as_i64p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def encode_bounds(lows: np.ndarray, highs: np.ndarray) -> bytes:
    """Arithmetic-encode from per-symbol CDF bounds (device-built CDFs)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native arithmetic coder is not available")
    lows = np.ascontiguousarray(lows, np.int64)
    highs = np.ascontiguousarray(highs, np.int64)
    if lows.shape != highs.shape or lows.ndim != 1:
        raise ValueError(f"bounds of shapes {lows.shape} and {highs.shape}")
    n = len(lows)
    cap = max(1024, 8 * n)  # generous: worst case ~ total_range_bits/step
    out = np.empty(cap, np.uint8)
    size = lib.ac_encode_bounds(
        _as_i64p(lows), _as_i64p(highs), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if size == -2:
        raise RuntimeError("arithmetic coder overflow (max_bit > 61)")
    if size < 0:
        raise RuntimeError("native arithmetic coder output buffer overflow")
    return out[:size].tobytes()


class StreamingDecoder:
    """Stateful native decoder for LM-interleaved decompression: the fast
    sibling of `stream.ac.ArithmeticDecoder` (same `pull`)."""

    def __init__(self, data: bytes):
        lib = _load()
        if lib is None:
            raise RuntimeError("the native arithmetic coder is not available")
        self._lib = lib
        buf = np.frombuffer(data, np.uint8)
        # ac_dec_new copies the bytes
        self._h = lib.ac_dec_new(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf))

    def pull(self, cdf: np.ndarray) -> tp.Optional[int]:
        cdf = np.ascontiguousarray(cdf, np.int64)
        sym = self._lib.ac_dec_pull(self._h, _as_i64p(cdf), len(cdf))
        if sym == -1:
            return None
        if sym == -3:
            raise RuntimeError("arithmetic coder overflow (max_bit > 61)")
        if sym < 0:
            raise RuntimeError("Binary search failed")
        return int(sym)

    def close(self):
        if self._h:
            self._lib.ac_dec_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
