"""`.ecdc` container format and LSB-first bit packing.

The port's own copy of `encodec_tpu/stream/binary.py` (framework-free; the
port imports nothing of the JAX package).

Format parity with the reference (encodec/binary.py): magic `ECDC`, uint8
version 0, uint32 JSON length (network order), JSON metadata, then raw
payload. Values are packed LSB-first both within a value and within each
byte, so files interchange byte-for-byte with the reference.

Beyond the streaming `BitPacker`/`BitUnpacker` classes, `pack_bits` /
`unpack_bits` provide vectorized numpy fast paths for the no-LM case —
packing a whole `[K*T]` code array in one shot instead of a Python loop.
"""

from __future__ import annotations

import json
import struct
import typing as tp

import numpy as np

_HEADER_STRUCT = struct.Struct("!4sBI")
_MAGIC = b"ECDC"


def write_ecdc_header(fo: tp.IO[bytes], metadata: tp.Any) -> None:
    meta = json.dumps(metadata).encode("utf-8")
    fo.write(_HEADER_STRUCT.pack(_MAGIC, 0, len(meta)))
    fo.write(meta)
    fo.flush()


def _read_exactly(fo: tp.IO[bytes], size: int) -> bytes:
    buf = b""
    while len(buf) < size:
        chunk = fo.read(size - len(buf))
        if not chunk:
            raise EOFError(f"Impossible to read enough data from the stream, "
                           f"{size - len(buf)} bytes remaining.")
        buf += chunk
    return buf


def read_ecdc_header(fo: tp.IO[bytes]):
    magic, version, meta_size = _HEADER_STRUCT.unpack(
        _read_exactly(fo, _HEADER_STRUCT.size))
    if magic != _MAGIC:
        raise ValueError("File is not in ECDC format.")
    if version != 0:
        raise ValueError("Version not supported.")
    return json.loads(_read_exactly(fo, meta_size).decode("utf-8"))


# ---------------------------------------------------------------------------
# Vectorized packing (fast path)
# ---------------------------------------------------------------------------

def pack_bits(values: np.ndarray, bits: int) -> bytes:
    """Pack ints into LSB-first `bits`-wide fields, identical to pushing each
    through BitPacker then flushing."""
    values = np.ascontiguousarray(values, dtype=np.uint32).reshape(-1)
    if values.size == 0:
        return b""
    shifts = np.arange(bits, dtype=np.uint32)
    bit_arr = ((values[:, None] >> shifts) & 1).astype(np.uint8).reshape(-1)
    pad = (-bit_arr.size) % 8
    if pad:
        bit_arr = np.concatenate([bit_arr, np.zeros(pad, np.uint8)])
    # LSB-first within each byte → reverse each 8-bit group for packbits.
    return np.packbits(bit_arr.reshape(-1, 8)[:, ::-1]).tobytes()


def unpack_bits(data: bytes, bits: int, count: tp.Optional[int] = None) -> np.ndarray:
    """Inverse of `pack_bits`. Without `count`, returns every complete field
    (which may include trailing ghost values from byte padding, matching
    BitUnpacker semantics)."""
    if not data:
        return np.zeros(0, np.uint32)
    byte_arr = np.frombuffer(data, np.uint8)
    bit_arr = np.unpackbits(byte_arr.reshape(-1, 1), axis=1)[:, ::-1].reshape(-1)
    n = bit_arr.size // bits if count is None else count
    bit_arr = bit_arr[:n * bits].reshape(n, bits).astype(np.uint32)
    shifts = np.arange(bits, dtype=np.uint32)
    return (bit_arr << shifts).sum(axis=1).astype(np.uint32)


# ---------------------------------------------------------------------------
# Streaming packing (bit-at-a-time, used by the range coder)
# ---------------------------------------------------------------------------

class BitPacker:
    """Streaming LSB-first packer for `bits`-wide values (ref binary.py:55)."""

    def __init__(self, bits: int, fo: tp.IO[bytes]):
        self._current_value = 0
        self._current_bits = 0
        self.bits = bits
        self.fo = fo

    def push(self, value: int) -> None:
        self._current_value += (value << self._current_bits)
        self._current_bits += self.bits
        while self._current_bits >= 8:
            self.fo.write(bytes([self._current_value & 0xFF]))
            self._current_value >>= 8
            self._current_bits -= 8

    def flush(self) -> None:
        if self._current_bits:
            self.fo.write(bytes([self._current_value]))
            self._current_value = 0
            self._current_bits = 0
        self.fo.flush()


class BitUnpacker:
    """Streaming inverse of `BitPacker` (ref binary.py:91)."""

    def __init__(self, bits: int, fo: tp.IO[bytes]):
        self.bits = bits
        self.fo = fo
        self._mask = (1 << bits) - 1
        self._current_value = 0
        self._current_bits = 0

    def pull(self) -> tp.Optional[int]:
        while self._current_bits < self.bits:
            buf = self.fo.read(1)
            if not buf:
                return None
            self._current_value += buf[0] << self._current_bits
            self._current_bits += 8
        out = self._current_value & self._mask
        self._current_value >>= self.bits
        self._current_bits -= self.bits
        return out
