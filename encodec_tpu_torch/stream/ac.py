"""Streaming arithmetic (range) coder over quantized CDFs.

The port's copy of the coder classes and the float CDF builder
(`build_stable_quantized_cdf`, for float LM probabilities) of
`encodec_tpu/stream/ac.py` (framework-free; the port imports nothing of
the JAX package). Bit-exact
with the reference coder (encodec/quantization/ac.py): same range split
(float64 ratio with ceil/floor), same bit-injection threshold, same
common-prefix flush and final flush, so a stream written by either package
decodes in the other.

Host code by design: the coder is a sequential bit-level loop; the device
computes the CDF rows (`models.ilm`). The native C++ coder
(`encodec_tpu_torch.native`) writes and reads the same bitstream, and
`encode_bounds`/`make_decoder` use it when it builds, this Python coder
otherwise.
"""

from __future__ import annotations

import io
import math
import typing as tp

import numpy as np

from .binary import BitPacker, BitUnpacker


def build_stable_quantized_cdf(pdf: np.ndarray, total_range_bits: int,
                               roundoff: float = 1e-8, min_range: int = 2,
                               check: bool = True) -> np.ndarray:
    """Quantize a pdf into integer CDF ranges over `[0, 2**total_range_bits]`.

    Every symbol gets at least `min_range` slots (numerical-stability floor),
    and the pdf is first floored to a multiple of `roundoff` so that tiny
    cross-platform float differences in the probability model cannot change
    the bitstream. Accepts float32 input and keeps the reference's float32
    arithmetic so CDFs match bit-for-bit.
    """
    pdf = np.asarray(pdf)
    if roundoff:
        pdf = np.floor(pdf / np.float32(roundoff)) * np.float32(roundoff)
    total_range = 2 ** total_range_bits
    cardinality = len(pdf)
    alpha = min_range * cardinality / total_range
    assert alpha <= 1, "you must reduce min_range"
    ranges = np.floor(((1 - alpha) * total_range) * pdf).astype(np.int64)
    ranges += min_range
    quantized_cdf = np.cumsum(ranges)
    if min_range < 2:
        raise ValueError("min_range must be at least 2.")
    if check:
        assert quantized_cdf[-1] <= 2 ** total_range_bits, quantized_cdf[-1]
        if ((quantized_cdf[1:] - quantized_cdf[:-1]) < min_range).any() \
                or quantized_cdf[0] < min_range:
            raise ValueError("You must increase your total_range_bits.")
    return quantized_cdf


def encode_bounds(lows: np.ndarray, highs: np.ndarray) -> bytes:
    """One arithmetic-coded stream from per-symbol CDF bounds (`push_bounds`
    convention), by the native coder when it is available."""
    from .. import native
    if native.available():
        return native.encode_bounds(lows, highs)
    buf = io.BytesIO()
    coder = ArithmeticCoder(buf)
    for lo, hi in zip(lows.tolist(), highs.tolist()):
        coder.push_bounds(lo, hi)
    coder.flush()
    return buf.getvalue()


def make_decoder(data: bytes):
    """A streaming decoder of `data` with `pull(cdf) -> symbol or None`: the
    native one when it is available."""
    from .. import native
    if native.available():
        return native.StreamingDecoder(data)
    return ArithmeticDecoder(io.BytesIO(data))


class ArithmeticCoder:
    """Range encoder: push symbols by their CDF bounds, bits stream out
    as soon as the low/high bounds share a prefix. See ref ac.py:56-167 for
    the full derivation; the state machine here is identical."""

    def __init__(self, fo: tp.IO[bytes], total_range_bits: int = 24):
        assert total_range_bits <= 30
        self.total_range_bits = total_range_bits
        self.packer = BitPacker(bits=1, fo=fo)
        self.low: int = 0
        self.high: int = 0
        self.max_bit: int = -1

    @property
    def delta(self) -> int:
        return self.high - self.low + 1

    def _flush_common_prefix(self) -> None:
        assert self.high >= self.low, (self.low, self.high)
        assert self.high < 2 ** (self.max_bit + 1)
        while self.max_bit >= 0:
            b1 = self.low >> self.max_bit
            if b1 != (self.high >> self.max_bit):
                break
            self.low -= b1 << self.max_bit
            self.high -= b1 << self.max_bit
            assert 0 <= self.low <= self.high
            self.max_bit -= 1
            self.packer.push(b1)

    def push(self, symbol: int, quantized_cdf: np.ndarray) -> None:
        range_low = 0 if symbol == 0 else int(quantized_cdf[symbol - 1])
        range_high = int(quantized_cdf[symbol]) - 1
        self.push_bounds(range_low, range_high)

    def push_bounds(self, range_low: int, range_high: int) -> None:
        """Push a symbol given its CDF bounds directly (range_low =
        cdf[sym-1] or 0, range_high = cdf[sym]-1) — the entry point for
        device-built CDFs (`models.ilm.int_symbol_bounds`)."""
        # inject bits until the range is wide enough to split
        while self.delta < 2 ** self.total_range_bits:
            self.low *= 2
            self.high = self.high * 2 + 1
            self.max_bit += 1
        ratio = self.delta / (2 ** self.total_range_bits)
        effective_low = int(math.ceil(range_low * ratio))
        effective_high = int(math.floor(range_high * ratio))
        assert self.low <= self.high
        self.high = self.low + effective_high
        self.low = self.low + effective_low
        assert self.low <= self.high, (effective_low, effective_high,
                                       range_low, range_high)
        self._flush_common_prefix()
        assert self.low <= self.high
        assert -1 <= self.max_bit <= 61, self.max_bit

    def flush(self) -> None:
        while self.max_bit >= 0:
            self.packer.push((self.low >> self.max_bit) & 1)
            self.max_bit -= 1
        self.packer.flush()


class ArithmeticDecoder:
    """Range decoder: binary-search the symbol whose sub-range contains the
    bits read so far. Must see exactly the CDF sequence used at encode time.
    Ref ac.py:170-260."""

    def __init__(self, fo: tp.IO[bytes], total_range_bits: int = 24):
        self.total_range_bits = total_range_bits
        self.low: int = 0
        self.high: int = 0
        self.current: int = 0
        self.max_bit: int = -1
        self.unpacker = BitUnpacker(bits=1, fo=fo)

    @property
    def delta(self) -> int:
        return self.high - self.low + 1

    def _flush_common_prefix(self) -> None:
        while self.max_bit >= 0:
            b1 = self.low >> self.max_bit
            if b1 != (self.high >> self.max_bit):
                break
            self.low -= b1 << self.max_bit
            self.high -= b1 << self.max_bit
            self.current -= b1 << self.max_bit
            assert 0 <= self.low <= self.high
            self.max_bit -= 1

    def pull(self, quantized_cdf: np.ndarray) -> tp.Optional[int]:
        while self.delta < 2 ** self.total_range_bits:
            bit = self.unpacker.pull()
            if bit is None:
                return None
            self.low *= 2
            self.high = self.high * 2 + 1
            self.current = self.current * 2 + bit
            self.max_bit += 1

        ratio = self.delta / (2 ** self.total_range_bits)
        lo_idx, hi_idx = 0, len(quantized_cdf) - 1
        while True:
            if hi_idx < lo_idx:
                raise RuntimeError("Binary search failed")
            mid = (lo_idx + hi_idx) // 2
            range_low = int(quantized_cdf[mid - 1]) if mid > 0 else 0
            range_high = int(quantized_cdf[mid]) - 1
            low = int(math.ceil(range_low * ratio)) + self.low
            high = int(math.floor(range_high * ratio)) + self.low
            if self.current < low:
                hi_idx = mid - 1
            elif self.current > high:
                lo_idx = mid + 1
            else:
                sym = mid
                self.low, self.high = low, high
                break
        self._flush_common_prefix()
        return sym
