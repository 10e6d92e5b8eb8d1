// Native arithmetic (range) coder for the .ecdc entropy-coding hot loop.
//
// Bit-exact with the Python coder in encodec_tpu_torch/stream/ac.py (and with the
// reference encodec/quantization/ac.py): identical range split (double
// ratio with ceil/floor), bit-injection threshold, common-prefix flush and
// final flush, LSB-first single-bit packing. The Python layer feeds it
// quantized CDFs (int64 cumsums) built on the host.
//
// API (C, for ctypes):
//   batch encode:  ac_encode_batch(symbols, cdfs, n, card, out, cap) -> len
//   batch decode:  ac_decode_batch(cdfs, n, card, data, len, out) -> n_ok
//                  (-2 overflow, -4 corrupt stream; i < n = clean EOF)
//   streaming decode (for LM interleaving):
//     ac_dec_new(data, len) -> handle
//     ac_dec_pull(handle, cdf, card) -> symbol (or -1 on EOF)
//     ac_dec_free(handle)
//   streaming encode:
//     ac_enc_new() -> handle
//     ac_enc_push(handle, symbol, cdf, card)
//     ac_enc_finish(handle, out, cap) -> len
//     ac_enc_free(handle)

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr int kTotalRangeBits = 24;
constexpr int64_t kTotalRange = int64_t(1) << kTotalRangeBits;

struct BitWriter {
  std::vector<uint8_t> bytes;
  uint32_t current = 0;
  int nbits = 0;

  void push(int bit) {
    current += uint32_t(bit) << nbits;
    if (++nbits == 8) {
      bytes.push_back(uint8_t(current & 0xFF));
      current = 0;
      nbits = 0;
    }
  }
  void flush() {
    if (nbits) {
      bytes.push_back(uint8_t(current & 0xFF));
      current = 0;
      nbits = 0;
    }
  }
};

struct BitReader {
  const uint8_t* data;
  int64_t size;
  int64_t pos = 0;
  uint32_t current = 0;
  int nbits = 0;

  // returns 0/1, or -1 at end of stream
  int pull() {
    if (nbits == 0) {
      if (pos >= size) return -1;
      current = data[pos++];
      nbits = 8;
    }
    int bit = current & 1;
    current >>= 1;
    --nbits;
    return bit;
  }
};

struct Encoder {
  BitWriter writer;
  int64_t low = 0, high = 0;
  int max_bit = -1;
  bool error = false;  // int64 overflow guard tripped (max_bit > 61)
  bool finished = false;

  void flush_common_prefix() {
    while (max_bit >= 0) {
      int64_t b1 = low >> max_bit;
      if (b1 != (high >> max_bit)) break;
      low -= b1 << max_bit;
      high -= b1 << max_bit;
      --max_bit;
      writer.push(int(b1));
    }
  }

  void push_bounds(int64_t range_low, int64_t range_high) {
    if (error) return;  // stop before int64 low/high can overflow (UB)
    while (high - low + 1 < kTotalRange) {
      if (max_bit > 61) {  // next doubling would overflow int64
        error = true;
        return;
      }
      low *= 2;
      high = high * 2 + 1;
      ++max_bit;
    }
    const double ratio = double(high - low + 1) / double(kTotalRange);
    const int64_t eff_low = int64_t(std::ceil(double(range_low) * ratio));
    const int64_t eff_high = int64_t(std::floor(double(range_high) * ratio));
    high = low + eff_high;
    low = low + eff_low;
    flush_common_prefix();
    // mirror the Python/reference invariant (ac.py asserts
    // -1 <= max_bit <= 61): beyond 61 the int64 low/high would overflow on
    // the next bit injection and silently corrupt the stream.
    if (max_bit > 61) error = true;
  }

  void push(int symbol, const int64_t* cdf) {
    push_bounds(symbol == 0 ? 0 : cdf[symbol - 1], cdf[symbol] - 1);
  }

  void finish() {
    if (finished) return;  // idempotent: callers may retry with a bigger buffer
    finished = true;
    while (max_bit >= 0) {
      writer.push(int((low >> max_bit) & 1));
      --max_bit;
    }
    writer.flush();
  }
};

struct Decoder {
  BitReader reader;
  int64_t low = 0, high = 0, current = 0;
  int max_bit = -1;
  bool error = false;  // int64 overflow guard tripped (max_bit > 61)

  void flush_common_prefix() {
    while (max_bit >= 0) {
      int64_t b1 = low >> max_bit;
      if (b1 != (high >> max_bit)) break;
      low -= b1 << max_bit;
      high -= b1 << max_bit;
      current -= b1 << max_bit;
      --max_bit;
    }
  }

  // returns symbol, or -1 at end of stream
  int pull(const int64_t* cdf, int card) {
    if (error) return -3;
    while (high - low + 1 < kTotalRange) {
      if (max_bit > 61) {  // next doubling would overflow int64
        error = true;
        return -3;
      }
      int bit = reader.pull();
      if (bit < 0) return -1;
      low *= 2;
      high = high * 2 + 1;
      current = current * 2 + bit;
      ++max_bit;
    }
    const double ratio = double(high - low + 1) / double(kTotalRange);
    int lo_idx = 0, hi_idx = card - 1;
    for (;;) {
      if (hi_idx < lo_idx) return -2;  // corrupt stream
      const int mid = (lo_idx + hi_idx) / 2;
      const int64_t range_low = mid > 0 ? cdf[mid - 1] : 0;
      const int64_t range_high = cdf[mid] - 1;
      const int64_t lo = int64_t(std::ceil(double(range_low) * ratio)) + low;
      const int64_t hi = int64_t(std::floor(double(range_high) * ratio)) + low;
      if (current < lo) {
        hi_idx = mid - 1;
      } else if (current > hi) {
        lo_idx = mid + 1;
      } else {
        low = lo;
        high = hi;
        flush_common_prefix();
        if (max_bit > 61) {  // see Encoder::push_bounds
          error = true;
          return -3;
        }
        return mid;
      }
    }
  }
};

}  // namespace

extern "C" {

// ---- batch API ----
int64_t ac_encode_batch(const int32_t* symbols, const int64_t* cdfs,
                        int64_t n, int32_t card, uint8_t* out,
                        int64_t out_cap) {
  Encoder enc;
  for (int64_t i = 0; i < n; ++i) {
    enc.push(symbols[i], cdfs + i * card);
  }
  enc.finish();
  if (enc.error) return -2;
  const int64_t sz = int64_t(enc.writer.bytes.size());
  if (sz > out_cap) return -1;
  std::memcpy(out, enc.writer.bytes.data(), size_t(sz));
  return sz;
}

// Encode from precomputed per-symbol CDF bounds (device-built CDFs): lows[i]
// = cdf[sym-1] (0 for symbol 0), highs[i] = cdf[sym] - 1.
int64_t ac_encode_bounds(const int64_t* lows, const int64_t* highs,
                         int64_t n, uint8_t* out, int64_t out_cap) {
  Encoder enc;
  for (int64_t i = 0; i < n; ++i) {
    enc.push_bounds(lows[i], highs[i]);
  }
  enc.finish();
  if (enc.error) return -2;
  const int64_t sz = int64_t(enc.writer.bytes.size());
  if (sz > out_cap) return -1;
  std::memcpy(out, enc.writer.bytes.data(), size_t(sz));
  return sz;
}

int64_t ac_decode_batch(const int64_t* cdfs, int64_t n, int32_t card,
                        const uint8_t* data, int64_t size,
                        int32_t* symbols_out) {
  Decoder dec;
  dec.reader = BitReader{data, size};
  for (int64_t i = 0; i < n; ++i) {
    const int sym = dec.pull(cdfs + i * card, card);
    if (sym == -3) return -2;  // overflow guard
    if (sym == -2) return -4;  // corrupt stream (binary search failed)
    if (sym < 0) return i;     // clean EOF
    symbols_out[i] = sym;
  }
  return n;
}

// ---- streaming API ----
void* ac_enc_new() { return new Encoder(); }

int32_t ac_enc_push(void* h, int32_t symbol, const int64_t* cdf,
                    int32_t card) {
  (void)card;
  Encoder* enc = static_cast<Encoder*>(h);
  enc->push(symbol, cdf);
  return enc->error ? -2 : 0;
}

int64_t ac_enc_finish(void* h, uint8_t* out, int64_t cap) {
  Encoder* enc = static_cast<Encoder*>(h);
  enc->finish();
  if (enc->error) return -2;
  const int64_t sz = int64_t(enc->writer.bytes.size());
  if (sz > cap) return -1;
  std::memcpy(out, enc->writer.bytes.data(), size_t(sz));
  return sz;
}

void ac_enc_free(void* h) { delete static_cast<Encoder*>(h); }

void* ac_dec_new(const uint8_t* data, int64_t size) {
  Decoder* dec = new Decoder();
  // copy so the python buffer may be freed
  uint8_t* copy = new uint8_t[size_t(size)];
  std::memcpy(copy, data, size_t(size));
  dec->reader = BitReader{copy, size};
  return dec;
}

int32_t ac_dec_pull(void* h, const int64_t* cdf, int32_t card) {
  return static_cast<Decoder*>(h)->pull(cdf, card);
}

void ac_dec_free(void* h) {
  Decoder* dec = static_cast<Decoder*>(h);
  delete[] dec->reader.data;
  delete dec;
}

}  // extern "C"
