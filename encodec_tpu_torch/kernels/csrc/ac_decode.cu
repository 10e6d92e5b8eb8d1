// Range decoding of lmv=3 streams for Hopper (sm_90a): one lockstep decode
// step of S lanes, the port's `ac_pull_rows`.
//
// Replaces the XLA scan of encodec_tpu/stream/device_ac.py::ac_pull_row
// (vmapped over the lanes inside encodec_tpu/models/ilm.py::
// fused_decode_chunk_exec); it is not a Pallas kernel. Its plain twin is
// encodec_tpu_torch/stream/device_ac.py::ac_pull_lanes: the same state
// machine (ref encodec/quantization/ac.py:170-260) with the same integer
// arithmetic, so symbols, state and flags are equal bit for bit.
//
// Per lane s (active while t < ts[s]): K pulls in codebook order, each
//   1. bit injection until high - low + 1 >= 2^24 (LSB-first bits of the
//      lane's bytes; 0 at or past nbits[s]);
//   2. the symbol search of JAX's device decoder: eff_low[j] =
//      ceil(cdf[j-1] * delta / 2^24) for every symbol j, sym = count(eff_low
//      <= current - low) - 1 clamped to [0, card), ok = eff_low[sym] <=
//      current - low <= floor((cdf[sym] - 1) * delta / 2^24);
//   3. the bound update and the common-prefix flush.
// The symbols go to codes[t, s, :], 1 + symbols (or 0 where t + 1 >=
// ts[s]) to feed[s, :], and the step folds into the sticky flags ok[s] and
// eof[s] (pos > nbits[s] after the step). An inactive lane writes zero
// codes and feed and keeps its state and flags.
//
// What bounds it: a sequential chain of K dependent pulls per lane (each
// pull needs the state the last one left); the bytes it must move are the
// rows, S*K*card*8 (512 KiB at S=2, K=32, card=1024: 0.16 us at 3.35 TB/s),
// plus the state and a few bytes of stream. So the chain's latency, not
// bandwidth or arithmetic, sets its time: per pull, two block barriers, a
// read of the row and thread 0's serial bit loops.
//
// Design (simple and right first):
// - one CTA per lane; blockDim = card rounded up to a warp, at most 1024,
//   so thread j holds symbol j's lower bound cdf[j-1] (above 1024 symbols
//   a thread takes every blockDim-th symbol);
// - the bytes the step can reach are copied to shared memory first: a pull
//   injects at most 24 bits (delta >= 1 before it), so a step reads bits
//   [pos, pos + 24K), inside the 3K + 2 bytes from byte pos / 8;
// - thread 0 keeps the state in registers as unsigned 64-bit words (low
//   and high stay below 2^62, the reference asserting max_bit <= 61, and
//   so does current on a valid stream), so the flush's shifts are logical; the twin's int64 shifts are
//   arithmetic on the same non-negative values. It injects the bits and
//   publishes delta and current - low. `current` follows JAX's two uint32
//   limbs: doubling wraps modulo 2^64, the flush's subtraction of a bit
//   below 32 borrows only within the low limb, and current - low is
//   wrapped to a signed 32-bit value. None of this acts on a valid stream
//   (current stays in [low, high]); after a corrupt step it keeps the
//   symbols, state and flags equal to JAX's;
// - every thread loads its row entry before waiting for thread 0, tests
//   eff_low <= current - low (the product is below 2^50, exact in 64-bit),
//   and __syncthreads_count sums the test over the block: that sum - 1 is
//   the symbol;
// - thread 0 reads the symbol's two CDF entries (in L1: the block just
//   loaded the row), updates the bounds and flushes the shared prefix.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRangeBits = 24;
constexpr int kMaxThreads = 1024;
// the columns of the state [S, 5]
constexpr int kLow = 0, kHigh = 1, kCur = 2, kMaxBit = 3, kPos = 4;
constexpr int kFields = 5;

__host__ __device__ constexpr int window_bytes(int K) { return 3 * K + 2; }

__device__ __forceinline__ long long floor_shift24(long long r,
                                                   long long delta) {
  return (r * delta) >> kRangeBits;
}

__device__ __forceinline__ long long ceil_shift24(long long r,
                                                  long long delta) {
  const long long p = r * delta;
  return (p >> kRangeBits) + ((p & ((1LL << kRangeBits) - 1)) != 0);
}

__global__ void __launch_bounds__(kMaxThreads)
ac_decode_kernel(long long* __restrict__ state,
                 const long long* __restrict__ rows,
                 const uint8_t* __restrict__ data,
                 const long long* __restrict__ nbits,
                 const long long* __restrict__ ts, long long t, int K,
                 int card, long long L, long long* __restrict__ codes_t,
                 long long* __restrict__ feed, bool* __restrict__ ok,
                 bool* __restrict__ eof) {
  extern __shared__ uint8_t window[];
  __shared__ long long s_delta;
  __shared__ long long s_cur_rel;

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  long long* out = codes_t + static_cast<long long>(s) * K;
  long long* next = feed + static_cast<long long>(s) * K;
  const long long t_end = ts[s];
  if (t >= t_end) {                 // inactive: zeros, state and flags kept
    for (int k = tid; k < K; k += blockDim.x) {
      out[k] = 0;
      next[k] = 0;
    }
    return;
  }
  const bool feed_next = t + 1 < t_end;
  long long* st = state + static_cast<long long>(s) * kFields;
  const long long pos0 = st[kPos];
  const long long nb = nbits[s];
  const long long first_byte = pos0 >> 3;
  const uint8_t* bytes = data + static_cast<long long>(s) * L;
  for (int i = tid; i < window_bytes(K); i += blockDim.x) {
    const long long b = first_byte + i;
    window[i] = bytes[b < L ? b : L - 1];      // JAX clips the byte index
  }

  unsigned long long low = 0, high = 0, cur = 0;
  long long max_bit = -1, pos = pos0;
  bool all_ok = true;
  if (tid == 0) {
    low = static_cast<unsigned long long>(st[kLow]);
    high = static_cast<unsigned long long>(st[kHigh]);
    cur = static_cast<unsigned long long>(st[kCur]);
    max_bit = st[kMaxBit];
  }
  __syncthreads();                  // the window is in shared memory

  for (int k = 0; k < K; ++k) {
    const long long* row = rows + (static_cast<long long>(s) * K + k) * card;
    // this thread's first lower bound, loaded before thread 0's bit loop
    long long lower = (tid > 0 && tid < card) ? row[tid - 1] : 0;
    if (tid == 0) {
      while (high - low + 1 < (1ULL << kRangeBits)) {
        unsigned long long bit = 0;
        if (pos < nb) {
          bit = (window[(pos >> 3) - first_byte] >> (pos & 7)) & 1u;
        }
        low <<= 1;
        high = (high << 1) | 1u;
        cur = (cur << 1) | bit;
        ++max_bit;
        ++pos;
      }
      s_delta = static_cast<long long>(high - low + 1);
      s_cur_rel = static_cast<int32_t>(static_cast<uint32_t>(cur - low));
    }
    __syncthreads();
    const long long delta = s_delta;
    const long long cur_rel = s_cur_rel;
    int count = 0;
    for (int j0 = 0; j0 < card; j0 += blockDim.x) {
      const int j = j0 + tid;
      if (j0 > 0) lower = j < card ? row[j - 1] : 0;
      count += __syncthreads_count(j < card &&
                                   ceil_shift24(lower, delta) <= cur_rel);
    }
    if (tid == 0) {
      int sym = count - 1;
      sym = sym < 0 ? 0 : (sym > card - 1 ? card - 1 : sym);
      const long long sel_low = sym > 0 ? ceil_shift24(row[sym - 1], delta)
                                        : 0;
      const long long sel_high = floor_shift24(row[sym] - 1, delta);
      all_ok = all_ok && sel_low <= cur_rel && cur_rel <= sel_high;
      high = low + static_cast<unsigned long long>(sel_high);
      low = low + static_cast<unsigned long long>(sel_low);
      while (max_bit >= 0) {
        const unsigned long long b1 = (low >> max_bit) & 1u;
        if (b1 != ((high >> max_bit) & 1u)) break;
        const unsigned long long sub = b1 << max_bit;
        low -= sub;
        high -= sub;
        // JAX's limb subtraction: below bit 32 no borrow leaves the low
        // limb (only a corrupt stream has a borrow to make)
        cur = max_bit < 32 ? (cur & ~0xFFFFFFFFULL) | ((cur - sub) &
                                                       0xFFFFFFFFULL)
                           : cur - sub;
        --max_bit;
      }
      out[k] = sym;
      next[k] = feed_next ? sym + 1 : 0;
    }
  }
  if (tid == 0) {
    st[kLow] = static_cast<long long>(low);
    st[kHigh] = static_cast<long long>(high);
    st[kCur] = static_cast<long long>(cur);
    st[kMaxBit] = max_bit;
    st[kPos] = pos;
    ok[s] = ok[s] && all_ok;
    eof[s] = eof[s] || pos > nb;
  }
}

}  // namespace

extern "C" {

const char* ac_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ac_decode_max_threads() { return kMaxThreads; }

int ac_decode_window_bytes(int K) { return window_bytes(K); }

// state [S, 5], rows [S, K, card], data [S, L] (uint8), nbits [S], ts [S]
// (int64, contiguous); codes_t points at codes[t] ([S, K] int64), feed
// [S, K] int64, ok and eof [S] bool. `threads` is the wrapper's plan
// (card rounded up to a warp, at most 1024).
int ac_decode_launch(void* state, const void* rows, const void* data,
                     const void* nbits, const void* ts, long long t, int S,
                     int K, int card, long long L, void* codes_t, void* feed,
                     void* ok, void* eof, int threads, void* stream) {
  if (S < 1 || K < 1 || card < 1 || L < 1 || threads < 1 ||
      threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ac_decode_kernel<<<S, threads, window_bytes(K),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(state), static_cast<const long long*>(rows),
      static_cast<const uint8_t*>(data), static_cast<const long long*>(nbits),
      static_cast<const long long*>(ts), t, K, card, L,
      static_cast<long long*>(codes_t), static_cast<long long*>(feed),
      static_cast<bool*>(ok), static_cast<bool*>(eof));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
