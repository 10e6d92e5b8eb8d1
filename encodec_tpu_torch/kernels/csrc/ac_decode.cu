// Range decoding of lmv=3 streams for Hopper (sm_90a), with the integer LM's
// CDF head fused in: one lockstep decode step of S lanes, the port's
// `ac_head_pull`.
//
// Replaces, inside JAX's fused decode scan (encodec_tpu/models/ilm.py::
// fused_decode_chunk_exec), the head's tail (encodec_tpu/models/ilm.py:661
// `_head_cdf` after its einsum) and the XLA scan of
// encodec_tpu/stream/device_ac.py:222 `ac_pull_row`, vmapped over the
// lanes; neither is a Pallas kernel. Its plain twin is
// encodec_tpu_torch/stream/device_ac.py::ac_head_pull_lanes: the same
// integer arithmetic (ref encodec/quantization/ac.py:170-260 for the coder),
// so rows, symbols, state and flags are equal bit for bit.
//
// Input: the head's exact product acc [K, S, card] float64 (integers below
// 2^31), head_b [K, card] int32 (below 2^30), the exponent e0, the exp2
// table [1024]. Per lane s (active while t < ts[s], t read from the device
// counter t_dev):
//   1. the K CDF rows: logits = rshift_round(acc, e0) + head_b, the row max,
//      t = clamp(logits - max, -(63 << 10), 0), the base-2 exponent, the
//      exp2 table, p16 = (score << 16) / sum, ranges = 2 + (p16 * (M >> 10)
//      >> 6) with M = 2^24 - 2 card, and their inclusive scan;
//   2. K pulls in codebook order, each: bit injection until high - low + 1
//      >= 2^24 (LSB-first bits of the lane's bytes; 0 at or past nbits[s]);
//      the symbol search of JAX's device decoder, sym = count(eff_low <=
//      current - low) - 1 clamped to [0, card) with eff_low[j] =
//      ceil(cdf[j-1] * delta / 2^24), ok = eff_low[sym] <= current - low <=
//      floor((cdf[sym] - 1) * delta / 2^24); the bound update and the
//      common-prefix flush.
// The symbols go to codes[t, s, :], 1 + symbols (or 0 where t + 1 >=
// ts[s]) to feed[s, :], and the step folds into the sticky flags ok[s] and
// eof[s] (pos > nbits[s] after the step). An inactive lane writes zero
// codes and feed and keeps its state and flags.
//
// What bounds it: a sequential chain of K dependent pulls per lane (each
// pull needs the state the last one left), after the rows are built. The
// bytes it must move are the product, S*K*card*8 (512 KiB at S=2, K=32,
// card=1024: 0.16 us at 3.35 TB/s), head_b (K*card*4), the state and a
// few bytes of stream. So latency, not bandwidth, sets its time.
//
// Design:
// - a cluster of 4 CTAs per lane (thread block clusters, sm_90): the rows
//   never leave the chip. Row k is built by CTA k mod 4, one warp per row
//   (8 warps, so K = 32 is one row per warp), into its own shared memory,
//   and then copied into the shared memory of the cluster's first CTA
//   (distributed shared memory), which runs the chain after a cluster
//   barrier. A row is several microseconds of latency-bound work for one
//   warp, so the rows are built in parallel on 4 SMs.
// - a row, by one warp: entry j = 32 m + lane is lane's m-th (coalesced
//   loads, all issued before the first is used; card <= 1024). The logits
//   in float64, exact (integers below 2^53; the shift-round is a
//   power-of-two scaling and a floor), a shuffle max, t and the exp2 table
//   (staged in shared memory) in 32 bits, a shuffle sum, p16 = (score <<
//   16) / sum by a multiply with the sum's precomputed reciprocal
//   (Granlund and Montgomery's division by an invariant integer, exact for
//   every 32-bit dividend), the ranges into shared memory, then each lane
//   scans its own 32 consecutive entries and the lanes' totals are scanned
//   by shuffles. A word of padding per 32 entries keeps both passes free
//   of bank conflicts. A row is 1024 entries wide whatever the card (fixed
//   trip counts, no branch per entry): 33/32 * K*4 KiB = 132 KiB at K=32,
//   dynamic shared memory above 48 KB, granted once per process by
//   cudaFuncSetAttribute.
// - the bytes the step can reach are copied to shared memory first: a pull
//   injects at most 24 bits (delta >= 1 before it), so a step reads bits
//   [pos, pos + 24K), inside the 3K + 1 bytes from byte pos / 8, and two
//   aligned 4-byte reads from any of them stay inside 3K + 16.
// - one warp runs the chain from shared memory with no block barrier, all
//   its lanes holding the same state. The search is 32-ary over the
//   monotone eff_low: a ballot over every 32nd entry (whose values were
//   loaded during the previous pull) picks the bucket, a ballot inside it
//   the symbol (__popc counts), and the symbol's bounds come by shuffle
//   from the lane that tested it; no branch around the warp's collectives.
//   delta (< 2^25) and current - low live in 32 bits, as in JAX's low
//   limbs; the bound products are 32 x 32 -> 64 bit. The bit injection and the prefix flush are bulk forms that equal
//   the reference's loops on every stream: injection of n = clz(delta) - 39
//   bits at once (delta doubles per loop turn), bit-reversed from the
//   window; the flush of the p leading bits where low and high agree below
//   max_bit (clz of their xor), subtracted from current as JAX's two
//   uint32 limbs do it: the bits at 32 and above in 64 bits, those below
//   32 within the low limb. (A max_bit above 63, out of reach of any stream
//   the coder wrote, is flushed as the twin's clamped int64 shifts do it.)
// - the state is unsigned 64-bit (low and high stay below 2^62, the
//   reference asserting max_bit <= 61, and so does current on a valid
//   stream), so shifts are logical; the twin's int64 shifts are arithmetic
//   on the same non-negative values. current - low is wrapped to a signed
//   32-bit value as JAX's difference of low limbs is. None of the limb
//   rules acts on a valid stream; after a corrupt step they keep the
//   symbols, state and flags equal to JAX's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRangeBits = 24;
constexpr int kAbits = 10;
constexpr int kLog2eQ14 = 23637;       // round(log2(e) * 2^14)
constexpr int kLutSize = 1024;         // the exp2 table
constexpr int kCluster = 4;            // CTAs per lane
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxPer = 32;            // row entries per lane
constexpr int kMaxCard = 32 * kMaxPer;
constexpr int kMaxSmem = 232448;       // 227 KB: a block's dynamic maximum
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kLoLimb = 0xffffffffULL;
// the columns of the state [S, 5]
constexpr int kLow = 0, kHigh = 1, kCur = 2, kMaxBit = 3, kPos = 4;
constexpr int kFields = 5;

__host__ __device__ constexpr int window_bytes(int K) { return 3 * K + 16; }

// Entry j of a row in shared memory lives at word pad(j): one word of
// padding per 32, so that 32 lanes writing 32 consecutive entries, and 32
// lanes each reading its own run of 32 consecutive entries, hit 32 banks.
// A row is 1024 entries wide whatever the card (ranges past the card are
// 0), so that every loop and both search levels have fixed trip counts.
__host__ __device__ constexpr int pad(int j) { return j + (j >> 5); }

constexpr int kRowWords = 33 * kMaxPer;   // 4224 bytes, a multiple of 16

__host__ __device__ constexpr long long smem_bytes(int K) {
  return 4LL * K * kRowWords + 4LL * kLutSize +
         ((window_bytes(K) + 3) & ~3);
}

// bits [0, n) set, n in [0, 64]
__device__ __forceinline__ unsigned long long low_mask(int n) {
  return n >= 64 ? ~0ULL : (1ULL << n) - 1;
}

// ceil(c * delta / 2^24) and floor(c * delta / 2^24) for c <= 2^24,
// delta <= 2^25: a 32 x 32 -> 64-bit product, exact
__device__ __forceinline__ int ceil_scaled(unsigned c, unsigned delta) {
  const unsigned long long p = static_cast<unsigned long long>(c) * delta;
  return static_cast<int>((p + ((1u << kRangeBits) - 1)) >> kRangeBits);
}

__device__ __forceinline__ int floor_scaled(unsigned c, unsigned delta) {
  return static_cast<int>(
      (static_cast<unsigned long long>(c) * delta) >> kRangeBits);
}

// A row's inputs into one warp's registers: entry j = 32 m + lane is
// lane's m-th (coalesced). Every load is issued before any is used (a
// clamped index instead of a branch per entry, which kept each load's
// latency apart).
__device__ __forceinline__ void load_row(const double* __restrict__ acc_row,
                                         const int* __restrict__ bias,
                                         int card, int lane,
                                         double (&logit)[kMaxPer],
                                         int (&b)[kMaxPer]) {
#pragma unroll
  for (int m = 0; m < kMaxPer; ++m) {
    const int j = min(32 * m + lane, card - 1);
    logit[m] = __ldg(acc_row + j);
    b[m] = __ldg(bias + j);
  }
}

// One CDF row by one warp from `load_row`'s registers -> row [pad(j)] int32
// in shared memory (ilm.py::_head_tail, bit for bit).
__device__ __forceinline__ void build_row(double (&logit)[kMaxPer],
                                          const int (&b)[kMaxPer],
                                          double half, double scale,
                                          const int* lut, int card, int* row,
                                          int lane) {
  double mx = -1e300;
#pragma unroll
  for (int m = 0; m < kMaxPer; ++m) {
    // rshift_round(a, e0) + bias: a power-of-two scaling and a floor of
    // integers below 2^53, exact
    logit[m] = floor((logit[m] + half) * scale) + static_cast<double>(b[m]);
    mx = 32 * m + lane < card ? fmax(mx, logit[m]) : mx;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmax(mx, __shfl_xor_sync(kFull, mx, o));
  }
  int score[kMaxPer];
  unsigned total = 0;
#pragma unroll
  for (int m = 0; m < kMaxPer; ++m) {
    // t = clamp(logit - max, -(63 << 10), 0), an integer
    const int t = __double2int_rz(
        fmax(logit[m] - mx, static_cast<double>(-(63 << kAbits))));
    // _to_base2: rshift_round(t * log2(e) >> 7, 7); |t * 23637| < 2^31
    const int bt = (((t * kLog2eQ14) >> 7) + 64) >> 7;
    // _exp2_fixed: u = -bt = q * 1024 + r
    const int u = min(-bt, 31 << kAbits);
    const int r = u & ((1 << kAbits) - 1);
    const int f = ((1 << kAbits) - r) & ((1 << kAbits) - 1);
    const int shift = min((u >> kAbits) + (r != 0), 31);
    score[m] = 32 * m + lane < card ? lut[f] >> shift : 0;
    total += score[m];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(kFull, total, o);
  // p16 = (score << 16) / d, d = max(total, 1) <= 2^24, by the invariant-
  // divisor reciprocal: q = (t1 + ((x - t1) >> s1)) >> s2, t1 = mulhi(mg, x)
  const unsigned d = total > 1 ? total : 1;
  const int l = 32 - __clz(d - 1);                    // ceil(log2(d))
  const unsigned mg = static_cast<unsigned>(
      ((((1ULL << l) - d) << 32) / d) + 1);
  const int s1 = min(l, 1);
  const int s2 = max(l - 1, 0);
  const int m10 = ((1 << kRangeBits) - 2 * card) >> 10;
#pragma unroll
  for (int m = 0; m < kMaxPer; ++m) {     // the ranges (0 past the card)
    const unsigned x = static_cast<unsigned>(score[m]) << 16;
    const unsigned t1 = __umulhi(mg, x);
    const int p16 = static_cast<int>((t1 + ((x - t1) >> s1)) >> s2);
    row[pad(32 * m + lane)] = 32 * m + lane < card
                                  ? 2 + ((p16 * m10) >> 6) : 0;
  }
  __syncwarp();
  int local[kMaxPer];                     // lane's run: entries 32 lane..
  int run = 0;
#pragma unroll
  for (int m = 0; m < kMaxPer; ++m) {
    run += row[pad(32 * lane + m)];
    local[m] = run;
  }
  int incl = run;                         // the runs' totals, scanned
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  const int offset = incl - run;
#pragma unroll
  for (int m = 0; m < kMaxPer; ++m) row[pad(32 * lane + m)] = offset + local[m];
  __syncwarp();
}

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 1)
    ac_head_pull_kernel(long long* __restrict__ state,
                        const double* __restrict__ acc,
                        const int* __restrict__ head_b, int e0,
                        const long long* __restrict__ lut_g,
                        const uint8_t* __restrict__ data,
                        const long long* __restrict__ nbits,
                        const long long* __restrict__ ts,
                        const long long* __restrict__ t_dev, int S, int K,
                        int card, long long L, long long T,
                        long long* __restrict__ codes,
                        long long* __restrict__ feed, bool* __restrict__ ok,
                        bool* __restrict__ eof) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int rw = kRowWords;
  int* rows = reinterpret_cast<int*>(smem);
  int* lut = rows + K * rw;
  uint8_t* window = reinterpret_cast<uint8_t*>(lut + kLutSize);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long t = *t_dev;
  if (t < 0 || t >= T) return;      // past the codes: nothing to decode
  long long* out = codes + (t * S + s) * K;
  long long* next = feed + static_cast<long long>(s) * K;
  const long long t_end = ts[s];
  if (t >= t_end) {                 // inactive: zeros, state and flags kept
    if (rank == 0) {
      for (int k = tid; k < K; k += blockDim.x) {
        out[k] = 0;
        next[k] = 0;
      }
    }
    return;                         // the whole cluster: no barrier waits
  }
  // this warp's first row: its loads go out before the staging below
  const int k0 = rank + kCluster * warp;
  double logit[kMaxPer];
  int b[kMaxPer];
  auto load = [&](int k) {
    load_row(acc + (static_cast<long long>(k) * S + s) * card,
             head_b + static_cast<long long>(k) * card, card, lane, logit, b);
  };
  if (k0 < K) load(k0);
  long long* st = state + static_cast<long long>(s) * kFields;
  const long long pos0 = st[kPos];
  const long long first_byte = pos0 >> 3;
  if (rank == 0) {
    const uint8_t* bytes = data + static_cast<long long>(s) * L;
    for (int i = tid; i < window_bytes(K); i += blockDim.x) {
      const long long b = first_byte + i;
      window[i] = bytes[b < L ? b : L - 1];    // JAX clips the byte index
    }
  }
  for (int i = tid; i < kLutSize; i += blockDim.x) {
    lut[i] = static_cast<int>(lut_g[i]);
  }
  __syncthreads();                  // the table is in shared memory
  int* lead_rows = cluster.map_shared_rank(rows, 0);
  // rshift_round(a, e0) = floor((a + 2^(e0-1)) / 2^e0), a * 2^-e0 for
  // e0 <= 0
  const double half = e0 > 0 ? ldexp(1.0, e0 - 1) : 0.0;
  const double scale = ldexp(1.0, -e0);
  for (int k = k0; k < K; k += kCluster * kWarps) {
    int* row = rows + k * rw;
    if (k != k0) load(k);
    build_row(logit, b, half, scale, lut, card, row, lane);
    if (rank != 0) {                // into the first CTA's shared memory
      const int4* src = reinterpret_cast<const int4*>(row);
      int4* dst = reinterpret_cast<int4*>(lead_rows + k * rw);
      for (int i = lane; i < rw / 4; i += 32) dst[i] = src[i];
    }
  }
  cluster.sync();                   // every row is in the first CTA
  if (rank != 0 || warp != 0) return;

  // the chain: every lane of warp 0 holds the same state
  unsigned long long low = static_cast<unsigned long long>(st[kLow]);
  unsigned long long high = static_cast<unsigned long long>(st[kHigh]);
  unsigned long long cur = static_cast<unsigned long long>(st[kCur]);
  long long max_bit = st[kMaxBit];
  long long pos = pos0;
  const long long nb = nbits[s];
  const bool feed_next = t + 1 < t_end;
  // the first level's entries of row k: lane i's cdf[32 i - 1]
  auto level_one = [&](int k) -> unsigned {
    const unsigned v = rows[k * rw + pad(max(32 * lane - 1, 0))];
    return lane > 0 ? v : 0u;
  };
  unsigned prev1 = level_one(0);
  bool all_ok = true;
  for (int k = 0; k < K; ++k) {
    const int* cdf = rows + k * rw;
    const unsigned prev1_k = prev1;
    if (k + 1 < K) prev1 = level_one(k + 1);
    // 1. bit injection: n doublings at once
    const unsigned long long delta0 = high - low + 1;
    if (delta0 < (1ULL << kRangeBits)) {
      const int n = __clzll(static_cast<long long>(delta0)) - 39;  // 1..24
      const long long b = (pos >> 3) - first_byte;
      const uint32_t* words = reinterpret_cast<const uint32_t*>(window);
      const long long w = b >> 2;
      const unsigned long long pair =
          static_cast<unsigned long long>(words[w]) |
          static_cast<unsigned long long>(words[w + 1]) << 32;
      uint32_t bits = static_cast<uint32_t>(pair >> (8 * (b & 3) + (pos & 7)));
      long long avail = nb - pos;   // bits at or past nbits read as 0
      avail = avail < 0 ? 0 : (avail > 31 ? 31 : avail);
      bits &= (1u << avail) - 1;
      const unsigned long long rev = __brev(bits) >> (32 - n);
      low <<= n;
      high = (high << n) | ((1ULL << n) - 1);
      cur = (cur << n) | rev;
      max_bit += n;
      pos += n;
    }
    // 2. the symbol search (delta and current - low in JAX's low limbs)
    const unsigned delta = static_cast<unsigned>(high - low) + 1u;
    const int cur_rel = static_cast<int>(static_cast<uint32_t>(cur - low));
    // the bucket: every 32nd entry (no entry passes only where
    // current - low < 0: then symbol 0, as the clamp gives it)
    const int c1 = __popc(__ballot_sync(
        kFull, 32 * lane < card && ceil_scaled(prev1_k, delta) <= cur_rel));
    const int base = c1 > 0 ? (c1 - 1) * 32 : 0;
    // inside the bucket: lane tests entry base + lane
    const int j = base + lane;
    const bool in = j < card;
    const unsigned lo_c = cdf[pad(max(j - 1, 0))];
    const unsigned hi_c = cdf[pad(j)];
    const int e_low = ceil_scaled(j > 0 ? lo_c : 0u, delta);
    const int e_high = floor_scaled(in ? hi_c - 1 : 0u, delta);
    const int c = __popc(__ballot_sync(kFull, in && e_low <= cur_rel));
    const int at = c > 0 ? c - 1 : 0;
    const int sym = base + at;
    const int sel_low = __shfl_sync(kFull, e_low, at);
    const int sel_high = __shfl_sync(kFull, e_high, at);
    all_ok = all_ok && sel_low <= cur_rel && cur_rel <= sel_high;
    // 3. the bound update
    high = low + static_cast<unsigned long long>(sel_high);
    low = low + static_cast<unsigned long long>(sel_low);
    // 4. the common-prefix flush: the p bits from max_bit down where low
    //    and high agree. Above bit 63 the twin's clamped int64 shifts read
    //    bit 63 and subtract nothing: those bits flush while low and high
    //    agree at bit 63, and nothing flushes where they differ.
    if (max_bit >= 0 && (max_bit < 64 || (low >> 63) == (high >> 63))) {
      const long long above = max_bit > 63 ? max_bit - 63 : 0;
      const int m = static_cast<int>(max_bit - above);
      const unsigned long long x = (low ^ high) & low_mask(m + 1);
      const int p = x ? m - (63 - __clzll(static_cast<long long>(x))) : m + 1;
      const unsigned long long span = low_mask(m + 1) & ~low_mask(m + 1 - p);
      const unsigned long long sub = low & span;
      low -= sub;
      high -= sub;
      cur -= sub & ~kLoLimb;
      cur = (cur & ~kLoLimb) | ((cur - (sub & kLoLimb)) & kLoLimb);
      max_bit -= above + p;
    }
    if (lane == 0) {
      out[k] = sym;
      next[k] = feed_next ? sym + 1 : 0;
    }
  }
  if (lane == 0) {
    st[kLow] = static_cast<long long>(low);
    st[kHigh] = static_cast<long long>(high);
    st[kCur] = static_cast<long long>(cur);
    st[kMaxBit] = max_bit;
    st[kPos] = pos;
    ok[s] = ok[s] && all_ok;
    eof[s] = eof[s] || pos > nb;
  }
}

int configured_smem = 48 * 1024;    // granted to the kernel so far

}  // namespace

extern "C" {

const char* ac_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ac_head_pull_threads() { return kThreads; }

int ac_head_pull_cluster() { return kCluster; }

int ac_head_pull_max_card() { return kMaxCard; }

long long ac_head_pull_smem_bytes(int K) { return smem_bytes(K); }

// state [S, 5] int64; acc [K, S, card] float64; head_b [K, card] int32;
// lut [1024], nbits, ts [S], t [1] int64 (the step, read on the device);
// data [S, L] uint8; codes [T, S, K], feed [S, K] int64; ok, eof [S] bool;
// all contiguous. `threads` and `smem` are the wrapper's plan (ac_cuda.py
// ac_plan), checked against this file's. The grid is S clusters of
// kCluster CTAs.
int ac_head_pull_launch(void* state, const void* acc, const void* head_b,
                        int e0, const void* lut, const void* data,
                        const void* nbits, const void* ts, const void* t,
                        int S, int K, int card, long long L, long long T,
                        void* codes, void* feed, void* ok, void* eof,
                        int threads, long long smem, void* stream) {
  if (S < 1 || K < 1 || card < 1 || card > kMaxCard || L < 1 || T < 1 ||
      threads != kThreads || smem != smem_bytes(K) ||
      smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > configured_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        ac_head_pull_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured_smem = static_cast<int>(smem);
  }
  ac_head_pull_kernel<<<S * kCluster, kThreads, static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(state), static_cast<const double*>(acc),
      static_cast<const int*>(head_b), e0,
      static_cast<const long long*>(lut), static_cast<const uint8_t*>(data),
      static_cast<const long long*>(nbits), static_cast<const long long*>(ts),
      static_cast<const long long*>(t), S, K, card, L, T,
      static_cast<long long*>(codes), static_cast<long long*>(feed),
      static_cast<bool*>(ok), static_cast<bool*>(eof));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
