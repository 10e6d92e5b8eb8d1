// LSTM recurrence above H = 512 for Hopper (sm_90a): K3's grid kernel.
//
// Replaces encodec_tpu/kernels/lstm_pallas.py:55 lstm_scan_pallas (body
// _scan_kernel) for 512 < H <= 1024, the breathing tokenizer's hidden size
// (H = 32 * 2^5 = 1024). The cluster kernel of lstm_scan.cu takes H <= 512.
// It computes what that kernel computes: one LSTM layer's recurrence over
// gate inputs xp [B, T, 4H] (= x W_ih^T + b_ih + b_hh), gate order i, f,
// g, o,
//   gates_t = xp_t + h_{t-1} W_hh^T
//   c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g),  h_t = sigmoid(o) tanh(c_t)
// with IEEE expf/tanhf, from zero state or from a given (h0, c0) [B, H],
// writing h [B, T, H] and, when asked, the final c [B, H]. Step 0 with a
// state runs the same code as every later step (h_{-1} = h0), so launches
// over any split of T with (h, c) carried give the bits of one launch.
//
// What bounds it: the T-step chain. At H=1024 W_hh is 4096 x 1024 f32 = 16
// MiB, which no 16-CTA cluster can hold, so W_hh is spread over the whole
// card and held in registers for the launch, and h crosses SMs through L2
// once per step. At B=32 a step is 1 M FP32 FMAs per SM (4.1 us at the
// card's peak); at B=1 it is latency: the exchange of h and the step's
// dependent chain.
//
// Design: a persistent grid of G CTAs, one per SM, launched cooperatively
// (cudaLaunchAttributeCooperative: a grid the card cannot hold at once
// fails at launch instead of hanging).
// - CTA g owns hidden units [g*U, g*U+U), U = ceil(H / SMs) <= 8 (H=1024:
//   U=8, G=128): 4U gate rows of W_hh, CTA row q = gate q / U of unit
//   u0 + q % U. Its 16 warps are 4 row groups x 4 k slices: warp w holds
//   rows 8 (w % 4) .. +7 over k slice w / 4 (256 k), and lane l of it holds
//   those 8 rows at k = slice*256 + 4l + {0..3} and + 128 + {0..3}: 64
//   registers of W per thread for the whole launch. A float of h read from
//   shared memory feeds 8 FMAs (FMA-bound, not shared-memory-bound).
// - Each step h_{t-1} of every sequence is staged in shared memory ([Bp][HP]
//   zero-padded), and every busy warp runs its 8 rows over its k slice for
//   tiles of 2 sequences (a lone last sequence takes a tile of 1): 16 (or
//   8) sums per lane, folded across the 32 lanes by a butterfly that pairs
//   lanes xor 16, 8, 4, 2, 1 whatever the tile, so a sequence's sums do not
//   depend on its slot or on B. A lane holds its rows (and, in a tile of
//   2, takes its sequences) in an order permuted by its lane bits, so each
//   level is one shuffle and one add per pair, with no selects. The k
//   slices' sums meet in shared memory, where the thread of cell (unit j,
//   sequence b) adds its gate's slices in slice order to xp, updates c in
//   a register and writes h.
// - h is exchanged through `out` itself, in one of two ways chosen by B
//   (two instantiations):
//   - below B=10, no grid barrier: the wrapper fills `out` with EMPTY
//     (0xffffffff, a NaN no arithmetic produces: the card's NaNs are
//     0x7fffffff) before the launch, step t writes h_t into out[:, t]
//     (st.relaxed.gpu), right after its cells every thread starts copying
//     its float4s of out[:, t] into shared memory (cp.async.cg through L2,
//     all in flight at once), and before step t+1's matvec copies again
//     those that still hold an EMPTY word until none does. Every word is
//     written once, so a word that is not EMPTY is final. It saves the
//     barrier's round trips where the step is short;
//   - from B=10 on, an arrival counter: after its cells every CTA adds one
//     (thread 0, after a fence), waits until every CTA has arrived, then
//     copies h_t once. Polling there costs more than the barrier, as
//     copies of words not yet written are repeated in bulk.
//   A bounded spin turns a lost write or arrival into a kernel fault.
// - Gate inputs of step t+1 are loaded right after step t's h is written.
// - Training needs every step's c for the backward (lstm_bwd.cu): the
//   SAVE instantiation also stores c_t into c_seq [B, T, H]. Its
//   arithmetic is the plain instantiation's, so `out` has the same bits.
// - The batch per launch is bounded by shared memory (h of every sequence)
//   and by one cell per thread: at most 48 at H > 768, 62 at H <= 768; the
//   caller splits a larger batch over launches (sequences are independent,
//   and a sequence's arithmetic does not depend on its slot).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;                  // 512
constexpr int ROW_GROUPS = 4;                        // warp w: rows of w % 4
constexpr int LANE_ROWS = 8;                         // W_hh rows per lane
constexpr int MAX_ROWS = ROW_GROUPS * LANE_ROWS;     // 32 gate rows per CTA
constexpr int MAX_UNITS = MAX_ROWS / 4;              // 8 units per CTA
constexpr int LANE_K = 8;                            // k per lane: 2 float4
constexpr int HALF_SLICE = 4 * 32;                   // 128: the float4s' gap
constexpr int K_SLICE = LANE_K * 32;                 // 256 k per warp
constexpr int K_SLICES = WARPS / ROW_GROUPS;         // 4: warp w, w / 4
constexpr int MAX_H = K_SLICES * K_SLICE;            // 1024
constexpr int MIN_H = 4 * HALF_SLICE + 1;            // 513 (H <= 512: cluster)
constexpr int BATCH_TILE = 2;                        // sequences per pass
constexpr int MAX_BATCH = THREADS / MAX_UNITS;       // 64: a cell a thread
constexpr int SLICE_STRIDE = 40;                     // floats per (slice, b)
constexpr unsigned EMPTY = 0xffffffffu;
constexpr uint32_t SPIN_LIMIT = 1u << 24;
constexpr int SMEM_LIMIT = 232448;                   // per block, sm_90
constexpr int FENCED_BATCH = 10;                     // from here: a barrier

__host__ __device__ constexpr int k_slices(int H) {
  return (H + K_SLICE - 1) / K_SLICE;
}

// Launches of FENCED_BATCH sequences or more wait on a barrier before one
// copy of h; smaller ones poll `out` (which the wrapper then fills with
// EMPTY first).
__host__ __device__ constexpr bool fenced(int B) {
  return B >= FENCED_BATCH;
}

__host__ __device__ constexpr int padded_batch(int B) {
  return (B + BATCH_TILE - 1) / BATCH_TILE * BATCH_TILE;
}

// h of every sequence [Bp][HP] and the slices' row sums [K_SLICES][Bp][40]
__host__ __device__ constexpr size_t smem_bytes(int H, int B) {
  return (size_t)padded_batch(B) *
         (k_slices(H) * K_SLICE + K_SLICES * SLICE_STRIDE) * sizeof(float);
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ float dot4(float4 w, float4 h, float acc) {
  acc = fmaf(w.x, h.x, acc);
  acc = fmaf(w.y, h.y, acc);
  acc = fmaf(w.z, h.z, acc);
  return fmaf(w.w, h.w, acc);
}

// One butterfly level over 2*HALF sums, pairing lanes xor DIST: slot i
// adds the partner's slot i + HALF. Each lane's slots hold its values in
// an order permuted by its lane bits (row_sums), so that the partner's slot
// i + HALF holds the value of this lane's slot i: no selects.
template <int HALF, int DIST, int N>
__device__ __forceinline__ void fold(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < HALF; ++i)
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i + HALF], DIST);
}

__device__ __forceinline__ float ld_poll(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];"
               : "=f"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_publish(float* p, float v) {
  asm volatile("st.relaxed.gpu.global.f32 [%0], %1;" :: "l"(p), "f"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// After the step's writes: every CTA adds one to the arrival counter
// (thread 0, after a fence).
__device__ __forceinline__ void arrive(unsigned* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
  }
}

// Until every CTA has arrived `round` times (acquire); every CTA's writes
// before its arrivals are then visible.
__device__ __forceinline__ void wait_arrived(const unsigned* counter,
                                             unsigned round) {
  if (threadIdx.x == 0) {
    const unsigned target = gridDim.x * round;
    for (uint32_t i = 0; ld_acquire(counter) < target; ++i) {
      if (i == SPIN_LIMIT) __trap();
    }
  }
  __syncthreads();
}

// 16 bytes global -> shared through L2 (cp.async.cg), no registers held
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ bool empty(float v) {
  return __float_as_uint(v) == EMPTY;
}

__device__ __forceinline__ bool empty4(float4 v) {
  return empty(v.x) | empty(v.y) | empty(v.z) | empty(v.w);
}

// This thread's float4s of rows [b0, b1) of h: (b, k) from (b0, 4 * thread)
// in steps of 4 * THREADS words, carried over rows of H words.
#define FOR_ROW_WORDS(b0, b1, H, b, k)                                       \
  for (int e_ = threadIdx.x, n_ = ((b1) - (b0)) * ((H) / 4),                \
           db_ = 4 * THREADS / (H), dk_ = 4 * THREADS % (H),                 \
           b = (b0) + threadIdx.x / ((H) / 4),                               \
           k = 4 * (threadIdx.x % ((H) / 4));                                \
       e_ < n_; e_ += THREADS, k += dk_, b += db_ + (k >= (H) ? 1 : 0),      \
           k -= k >= (H) ? (H) : 0)

// Start copying rows [b0, b1) of h into shared memory (cp.async.cg through
// L2, every float4 of the thread in flight at once).
__device__ __forceinline__ void fetch_rows(const float* src, size_t stride,
                                           float* h_s, int HP, int b0,
                                           int b1, int H) {
  FOR_ROW_WORDS(b0, b1, H, b, k)
    cp_async16(h_s + (size_t)b * HP + k, src + (size_t)b * stride + k);
}

// Rows [b0, b1) of h_{t-1} from out, which the CTAs are writing: wait for
// this thread's copies, then copy again every float4 that still holds an
// EMPTY word until none does. Without float4 rows (vec = 0): one polled
// float at a time.
__device__ __forceinline__ void settle_rows(const float* src, size_t stride,
                                            float* h_s, int HP, int b0,
                                            int b1, int H, int vec) {
  if (!vec) {
    for (int e = threadIdx.x; e < (b1 - b0) * H; e += THREADS) {
      const int b = b0 + e / H, k = e % H;
      const float* p = src + (size_t)b * stride + k;
      float v = ld_poll(p);
      for (uint32_t spin = 0; empty(v); ++spin) {
        if (spin == SPIN_LIMIT) __trap();
        v = ld_poll(p);
      }
      h_s[(size_t)b * HP + k] = v;
    }
    return;
  }
  cp_async_wait();
  for (uint32_t spin = 0;; ++spin) {
    bool waiting = false;
    FOR_ROW_WORDS(b0, b1, H, b, k) {
      float* d = h_s + (size_t)b * HP + k;
      if (empty4(*reinterpret_cast<const float4*>(d))) {
        waiting = true;
        cp_async16(d, src + (size_t)b * stride + k);
      }
    }
    if (!waiting) break;
    if (spin == SPIN_LIMIT) __trap();
    cp_async_wait();
  }
}

// Rows [b0, b1) of h into h_s, all final (h0, or out after the barrier).
__device__ __forceinline__ void copy_rows(const float* src, size_t stride,
                                          float* h_s, int HP, int b0, int b1,
                                          int H, int vec) {
  if (vec) {
    fetch_rows(src, stride, h_s, HP, b0, b1, H);
    cp_async_wait();
  } else {
    for (int e = threadIdx.x; e < (b1 - b0) * H; e += THREADS) {
      const int b = b0 + e / H, k = e % H;
      h_s[(size_t)b * HP + k] = src[(size_t)b * stride + k];
    }
  }
}

// This warp's 8 rows over its k slice for sequences b0 .. b0+BT-1, summed
// over the 32 lanes (pairs xor 16, 8, 4, 2, 1) into p_s [slice][b][row].
// Slot r * BT + i of lane l holds row r ^ ((l >> 2) & 7) (the rows of `wr`
// are loaded so) of sequence i ^ ((l >> 1) & 1) (BT = 2), so the folds pair
// lane bits 4, 3, 2 with the row and bit 1 with the sequence, and lane l
// ends with row (l >> 2) & 7 of sequence (l >> 1) & 1. Whatever the tile,
// each sum is the same tree over the lanes.
template <int BT>
__device__ __forceinline__ void row_sums(const float4 (&wr)[LANE_ROWS][2],
                                         const float* h_s, int HP, int b0,
                                         int kbase, float* p_s, int lane) {
  constexpr int V = LANE_ROWS * BT;
  const int flip = BT == 2 ? (lane >> 1) & 1 : 0;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int i = 0; i < BT; ++i) {
      const float4 h4 = *reinterpret_cast<const float4*>(
          h_s + (size_t)(b0 + (i ^ flip)) * HP + kbase + m * HALF_SLICE);
#pragma unroll
      for (int r = 0; r < LANE_ROWS; ++r)
        acc[r * BT + i] = dot4(wr[r][m], h4, acc[r * BT + i]);
    }
  }
  if constexpr (BT == 2) {
    fold<8, 16>(acc);
    fold<4, 8>(acc);
    fold<2, 4>(acc);
    fold<1, 2>(acc);
    const float s = acc[0] + __shfl_xor_sync(0xffffffffu, acc[0], 1);
    if ((lane & 1) == 0)
      p_s[(size_t)(b0 + ((lane >> 1) & 1)) * SLICE_STRIDE + (lane >> 2)] = s;
  } else {
    fold<4, 16>(acc);
    fold<2, 8>(acc);
    fold<1, 4>(acc);
    float s = acc[0] + __shfl_xor_sync(0xffffffffu, acc[0], 2);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if ((lane & 3) == 0) p_s[(size_t)b0 * SLICE_STRIDE + (lane >> 2)] = s;
  }
}

template <bool SAVE, bool FENCED>
__global__ void __launch_bounds__(THREADS, 1)
lstm_grid_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
                 const float* __restrict__ h0, const float* __restrict__ c0,
                 float* out, float* __restrict__ c_out,
                 float* __restrict__ c_seq, unsigned* counter, int B, int T,
                 int H, int U, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int nks = k_slices(H);
  const int HP = nks * K_SLICE;
  const int Bp = padded_batch(B);
  float* h_s = smem;                         // [Bp][HP]: h_{t-1}, zero pad
  float* p_s = h_s + (size_t)Bp * HP;        // [K_SLICES][Bp][40]: row sums

  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int R = 4 * U;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = warp % ROW_GROUPS;
  const int ks = warp / ROW_GROUPS;
  const int kbase = ks * K_SLICE + 4 * lane;
  const int H4 = 4 * H;
  const bool stateful = h0 != nullptr;
  const bool busy = rg * LANE_ROWS < R && ks < nks;
  float* ps_warp = p_s + (size_t)ks * Bp * SLICE_STRIDE + rg * LANE_ROWS;

  // this lane's W_hh rows and k, zero past H and for units past the last
  float4 wr[LANE_ROWS][2];
#pragma unroll
  for (int r = 0; r < LANE_ROWS; ++r) {
    const int q = rg * LANE_ROWS + (r ^ ((lane >> 2) & 7));  // see row_sums
    const float* row = (q < R && q % U < nu)
        ? w_hh + (size_t)((q / U) * H + u0 + q % U) * H : nullptr;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = kbase + m * HALF_SLICE + e;
        v[e] = (row != nullptr && k < H) ? row[k] : 0.f;
      }
      wr[r][m] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  for (int e = threadIdx.x; e < Bp * (HP + K_SLICES * SLICE_STRIDE);
       e += THREADS)
    smem[e] = 0.f;

  // the cell of this thread: unit u0 + cj of sequence cb
  const int cj = threadIdx.x % U;
  const int cb = threadIdx.x / U;
  const bool cell = cj < nu && cb < B;
  const float* xrow = xp + (size_t)cb * T * H4 + u0 + cj;
  float c = 0.f;
  float xg[4] = {0.f, 0.f, 0.f, 0.f};  // gate inputs of the coming step
  if (cell) {
    if (c0 != nullptr) c = c0[(size_t)cb * H + u0 + cj];
#pragma unroll
    for (int g = 0; g < 4; ++g) xg[g] = __ldg(xrow + g * H);
  }
  __syncthreads();

  const size_t row_stride = (size_t)T * H;
  if (stateful) copy_rows(h0, H, h_s, HP, 0, B, H, vec);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // zero state: the recurrent term of step 0 is 0
    const bool recur = t > 0 || stateful;
    if (recur) {
      if (t > 0) {
        // h_{t-1} of every sequence, as the CTAs wrote it into out[:, t-1]
        const float* src = out + (size_t)(t - 1) * H;
        if (FENCED) {
          wait_arrived(counter, t);
          copy_rows(src, row_stride, h_s, HP, 0, B, H, vec);
        } else {
          settle_rows(src, row_stride, h_s, HP, 0, B, H, vec);
        }
        __syncthreads();
      }
      if (busy) {
        int b0 = 0;
        for (; b0 + BATCH_TILE <= B; b0 += BATCH_TILE)
          row_sums<BATCH_TILE>(wr, h_s, HP, b0, kbase, ps_warp, lane);
        if (b0 < B) row_sums<1>(wr, h_s, HP, b0, kbase, ps_warp, lane);
      }
      __syncthreads();
    }
    if (cell) {
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float rs = 0.f;
        if (recur) {
          const float* p = p_s + (size_t)cb * SLICE_STRIDE + g * U + cj;
          rs = p[0];
          for (int s = 1; s < nks; ++s)
            rs += p[(size_t)s * Bp * SLICE_STRIDE];
        }
        gate[g] = xg[g] + rs;
      }
      c = sigmoidf(gate[1]) * c + sigmoidf(gate[0]) * tanhf(gate[2]);
      const float h = sigmoidf(gate[3]) * tanhf(c);
      const size_t at = ((size_t)cb * T + t) * H + u0 + cj;
      st_publish(out + at, h);
      if (SAVE) c_seq[at] = c;
      if (t == T - 1 && c_out != nullptr) c_out[(size_t)cb * H + u0 + cj] = c;
      if (t + 1 < T) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          xg[g] = __ldg(xrow + (size_t)(t + 1) * H4 + g * H);
      }
    }
    if (t + 1 < T) {
      if (FENCED)
        arrive(counter);
      else if (vec)  // start the copies of h_t: checked at the next step
        fetch_rows(out + (size_t)t * H, row_stride, h_s, HP, 0, B, H);
    }
  }
}

template <bool SAVE, bool FENCED>
cudaError_t prepare(int H, int B) {
  return cudaFuncSetAttribute(lstm_grid_kernel<SAVE, FENCED>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(H, B)));
}

// (every instantiation takes the same shared memory and threads, and runs
// at the launch bound's one CTA per SM)
int max_ctas(int H, int B) {
  cudaError_t err = prepare<false, false>(H, B);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lstm_grid_kernel<false, false>, THREADS, smem_bytes(H, B));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

template <bool SAVE, bool FENCED>
int launch_as(const float* xp, const float* w_hh, const float* h0,
              const float* c0, float* out, float* c_out, float* c_seq,
              unsigned* counter, int B, int T, int H, int U, int G,
              cudaStream_t stream) {
  cudaError_t err = prepare<SAVE, FENCED>(H, B);
  if (err != cudaSuccess) return err;
  if (!FENCED) {
    // every word of out EMPTY until its step writes it
    err = cudaMemsetAsync(out, 0xff, (size_t)B * T * H * sizeof(float),
                          stream);
    if (err != cudaSuccess) return err;
  }
  // float4 h copies need 16-byte rows
  const int vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(h0) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(H, B);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lstm_grid_kernel<SAVE, FENCED>, xp, w_hh,
                           h0, c0, out, c_out, c_seq, counter, B, T, H, U,
                           vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instantiation for B: saving every c or not, a barrier or polling.
template <bool SAVE>
int launch(const float* xp, const float* w_hh, const float* h0,
           const float* c0, float* out, float* c_out, float* c_seq,
           unsigned* counter, int B, int T, int H, int U, int G,
           cudaStream_t stream) {
  if (fenced(B))
    return launch_as<SAVE, true>(xp, w_hh, h0, c0, out, c_out, c_seq,
                                 counter, B, T, H, U, G, stream);
  return launch_as<SAVE, false>(xp, w_hh, h0, c0, out, c_out, c_seq,
                                counter, B, T, H, U, G, stream);
}

template <bool SAVE, bool FENCED>
int attributes_as(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, lstm_grid_kernel<SAVE, FENCED>);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

bool valid_h(int H) { return H >= MIN_H && H <= MAX_H; }

bool valid_b(int H, int B) {
  return B >= 1 && B <= MAX_BATCH && smem_bytes(H, B) <= SMEM_LIMIT;
}

}  // namespace

extern "C" {

const char* lstm_grid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Layout constants, for the wrapper's plan and its checks.
int lstm_grid_threads() { return THREADS; }
int lstm_grid_max_units() { return MAX_UNITS; }
int lstm_grid_lane_rows() { return LANE_ROWS; }
int lstm_grid_lane_k() { return LANE_K; }
int lstm_grid_batch_tile() { return BATCH_TILE; }
int lstm_grid_max_batch() { return MAX_BATCH; }
int lstm_grid_max_h() { return MAX_H; }
int lstm_grid_fenced(int B) { return fenced(B); }
int lstm_grid_smem_bytes(int H, int B) {
  return valid_h(H) && valid_b(H, B) ? static_cast<int>(smem_bytes(H, B))
                                     : -1;
}

// How many CTAs of the kernel for H, with a batch of B per launch, the card
// holds at once (negative: a CUDA error).
int lstm_grid_max_ctas(int H, int B) {
  if (!valid_h(H) || !valid_b(H, B))
    return -static_cast<int>(cudaErrorInvalidValue);
  return max_ctas(H, B);
}

// Registers per thread and local (spill) bytes of the instantiation that
// saves every c (save = 1) or not (0) and waits on a barrier (fenced = 1)
// or polls (0).
int lstm_grid_attributes(int save, int fenced, int* regs, int* local_bytes) {
  if (save)
    return fenced ? attributes_as<true, true>(regs, local_bytes)
                  : attributes_as<true, false>(regs, local_bytes);
  return fenced ? attributes_as<false, true>(regs, local_bytes)
                : attributes_as<false, false>(regs, local_bytes);
}

// xp [B, T, 4H], w_hh [4H, H], out [B, T, H] (all contiguous f32); h0 and
// c0 [B, H], the initial state (both null: zero state), c_out [B, H], the
// final cell state (null: not written), and c_seq [B, T, H], every step's
// cell state (null: not written); counter: one zeroed uint32 on the
// device, used by this launch only. Unless fenced(B), `out` is filled with
// EMPTY on the stream first. The plan: G CTAs, CTA g owning units
// [g*U, g*U+U).
int lstm_grid_launch(const float* xp, const float* w_hh, const float* h0,
                     const float* c0, float* out, float* c_out, float* c_seq,
                     unsigned* counter, int B, int T, int H, int U, int G,
                     void* stream) {
  if (T == 0) return 0;
  if (!valid_h(H) || !valid_b(H, B) || U < 1 || U > MAX_UNITS || G < 1 ||
      (long long)G * U < H || (long long)(G - 1) * U >= H ||
      counter == nullptr || (h0 == nullptr) != (c0 == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c_seq != nullptr)
    return launch<true>(xp, w_hh, h0, c0, out, c_out, c_seq, counter, B, T,
                        H, U, G, st);
  return launch<false>(xp, w_hh, h0, c0, out, c_out, c_seq, counter, B, T,
                       H, U, G, st);
}

}  // extern "C"
