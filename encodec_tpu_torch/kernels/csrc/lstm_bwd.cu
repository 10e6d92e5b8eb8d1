// LSTM recurrence backward for Hopper (sm_90a): K3's grid backward kernel,
// 512 < H <= 1024 (H <= 512 is lstm_bwd_cluster.cu's).
//
// The TPU kernel (encodec_tpu/kernels/lstm_pallas.py:55 lstm_scan_pallas)
// is forward-only: the JAX trainer differentiates the `lax.scan` of
// encodec_tpu/ops/lstm.py:56-72 instead, and XLA runs that VJP. On the card
// the forward is K3 (lstm_scan.cu, lstm_grid.cu; in training the SAVE
// instantiations, which also store every step's c), so its gradient is
// this kernel: one launch per layer runs the reverse recurrence
//   dh_t = dy_t + dgates_{t+1} W_hh            (dgates_T = 0)
//   dc_t = dc_{t+1} f_{t+1} + dh_t o_t (1 - tanh^2 c_t)   (dc_T = dc_last)
//   dgates_t = [dc_t g_t i_t (1 - i_t),  dc_t c_{t-1} f_t (1 - f_t),
//               dc_t i_t (1 - g_t^2),    dh_t tanh(c_t) o_t (1 - o_t)]
// (gate order i, f, g, o; i, f, o = sigmoid, g = tanh of the
// pre-activations `pre` = xp + h_{t-1} W_hh^T), and writes dgates [B, T, 4H]
// (= d xp), dh0 = dgates_0 W_hh and dc0 = dc_0 f_0. The pre-activations and
// dW_hh = dgates^T [h0; h_{<T-1}] are one large matmul each, outside the
// kernel, as XLA computes them outside the scan. IEEE expf/tanhf, as in
// the forward.
//
// What bounds it: the T-step chain, as in the forward. W_hh is 16 MiB at
// H = 1024, so, as in lstm_grid.cu, it is spread over the card in
// registers for the whole launch; at B=32 a step is 1 M FP32 FMAs per SM,
// and the step's exchange crosses SMs through L2.
//
// Design: a persistent cooperative grid of G CTAs, one per SM.
// - CTA g owns hidden units [g*U, g*U+U), U = ceil(H / min(SMs, 128)),
//   5 <= U <= 8 (H > 512 on at most 128 CTAs), and holds
//   their 4U gate ROWS of W_hh (CTA row q = gate q / U of unit u0 + q % U,
//   as in the forward): thread x keeps every row at columns k = x and
//   x + 512 (64 registers at U = 8).
// - Step t: each cell thread (unit j, sequence b) computes its four
//   dgates_t from dh_t and its own pre, c and dc (loaded a step ahead),
//   writes them to dgates and to shared memory. Then every thread forms,
//   for its two columns k, partial_g[b, k] = sum over the CTA's rows q (in
//   q order) of dgates_t[b, q] W_hh[q, k] (dgates from shared memory, a
//   broadcast; no sum across lanes), and writes it into the scratch `part`
//   at parity t & 1, laid out [2][owner CTA d][b][source g][unit]: B x H
//   floats per CTA per step, instead of reading all of dgates (B x 4H).
// - After the step's grid barrier, each CTA copies its own block of the
//   parity, [B][G sources x U units] contiguous, into shared memory
//   (cp.async.cg, all in flight at once), and a cell's G partials are
//   added in 16 chains (sources j, j + 16, ... in order), the chains in
//   pairs, pairs of pairs and so on, then added to dy. With few cells
//   (B*U <= 32) 16 threads take a cell, a chain each, and shuffles xor 1,
//   2, 4, 8 add them; else the cell's thread runs the 16 chains and the
//   same tree. The order is fixed, so dh's bits are the same run to run and
//   do not depend on the sequence's slot or on B.
// - The barrier is an arrival counter (zeroed by the caller): after its
//   writes every CTA adds one (thread 0, after a fence) and waits until
//   it reads G * (its arrivals) with acquire semantics. A bounded spin
//   turns a lost arrival into a kernel fault. The cell's inputs of the next
//   step are copied into shared memory (cp.async) from the end of its cell
//   phase on, so they arrive during the products and the barrier. The two
//   parities of `part` make one barrier per step enough: a parity is
//   rewritten two steps later, after every CTA has passed the barrier that
//   follows its reads.
// - The batch per launch is bounded by one cell per thread (512 / U) and
//   by shared memory: 51 sequences at H = 1024 (U = 8, G = 128); the caller
//   splits a larger batch over launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;                 // 512
constexpr int MAX_UNITS = 8;                        // units (4U rows) per CTA
constexpr int MAX_ROWS = 4 * MAX_UNITS;             // 32
constexpr int COLS = 2;                             // columns per thread
constexpr int MAX_H = COLS * THREADS;               // 1024
constexpr int BATCH_TILE = 4;                       // sequences per product
constexpr int MAX_CTAS = 128;
constexpr int CLUSTER_MAX_H = 512;                  // lstm_bwd_cluster.cu's
// the fewest units per CTA above that: ceil(513 / MAX_CTAS)
constexpr int MIN_UNITS = CLUSTER_MAX_H / MAX_CTAS + 1;   // 5
constexpr int CELL_INPUTS = 8;                      // pre (4), c, c', dy, dh
constexpr int CHAINS = 16;                          // of a cell's partial sum
constexpr uint32_t SPIN_LIMIT = 1u << 24;
constexpr int SMEM_LIMIT = 232448;                  // per block, sm_90

// One (destination CTA, sequence) block of partials: G sources x U units,
// padded to whole float4s; in shared memory a row of SBP floats (padded so
// the cells of one warp read distinct banks).
__host__ __device__ constexpr int block_floats(int G, int U) {
  return (G * U + 3) / 4 * 4;
}

__host__ __device__ constexpr int block_stride(int G, int U) {
  return block_floats(G, U) + (U + 3) / 4 * 4;
}

// dgates_t of the CTA's rows [B][32], its units' partials [B][SBP] and the
// cells' inputs of the coming step [B * U][8]
__host__ __device__ constexpr size_t smem_bytes(int B, int G, int U) {
  return (size_t)B * (MAX_ROWS + block_stride(G, U) + CELL_INPUTS * U) *
         sizeof(float);
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every CTA's writes before the barrier are visible to every CTA after it.
__device__ __forceinline__ void grid_barrier(unsigned* counter,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(d), "l"(src) : "memory");
}

// This CTA's block of partials [B][SB] (one parity) into ps_s [B][SBP].
__device__ __forceinline__ void stage_partials(const float* src, float* ps_s,
                                              int B, int SB, int SBP) {
  const int n4 = SB / 4;
  const int db = 4 * THREADS / SB, dj = 4 * THREADS % SB;
  for (int e = threadIdx.x, b = threadIdx.x / n4, j = 4 * (threadIdx.x % n4);
       e < B * n4; e += THREADS) {
    cp_async16(ps_s + (size_t)b * SBP + j, src + (size_t)b * SB + j);
    j += dj;
    b += db + (j >= SB ? 1 : 0);
    j -= j >= SB ? SB : 0;
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// Chain j of a cell's sum: its partials from sources s = j, j + 16, ...
// (row: its unit's entries, U apart), in source order.
__device__ __forceinline__ float chain_sum(const float* row, int j, int G,
                                          int U) {
  float acc = 0.f;
#pragma unroll 4
  for (int s = j; s < G; s += CHAINS) acc += row[s * U];
  return acc;
}

// Chains j0 .. j0+7 of a cell's sum side by side (8 independent loads a
// round), added in pairs, then pairs of pairs.
__device__ __forceinline__ float eight_chains(const float* row, int j0, int G,
                                             int U) {
  float acc[CHAINS / 2];
#pragma unroll
  for (int j = 0; j < CHAINS / 2; ++j) acc[j] = 0.f;
  for (int s0 = j0; s0 < G; s0 += CHAINS) {
#pragma unroll
    for (int j = 0; j < CHAINS / 2; ++j)
      if (s0 + j < G) acc[j] += row[(s0 + j) * U];
  }
#pragma unroll
  for (int d = 1; d < CHAINS / 2; d *= 2)
#pragma unroll
    for (int j = 0; j < CHAINS / 2; j += 2 * d) acc[j] += acc[j + d];
  return acc[0];
}

// The sum of a cell's G partials: 16 chains, added in pairs (0+1, 2+3, ...),
// then pairs of pairs, as the xor 1, 2, 4, 8 shuffles of 16 lanes add them.
__device__ __forceinline__ float cell_sum(const float* row, int G, int U) {
  return eight_chains(row, 0, G, U) + eight_chains(row, CHAINS / 2, G, U);
}

// partial[b, k] = sum_q dg_s[b][q] W[q, k] for sequences b0 .. b0+BT-1 and
// this thread's columns, in q order, written into the block of k's owner
// CTA d = k / U at [source blockIdx.x][unit k % U] (part: one parity).
template <int U, int BT>
__device__ __forceinline__ void products(const float (&w)[4 * U][COLS],
                                         const float* dg_s, int b0, int B,
                                         int H, int SB, float* part) {
  float acc[BT][COLS];
#pragma unroll
  for (int i = 0; i < BT; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
#pragma unroll
  for (int q = 0; q < 4 * U; q += 4) {
#pragma unroll
    for (int i = 0; i < BT; ++i) {
      const float4 d = *reinterpret_cast<const float4*>(
          dg_s + (size_t)(b0 + i) * MAX_ROWS + q);
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        acc[i][c] = fmaf(w[q][c], d.x, acc[i][c]);
        acc[i][c] = fmaf(w[q + 1][c], d.y, acc[i][c]);
        acc[i][c] = fmaf(w[q + 2][c], d.z, acc[i][c]);
        acc[i][c] = fmaf(w[q + 3][c], d.w, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int k = threadIdx.x + c * THREADS;
    if (k < H) {
      const int d = k / U;
      float* dst = part + (size_t)d * B * SB + blockIdx.x * U + (k - d * U);
#pragma unroll
      for (int i = 0; i < BT; ++i) dst[(size_t)(b0 + i) * SB] = acc[i][c];
    }
  }
}

template <int U>
__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_kernel(const float* __restrict__ pre, const float* __restrict__ c_seq,
                const float* __restrict__ c0, const float* __restrict__ dy,
                const float* __restrict__ dc_last,
                const float* __restrict__ w_hh, float* dgates,
                float* __restrict__ dh0, float* __restrict__ dc0, float* part,
                unsigned* counter, int B, int T, int H) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = 4 * U;
  const int G = gridDim.x;
  const int SB = block_floats(G, U);
  const int SBP = block_stride(G, U);
  float* dg_s = smem;                          // [B][32]: dgates_t, CTA rows
  float* ps_s = dg_s + (size_t)B * MAX_ROWS;   // [B][SBP]: partials
  float* in_s = ps_s + (size_t)B * SBP;        // [B * U][8]: cell inputs
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int H4 = 4 * H;
  const size_t parity = (size_t)G * B * SB;
  const float* mine = part + (size_t)blockIdx.x * B * SB;

  // the CTA's rows at this thread's columns, zero past H and past nu
  float w[R][COLS];
#pragma unroll
  for (int q = 0; q < R; ++q) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int k = threadIdx.x + c * THREADS;
      w[q][c] = (q % U < nu && k < H)
          ? w_hh[(size_t)((q / U) * H + u0 + q % U) * H + k] : 0.f;
    }
  }

  // the cell of this thread: unit u0 + cj of sequence cb
  const int cj = threadIdx.x % U;
  const int cb = threadIdx.x / U;
  const bool cell = cj < nu && cb < B;
  const size_t col = (size_t)u0 + cj;
  const float* ps_cell = ps_s + (size_t)cb * SBP + cj;
  float dc = (cell && dc_last != nullptr) ? dc_last[(size_t)cb * H + col]
                                          : 0.f;
  // the cell's inputs of the coming step, copied into shared memory while
  // the step before it runs (cp.async, no registers held): pre (4), c_t,
  // c_{t-1}, dy
  float* in = in_s + (size_t)threadIdx.x * CELL_INPUTS;
  auto load_cell = [&](int t) {
    const size_t bt = (size_t)cb * T + t;
    const float* p = pre + bt * H4 + col;
#pragma unroll
    for (int g = 0; g < 4; ++g) cp_async4(in + g, p + g * H);
    cp_async4(in + 4, c_seq + bt * H + col);
    if (t > 0) cp_async4(in + 5, c_seq + (bt - 1) * H + col);
    else if (c0 != nullptr) cp_async4(in + 5, c0 + (size_t)cb * H + col);
    else in[5] = 0.f;
    cp_async4(in + 6, dy + bt * H + col);
  };
  if (cell) load_cell(T - 1);
  // rows of units past nu stay zero (their W is zero: no 0 * NaN)
  for (int e = threadIdx.x; e < B * MAX_ROWS; e += THREADS) dg_s[e] = 0.f;
  __syncthreads();

  // few cells: each cell's sum over 16 threads (same chains, same tree)
  const bool spread = B * U * CHAINS <= THREADS;
  unsigned arrivals = 0;
  for (int t = T - 1; t >= 0; --t) {
    const bool recur = t + 1 < T;
    if (recur) {
      stage_partials(mine + ((t + 1) & 1) * parity, ps_s, B, SB, SBP);
      if (spread) {
        // 16 threads per cell, one chain each (cells of 16 lanes)
        const int e = threadIdx.x / CHAINS, j = threadIdx.x % CHAINS;
        float v = e < B * U
            ? chain_sum(ps_s + (size_t)(e / U) * SBP + e % U, j, G, U) : 0.f;
#pragma unroll
        for (int d = 1; d < CHAINS; d *= 2)
          v += __shfl_xor_sync(0xffffffffu, v, d);
        if (j == 0 && e < B * U) in_s[(size_t)e * CELL_INPUTS + 7] = v;
        __syncthreads();
      }
    }
    if (cell) {
      asm volatile("cp.async.wait_all;" ::: "memory");
      const float c = in[4], cp = in[5];
      float dh = in[6];
      if (recur) dh += spread ? in[7] : cell_sum(ps_cell, G, U);
      const float i = sigmoidf(in[0]);
      const float f = sigmoidf(in[1]);
      const float g = tanhf(in[2]);
      const float o = sigmoidf(in[3]);
      const float tc = tanhf(c);
      dc = fmaf(dh * o, 1.f - tc * tc, dc);
      const float d[4] = {dc * g * (i * (1.f - i)), dc * cp * (f * (1.f - f)),
                          dc * i * (1.f - g * g), dh * tc * (o * (1.f - o))};
      float* out = dgates + ((size_t)cb * T + t) * H4 + col;
      float* ds = dg_s + (size_t)cb * MAX_ROWS + cj;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        out[k * H] = d[k];
        ds[k * U] = d[k];
      }
      dc *= f;
      if (t == 0 && dc0 != nullptr) dc0[(size_t)cb * H + col] = dc;
      if (t > 0) load_cell(t - 1);
    }
    if (t > 0 || dh0 != nullptr) {
      __syncthreads();
      float* dst = part + (t & 1) * parity;
      int b0 = 0;
      for (; b0 + BATCH_TILE <= B; b0 += BATCH_TILE)
        products<U, BATCH_TILE>(w, dg_s, b0, B, H, SB, dst);
      for (; b0 < B; ++b0) products<U, 1>(w, dg_s, b0, B, H, SB, dst);
      grid_barrier(counter, G * ++arrivals);
    }
  }
  if (dh0 != nullptr) {
    stage_partials(mine, ps_s, B, SB, SBP);
    if (cell) dh0[(size_t)cb * H + col] = cell_sum(ps_cell, G, U);
  }
}

template <int U>
cudaError_t prepare(int B, int G) {
  return cudaFuncSetAttribute(lstm_bwd_kernel<U>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(B, G, U)));
}

template <int U>
int max_ctas(int B, int G) {
  cudaError_t err = prepare<U>(B, G);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lstm_bwd_kernel<U>, THREADS, smem_bytes(B, G, U));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

template <int U>
int launch(const float* pre, const float* c_seq, const float* c0,
           const float* dy, const float* dc_last, const float* w_hh,
           float* dgates, float* dh0, float* dc0, float* part,
           unsigned* counter, int B, int T, int H, int G,
           cudaStream_t stream) {
  cudaError_t err = prepare<U>(B, G);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(B, G, U);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lstm_bwd_kernel<U>, pre, c_seq, c0, dy,
                           dc_last, w_hh, dgates, dh0, dc0, part, counter, B,
                           T, H);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int U>
int attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, lstm_bwd_kernel<U>);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

bool valid(int B, int G, int U) {
  return B >= 1 && U >= MIN_UNITS && U <= MAX_UNITS && B * U <= THREADS &&
         G >= 1 && G <= MAX_CTAS && smem_bytes(B, G, U) <= SMEM_LIMIT;
}

}  // namespace

#define LSTM_BWD_BY_UNITS(CALL) \
  switch (U) {                  \
    case 5: return CALL(5);     \
    case 6: return CALL(6);     \
    case 7: return CALL(7);     \
    case 8: return CALL(8);     \
    default: break;             \
  }

extern "C" {

const char* lstm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Layout constants, for the wrapper's plan and its checks.
int lstm_bwd_threads() { return THREADS; }
int lstm_bwd_max_units() { return MAX_UNITS; }
int lstm_bwd_min_units() { return MIN_UNITS; }
int lstm_bwd_cols() { return COLS; }
int lstm_bwd_batch_tile() { return BATCH_TILE; }
int lstm_bwd_max_h() { return MAX_H; }
int lstm_bwd_max_ctas_limit() { return MAX_CTAS; }
int lstm_bwd_smem_bytes(int B, int G, int U) {
  return valid(B, G, U) ? static_cast<int>(smem_bytes(B, G, U)) : -1;
}

// How many CTAs of the kernel for U units per CTA, with a batch of B per
// launch on G CTAs, the card holds at once (negative: a CUDA error).
int lstm_bwd_max_ctas(int U, int B, int G) {
  if (valid(B, G, U)) {
#define CALL(N) max_ctas<N>(B, G)
    LSTM_BWD_BY_UNITS(CALL)
#undef CALL
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Registers per thread and local (spill) bytes of the kernel for U units
// (MIN_UNITS <= U <= MAX_UNITS).
int lstm_bwd_attributes(int U, int* regs, int* local_bytes) {
#define CALL(N) attributes<N>(regs, local_bytes)
  LSTM_BWD_BY_UNITS(CALL)
#undef CALL
  return cudaErrorInvalidValue;
}

// pre [B, T, 4H] (the forward's pre-activations), c_seq [B, T, H] (its cell
// states), dy [B, T, H] (the gradient of its h outputs), w_hh [4H, H],
// dgates [B, T, 4H] (out), all contiguous f32; c0 [B, H], the initial cell
// state (null: zero), dc_last [B, H], the gradient of the final c (null:
// zero), dh0 and dc0 [B, H], the gradients of the initial state (null: not
// written); part: 16-byte aligned scratch of 2 x G x B x SB f32 (SB = G*U
// rounded up to a multiple of 4); counter: one zeroed uint32 on the
// device; both used by this launch only. The plan: G CTAs, CTA g
// owning units [g*U, g*U+U); 512 < H <= 1024.
int lstm_bwd_launch(const float* pre, const float* c_seq, const float* c0,
                    const float* dy, const float* dc_last, const float* w_hh,
                    float* dgates, float* dh0, float* dc0, float* part,
                    unsigned* counter, int B, int T, int H, int U, int G,
                    void* stream) {
  if (T == 0) return 0;
  if (H <= CLUSTER_MAX_H || H > MAX_H || !valid(B, G, U) ||
      (long long)G * U < H || (long long)(G - 1) * U >= H ||
      counter == nullptr ||
      reinterpret_cast<uintptr_t>(part) % 16 != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(N)                                                              \
  launch<N>(pre, c_seq, c0, dy, dc_last, w_hh, dgates, dh0, dc0, part,       \
            counter, B, T, H, G, st)
  LSTM_BWD_BY_UNITS(CALL)
#undef CALL
  return cudaErrorInvalidValue;
}

}  // extern "C"
