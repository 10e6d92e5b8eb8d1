// LSTM recurrence backward for Hopper (sm_90a): K3's backward kernel.
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
// What bounds it: the T-step chain, as in the forward. Each step needs all
// of dgates_{t+1} (4H per sequence) and W_hh is 16 MiB at H = 1024, so,
// as in lstm_grid.cu, W_hh is spread over the card for the whole launch
// and the step's vector crosses SMs through L2 once per step.
//
// Design (a mirror of lstm_grid.cu): a persistent cooperative grid of G
// CTAs, one per SM, with the same bounded-spin grid barrier.
// - CTA g owns hidden units [g*U, g*U+U), U = ceil(H / SMs) <= 8, and holds
//   their COLUMNS W_hh[:, slice] (4H x U floats, the forward's register
//   footprint) in registers: thread x keeps row j = m*512 + x of every
//   column, m < ceil(4H / 512) (64 registers at H = 1024).
// - At step t each thread reads dgates_{t+1}[b, j] (ld.global.cg: written
//   by every CTA before the last barrier; consecutive threads read
//   consecutive j) and accumulates 8 units x 2 sequences; a butterfly of
//   16 shuffles leaves lane l with the warp's sum of value l >> 1, and the
//   16 warps' sums meet in shared memory, where the thread of cell (unit j,
//   sequence b) adds them in a fixed order. The sums are thus the same
//   whatever the timing, run to run.
// - The cell's thread keeps dc in a register, reads its unit's four
//   pre-activations, c_t and c_{t-1}, writes its four rows of dgates_t, and
//   the grid barrier follows (one per step, none after the last unless dh0
//   is asked for). Nothing is overwritten, so one barrier suffices.
// - The batch per launch is bounded by one cell per thread: 64 sequences
//   (at U = 8); the caller splits a larger batch over launches.
// Simple first: no tensor cores, no TMA, one barrier per step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;                 // 512
constexpr int MAX_UNITS = 8;                        // columns per CTA
constexpr int JCHUNK = THREADS;                     // gate rows per pass
constexpr int MAX_JM = 8;                           // 4H <= 4096
constexpr int BATCH_TILE = 2;                       // sequences per pass
constexpr int VALUES = MAX_UNITS * BATCH_TILE;      // 16 sums per lane
constexpr int MAX_BATCH = THREADS / MAX_UNITS;      // 64: a cell a thread
constexpr int MAX_H = MAX_JM * JCHUNK / 4;          // 1024

__host__ __device__ constexpr int j_chunks(int H) {
  return (4 * H + JCHUNK - 1) / JCHUNK;
}

// the warps' sums of every batch tile [tiles][WARPS][VALUES]
__host__ __device__ constexpr size_t smem_bytes(int B) {
  return (size_t)((B + BATCH_TILE - 1) / BATCH_TILE) * WARPS * VALUES *
         sizeof(float);
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

// One butterfly level over 2*HALF partial sums: lanes with bit 2*HALF set
// keep the upper half, the others the lower, each adding its partner's.
template <int HALF>
__device__ __forceinline__ void fold(float (&acc)[VALUES], int lane) {
  const bool up = (lane & (2 * HALF)) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? acc[i] : acc[i + HALF];
    const float keep = up ? acc[i + HALF] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
  }
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
      if (i == (1u << 24)) __trap();
    }
  }
  __syncthreads();
}

// red_s[tile][warp][v] = this warp's share of sum_j dg[b, j] W[j, u0 + u]
// for sequence b = 2 * tile + v % 2 and unit u = v / 2, over the rows
// `dg` (the step's dgates, row b at dg + b * stride).
template <int JM>
__device__ __forceinline__ void column_products(
    const float (&wc)[JM][MAX_UNITS], const float* dg, size_t stride, int B,
    int H4, float* red_s) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int b0 = 0; b0 < B; b0 += BATCH_TILE) {
    float acc[VALUES];
#pragma unroll
    for (int v = 0; v < VALUES; ++v) acc[v] = 0.f;
#pragma unroll
    for (int i = 0; i < BATCH_TILE; ++i) {
      if (b0 + i < B) {
        const float* row = dg + (size_t)(b0 + i) * stride;
#pragma unroll
        for (int m = 0; m < JM; ++m) {
          const int j = m * JCHUNK + threadIdx.x;
          const float d = j < H4 ? __ldcg(row + j) : 0.f;
#pragma unroll
          for (int u = 0; u < MAX_UNITS; ++u)
            acc[u * BATCH_TILE + i] = fmaf(wc[m][u], d, acc[u * BATCH_TILE + i]);
        }
      }
    }
    // butterfly: 16 sums x 32 lanes -> lane l holds sum l >> 1
    fold<8>(acc, lane);
    fold<4>(acc, lane);
    fold<2>(acc, lane);
    fold<1>(acc, lane);
    const float v = acc[0] + __shfl_xor_sync(0xffffffffu, acc[0], 1);
    if ((lane & 1) == 0)
      red_s[((size_t)(b0 / BATCH_TILE) * WARPS + warp) * VALUES + (lane >> 1)] =
          v;
  }
  __syncthreads();
}

// the 16 warps' sums for cell (unit cj, sequence cb), in warp order
__device__ __forceinline__ float cell_sum(const float* red_s, int cj, int cb) {
  const float* p = red_s + (size_t)(cb / BATCH_TILE) * WARPS * VALUES +
                   cj * BATCH_TILE + cb % BATCH_TILE;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += p[w * VALUES];
  return s;
}

template <int JM>
__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_kernel(const float* __restrict__ pre, const float* __restrict__ c_seq,
                const float* __restrict__ c0, const float* __restrict__ dy,
                const float* __restrict__ dc_last,
                const float* __restrict__ w_hh, float* dgates,
                float* __restrict__ dh0, float* __restrict__ dc0,
                unsigned* counter, int B, int T, int H, int U) {
  extern __shared__ __align__(16) float red_s[];
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int H4 = 4 * H;

  // this thread's rows of the CTA's columns, zero past 4H and past nu
  float wc[JM][MAX_UNITS];
#pragma unroll
  for (int m = 0; m < JM; ++m) {
    const int j = m * JCHUNK + threadIdx.x;
#pragma unroll
    for (int u = 0; u < MAX_UNITS; ++u)
      wc[m][u] = (j < H4 && u < nu) ? w_hh[(size_t)j * H + u0 + u] : 0.f;
  }

  // the cell of this thread: unit u0 + cj of sequence cb
  const int cj = threadIdx.x % U;
  const int cb = threadIdx.x / U;
  const bool cell = cj < nu && cb < B;
  const size_t col = (size_t)u0 + cj;
  float dc = (cell && dc_last != nullptr) ? dc_last[(size_t)cb * H + col]
                                          : 0.f;
  const size_t stride = (size_t)T * H4;  // one sequence of dgates
  unsigned barriers = 0;

  for (int t = T - 1; t >= 0; --t) {
    const bool recur = t + 1 < T;
    if (recur) column_products<JM>(wc, dgates + (size_t)(t + 1) * H4, stride,
                                   B, H4, red_s);
    if (cell) {
      const size_t bt = (size_t)cb * T + t;
      float dh = __ldg(dy + bt * H + col);
      if (recur) dh += cell_sum(red_s, cj, cb);
      const float* p = pre + bt * H4 + col;
      const float i = sigmoidf(__ldg(p));
      const float f = sigmoidf(__ldg(p + H));
      const float g = tanhf(__ldg(p + 2 * H));
      const float o = sigmoidf(__ldg(p + 3 * H));
      const float c = __ldg(c_seq + bt * H + col);
      const float cp = t > 0 ? __ldg(c_seq + (bt - 1) * H + col)
                             : (c0 != nullptr ? c0[(size_t)cb * H + col] : 0.f);
      const float tc = tanhf(c);
      dc = fmaf(dh * o, 1.f - tc * tc, dc);
      float* d = dgates + bt * H4 + col;
      d[0] = dc * g * (i * (1.f - i));
      d[H] = dc * cp * (f * (1.f - f));
      d[2 * H] = dc * i * (1.f - g * g);
      d[3 * H] = dh * tc * (o * (1.f - o));
      dc *= f;
      if (t == 0 && dc0 != nullptr) dc0[(size_t)cb * H + col] = dc;
    }
    if (t > 0 || dh0 != nullptr)
      grid_barrier(counter, gridDim.x * ++barriers);
  }
  if (dh0 != nullptr) {
    column_products<JM>(wc, dgates, stride, B, H4, red_s);
    if (cell) dh0[(size_t)cb * H + col] = cell_sum(red_s, cj, cb);
  }
}

template <int JM>
int max_ctas(int B) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lstm_bwd_kernel<JM>, THREADS, smem_bytes(B));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

template <int JM>
int launch(const float* pre, const float* c_seq, const float* c0,
           const float* dy, const float* dc_last, const float* w_hh,
           float* dgates, float* dh0, float* dc0, unsigned* counter, int B,
           int T, int H, int U, int G, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(B);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, lstm_bwd_kernel<JM>, pre, c_seq,
                                       c0, dy, dc_last, w_hh, dgates, dh0,
                                       dc0, counter, B, T, H, U);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int JM>
int attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, lstm_bwd_kernel<JM>);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

bool valid_h(int H) { return H >= 1 && H <= MAX_H; }

bool valid_b(int B) { return B >= 1 && B <= MAX_BATCH; }

}  // namespace

extern "C" {

const char* lstm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Layout constants, for the wrapper's plan and its checks.
int lstm_bwd_threads() { return THREADS; }
int lstm_bwd_max_units() { return MAX_UNITS; }
int lstm_bwd_batch_tile() { return BATCH_TILE; }
int lstm_bwd_max_batch() { return MAX_BATCH; }
int lstm_bwd_max_h() { return MAX_H; }
int lstm_bwd_smem_bytes(int B) {
  return valid_b(B) ? static_cast<int>(smem_bytes(B)) : -1;
}

// How many CTAs of the kernel for H, with a batch of B per launch, the card
// holds at once (negative: a CUDA error).
int lstm_bwd_max_ctas(int H, int B) {
  if (!valid_h(H) || !valid_b(B))
    return -static_cast<int>(cudaErrorInvalidValue);
#define CALL(JM) max_ctas<JM>(B)
  switch (j_chunks(H)) {
    case 1: return CALL(1);
    case 2: return CALL(2);
    case 3: return CALL(3);
    case 4: return CALL(4);
    case 5: return CALL(5);
    case 6: return CALL(6);
    case 7: return CALL(7);
    default: return CALL(8);
  }
#undef CALL
}

// Registers per thread and local (spill) bytes of the kernel for H.
int lstm_bwd_attributes(int H, int* regs, int* local_bytes) {
  if (!valid_h(H)) return cudaErrorInvalidValue;
#define CALL(JM) attributes<JM>(regs, local_bytes)
  switch (j_chunks(H)) {
    case 1: return CALL(1);
    case 2: return CALL(2);
    case 3: return CALL(3);
    case 4: return CALL(4);
    case 5: return CALL(5);
    case 6: return CALL(6);
    case 7: return CALL(7);
    default: return CALL(8);
  }
#undef CALL
}

// pre [B, T, 4H] (the forward's pre-activations), c_seq [B, T, H] (its cell
// states), dy [B, T, H] (the gradient of its h outputs), w_hh [4H, H],
// dgates [B, T, 4H] (out), all contiguous f32; c0 [B, H], the initial cell
// state (null: zero), dc_last [B, H], the gradient of the final c (null:
// zero), dh0 and dc0 [B, H], the gradients of the initial state (null: not
// written); counter: one zeroed uint32 on the device, used by this launch
// only. The plan: G CTAs, CTA g owning units [g*U, g*U+U).
int lstm_bwd_launch(const float* pre, const float* c_seq, const float* c0,
                    const float* dy, const float* dc_last, const float* w_hh,
                    float* dgates, float* dh0, float* dc0, unsigned* counter,
                    int B, int T, int H, int U, int G, void* stream) {
  if (T == 0) return 0;
  if (!valid_h(H) || !valid_b(B) || U < 1 || U > MAX_UNITS || G < 1 ||
      (long long)G * U < H || (long long)(G - 1) * U >= H ||
      counter == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(JM)                                                              \
  launch<JM>(pre, c_seq, c0, dy, dc_last, w_hh, dgates, dh0, dc0, counter, B, \
             T, H, U, G, st)
  switch (j_chunks(H)) {
    case 1: return CALL(1);
    case 2: return CALL(2);
    case 3: return CALL(3);
    case 4: return CALL(4);
    case 5: return CALL(5);
    case 6: return CALL(6);
    case 7: return CALL(7);
    default: return CALL(8);
  }
#undef CALL
}

}  // extern "C"
