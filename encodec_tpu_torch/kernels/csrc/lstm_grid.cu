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
// MiB, which no 16-CTA cluster can hold (16 SMs of 256 KB registers and
// 228 KB shared memory), and streaming it from L2 every step would move 16
// MiB per step. So W_hh is spread over the whole card and held there for
// the launch, and h crosses SMs through L2 once per step.
//
// Design: a persistent grid of G CTAs, one per SM, launched cooperatively
// (cudaLaunchAttributeCooperative: a grid the card cannot hold at once
// fails at launch instead of hanging in the barrier).
// - CTA g owns hidden units [g*U, g*U+U), U = ceil(H / SMs) <= 8 (H=1024:
//   U=8, G=128), and their 4U gate rows of W_hh stay in registers for the
//   whole launch: 16 warps x 2 rows, a float4 per lane per 128 k (64
//   registers per thread at H=1024). CTA row q = g'*U + j is gate g' of
//   unit u0 + j.
// - Each step every CTA computes its rows for all B sequences, so W_hh is
//   read once per step whatever B is: h_{t-1} of every sequence is staged
//   in shared memory ([Bp][HP], zero-padded), each lane accumulates 2 rows
//   x 8 sequences over its k slice, and a butterfly of 16 shuffles leaves
//   lane l with the sum of value l >> 1. The sums go to shared memory,
//   where the thread of cell (unit j, sequence b) reads its unit's four
//   gates and keeps c in a register (U*B <= 512 cells, one per thread).
// - h is exchanged through `out` itself: step t writes h_t into out[:, t],
//   and step t+1 reads out[:, t] back (ld.global.cg: L2, not the
//   non-coherent L1). Nothing is overwritten, so one grid barrier per step
//   suffices. The barrier is a monotonically increasing arrival counter
//   (zeroed by the caller): after step t every CTA adds one and waits
//   until it reads G*(t+1) with acquire semantics, as cooperative groups'
//   grid sync does. A bounded spin turns a lost arrival into a kernel fault.
// - Gate inputs of step t+1 are loaded before the barrier of step t, so
//   their latency hides behind it.
// - The batch per launch is bounded by shared memory (h of every sequence)
//   and by one cell per thread: at most 64, 48 at H=1024; the caller
//   splits a larger batch over launches (sequences are independent, and a
//   sequence's arithmetic does not depend on its slot).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;                  // 512
constexpr int ROWS_PER_WARP = 2;
constexpr int MAX_ROWS = WARPS * ROWS_PER_WARP;      // 32 gate rows per CTA
constexpr int MAX_UNITS = MAX_ROWS / 4;              // 8 units per CTA
constexpr int KCHUNK = 128;                          // k per float4 x 32
constexpr int MIN_KM = 5;                            // H > 512
constexpr int MAX_KM = 8;                            // H <= 1024
constexpr int BATCH_TILE = 8;                        // sequences per pass
constexpr int VALUES = ROWS_PER_WARP * BATCH_TILE;   // 16 sums per lane
constexpr int MAX_BATCH = THREADS / MAX_UNITS;       // 64: a cell a thread
constexpr int SMEM_LIMIT = 232448;                   // per block, sm_90

__host__ __device__ constexpr int k_chunks(int H) {
  return (H + KCHUNK - 1) / KCHUNK;
}

__host__ __device__ constexpr int padded_batch(int B) {
  return (B + BATCH_TILE - 1) / BATCH_TILE * BATCH_TILE;
}

// h of every sequence [Bp][HP] and the recurrent gate sums [MAX_ROWS][Bp]
__host__ __device__ constexpr size_t smem_bytes(int H, int B) {
  return (size_t)padded_batch(B) * (k_chunks(H) * KCHUNK + MAX_ROWS) *
         sizeof(float);
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

template <int KM>
__global__ void __launch_bounds__(THREADS, 1)
lstm_grid_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
                 const float* __restrict__ h0, const float* __restrict__ c0,
                 float* out, float* __restrict__ c_out, unsigned* counter,
                 int B, int T, int H, int U, int vec) {
  constexpr int HP = KM * KCHUNK;
  extern __shared__ __align__(16) float smem[];
  const int Bp = padded_batch(B);
  float* h_s = smem;                         // [Bp][HP]: h_{t-1}, zero pad
  float* g_s = h_s + (size_t)Bp * HP;        // [MAX_ROWS][Bp]: row sums

  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int R = 4 * U;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int H4 = 4 * H;
  const bool stateful = h0 != nullptr;
  const bool busy = ROWS_PER_WARP * warp < R;  // R is even: both rows valid

  // this warp's W_hh rows, zero past H and for units past the CTA's last
  float4 wr[ROWS_PER_WARP][KM];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int q = ROWS_PER_WARP * warp + r;
    const float* row = (q < R && q % U < nu)
        ? w_hh + (size_t)((q / U) * H + u0 + q % U) * H : nullptr;
#pragma unroll
    for (int m = 0; m < KM; ++m) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = m * KCHUNK + 4 * lane + e;
        v[e] = (row != nullptr && k < H) ? row[k] : 0.f;
      }
      wr[r][m] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  for (int e = threadIdx.x; e < Bp * (HP + MAX_ROWS); e += THREADS)
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

  for (int t = 0; t < T; ++t) {
    // zero state: the recurrent term of step 0 is 0
    const bool recur = t > 0 || stateful;
    if (recur) {
      // h_{t-1} of every sequence into shared memory: h0 at step 0, else
      // what every CTA wrote into out[:, t-1] before the last barrier
      if (vec) {
        const int n4 = H / 4;
        for (int e = threadIdx.x; e < B * n4; e += THREADS) {
          const int b = e / n4;
          const int k4 = e - b * n4;
          const float4 v = t == 0
              ? reinterpret_cast<const float4*>(h0 + (size_t)b * H)[k4]
              : __ldcg(reinterpret_cast<const float4*>(
                    out + ((size_t)b * T + t - 1) * H) + k4);
          *reinterpret_cast<float4*>(h_s + (size_t)b * HP + 4 * k4) = v;
        }
      } else {
        for (int e = threadIdx.x; e < B * H; e += THREADS) {
          const int b = e / H;
          const int k = e - b * H;
          h_s[(size_t)b * HP + k] = t == 0
              ? h0[(size_t)b * H + k]
              : __ldcg(out + ((size_t)b * T + t - 1) * H + k);
        }
      }
      __syncthreads();
      if (busy) {
        for (int b0 = 0; b0 < Bp; b0 += BATCH_TILE) {
          float acc[VALUES];  // acc[r * BATCH_TILE + i]: row r, sequence b0+i
#pragma unroll
          for (int v = 0; v < VALUES; ++v) acc[v] = 0.f;
#pragma unroll
          for (int m = 0; m < KM; ++m) {
            const int k = m * KCHUNK + 4 * lane;
#pragma unroll
            for (int i = 0; i < BATCH_TILE; ++i) {
              const float4 h4 = *reinterpret_cast<const float4*>(
                  h_s + (size_t)(b0 + i) * HP + k);
#pragma unroll
              for (int r = 0; r < ROWS_PER_WARP; ++r)
                acc[r * BATCH_TILE + i] = dot4(wr[r][m], h4,
                                               acc[r * BATCH_TILE + i]);
            }
          }
          // butterfly: 16 sums x 32 lanes -> lane l holds sum l >> 1
          fold<8>(acc, lane);
          fold<4>(acc, lane);
          fold<2>(acc, lane);
          fold<1>(acc, lane);
          const float v = acc[0] + __shfl_xor_sync(0xffffffffu, acc[0], 1);
          if ((lane & 1) == 0) {
            const int i = lane >> 1;
            const int q = ROWS_PER_WARP * warp + i / BATCH_TILE;
            g_s[(size_t)q * Bp + b0 + i % BATCH_TILE] = v;
          }
        }
      }
      __syncthreads();
    }
    if (cell) {
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        gate[g] = xg[g] + (recur ? g_s[(size_t)(g * U + cj) * Bp + cb] : 0.f);
      c = sigmoidf(gate[1]) * c + sigmoidf(gate[0]) * tanhf(gate[2]);
      const float h = sigmoidf(gate[3]) * tanhf(c);
      out[((size_t)cb * T + t) * H + u0 + cj] = h;
      if (t == T - 1 && c_out != nullptr) c_out[(size_t)cb * H + u0 + cj] = c;
      if (t + 1 < T) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          xg[g] = __ldg(xrow + (size_t)(t + 1) * H4 + g * H);
      }
    }
    if (t + 1 < T) grid_barrier(counter, gridDim.x * (unsigned)(t + 1));
  }
}

template <int KM>
cudaError_t prepare(int H, int B) {
  return cudaFuncSetAttribute(lstm_grid_kernel<KM>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(H, B)));
}

template <int KM>
int max_ctas(int H, int B) {
  cudaError_t err = prepare<KM>(H, B);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lstm_grid_kernel<KM>, THREADS, smem_bytes(H, B));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

template <int KM>
int launch(const float* xp, const float* w_hh, const float* h0,
           const float* c0, float* out, float* c_out, unsigned* counter,
           int B, int T, int H, int U, int G, cudaStream_t stream) {
  cudaError_t err = prepare<KM>(H, B);
  if (err != cudaSuccess) return err;
  // float4 h loads need 16-byte rows
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
  err = cudaLaunchKernelEx(&cfg, lstm_grid_kernel<KM>, xp, w_hh, h0, c0, out,
                           c_out, counter, B, T, H, U, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int KM>
int attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, lstm_grid_kernel<KM>);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

bool valid_h(int H) {
  return H > (MIN_KM - 1) * KCHUNK && H <= MAX_KM * KCHUNK;
}

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
int lstm_grid_batch_tile() { return BATCH_TILE; }
int lstm_grid_max_batch() { return MAX_BATCH; }
int lstm_grid_max_h() { return MAX_KM * KCHUNK; }
int lstm_grid_smem_bytes(int H, int B) {
  return valid_h(H) && valid_b(H, B) ? static_cast<int>(smem_bytes(H, B))
                                     : -1;
}

// How many CTAs of the kernel for H, with a batch of B per launch, the card
// holds at once (negative: a CUDA error).
int lstm_grid_max_ctas(int H, int B) {
  if (!valid_h(H) || !valid_b(H, B))
    return -static_cast<int>(cudaErrorInvalidValue);
  switch (k_chunks(H)) {
    case 5: return max_ctas<5>(H, B);
    case 6: return max_ctas<6>(H, B);
    case 7: return max_ctas<7>(H, B);
    default: return max_ctas<8>(H, B);
  }
}

// Registers per thread and local (spill) bytes of the kernel for H.
int lstm_grid_attributes(int H, int* regs, int* local_bytes) {
  if (!valid_h(H)) return cudaErrorInvalidValue;
  switch (k_chunks(H)) {
    case 5: return attributes<5>(regs, local_bytes);
    case 6: return attributes<6>(regs, local_bytes);
    case 7: return attributes<7>(regs, local_bytes);
    default: return attributes<8>(regs, local_bytes);
  }
}

// xp [B, T, 4H], w_hh [4H, H], out [B, T, H] (all contiguous f32); h0 and
// c0 [B, H], the initial state (both null: zero state), and c_out [B, H],
// the final cell state (null: not written); counter: one zeroed uint32 on
// the device, used by this launch only. The plan: G CTAs, CTA g owning
// units [g*U, g*U+U).
int lstm_grid_launch(const float* xp, const float* w_hh, const float* h0,
                     const float* c0, float* out, float* c_out,
                     unsigned* counter, int B, int T, int H, int U, int G,
                     void* stream) {
  if (T == 0) return 0;
  if (!valid_h(H) || !valid_b(H, B) || U < 1 || U > MAX_UNITS || G < 1 ||
      (long long)G * U < H || (long long)(G - 1) * U >= H ||
      counter == nullptr || (h0 == nullptr) != (c0 == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k_chunks(H)) {
    case 5:
      return launch<5>(xp, w_hh, h0, c0, out, c_out, counter, B, T, H, U, G,
                       st);
    case 6:
      return launch<6>(xp, w_hh, h0, c0, out, c_out, counter, B, T, H, U, G,
                       st);
    case 7:
      return launch<7>(xp, w_hh, h0, c0, out, c_out, counter, B, T, H, U, G,
                       st);
    default:
      return launch<8>(xp, w_hh, h0, c0, out, c_out, counter, B, T, H, U, G,
                       st);
  }
}

}  // extern "C"
