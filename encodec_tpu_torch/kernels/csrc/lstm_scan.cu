// LSTM recurrence for Hopper (sm_90a): K3 of the port.
//
// Replaces encodec_tpu/kernels/lstm_pallas.py lstm_scan_pallas (body
// _scan_kernel): one LSTM layer's recurrence from zero state over gate
// inputs xp [B, T, 4H] (= x W_ih^T + b_ih + b_hh, computed before the
// scan), gate order i, f, g, o:
//   gates_t = xp_t + h_{t-1} W_hh^T
//   c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g),  h_t = sigmoid(o) tanh(c_t)
// Output h [B, T, H].
//
// What bounds it: the T-step dependency chain, not FLOPs or bytes (at the
// 24 kHz shapes 2*B*T*H*4H FLOPs and ~12 MB run in tens of microseconds at
// peak). Each step needs all of h_{t-1}, so the time is T x (one step's
// latency), and W_hh (4 MiB at H=512) is too large for one SM.
//
// Design: a persistent cooperative grid split by hidden unit. CTA c owns
// units [c*U, c*U+U) and keeps their 4U rows of W_hh (i, f, g, o) resident
// in shared memory for the whole sequence (32 KiB at U=4, H=512), and their
// cell state c in shared memory. Only h crosses CTAs: step t writes its h
// slice into out[:, t, :], and after one grid-wide barrier every CTA reads
// the full h_{t-1} row back from out[:, t-1, :] (through L2, bypassing the
// non-coherent L1). The launch is cudaLaunchCooperativeKernel, so a grid
// that cannot be co-resident fails loudly instead of deadlocking in the
// barrier. The barrier is a monotonically increasing arrival counter: the
// wait after step t ends once it reaches gridDim.x * (t + 1).
// The per-step dot products run one warp per (gate row, batch item) with
// FFMA partial sums and a shuffle reduction; gate inputs of step t are
// fetched before the dot products so their latency overlaps them.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CELLS = THREADS;  // U * B cells updated by one CTA

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void grid_barrier(unsigned int* counter,
                                             unsigned int target) {
  __threadfence();   // this thread's h writes are visible device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(counter, 1u);
    while (load_acquire(counter) < target) {
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

__global__ void __launch_bounds__(THREADS)
lstm_scan_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
                 float* out, unsigned int* counter, int B, int T, int H,
                 int U) {
  extern __shared__ float smem[];
  const int R = 4 * U;
  float* w_s = smem;              // [R, H]: row g*U + j = W_hh[g*H + u0 + j]
  float* h_s = w_s + R * H;       // [B, H]: h_{t-1}
  float* g_s = h_s + B * H;       // [R, B]: recurrent gate terms
  float* c_s = g_s + R * B;       // [U, B]: cell state
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int H4 = 4 * H;

  for (int e = threadIdx.x; e < R * H; e += THREADS) {
    const int r = e / H;
    const int k = e - r * H;
    const int g = r / U;
    const int j = r - g * U;
    w_s[e] = (j < nu) ? w_hh[(size_t)(g * H + u0 + j) * H + k] : 0.f;
  }
  for (int e = threadIdx.x; e < U * B; e += THREADS) c_s[e] = 0.f;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = THREADS / 32;
  // the cell this thread updates (if any): unit j, batch item b
  const int cell = threadIdx.x;
  const bool has_cell = cell < nu * B;
  const int cj = has_cell ? cell % nu : 0;
  const int cb = has_cell ? cell / nu : 0;

  for (int t = 0; t < T; ++t) {
    float xg[4] = {0.f, 0.f, 0.f, 0.f};
    if (has_cell) {
      const float* xrow = xp + ((size_t)cb * T + t) * H4 + u0 + cj;
#pragma unroll
      for (int g = 0; g < 4; ++g) xg[g] = xrow[g * H];
    }
    if (t == 0) {
      for (int e = threadIdx.x; e < B * H; e += THREADS) h_s[e] = 0.f;
    } else {
      for (int e = threadIdx.x; e < B * H; e += THREADS) {
        const int b = e / H;
        const int k = e - b * H;
        h_s[e] = __ldcg(out + ((size_t)b * T + (t - 1)) * H + k);
      }
    }
    __syncthreads();

    for (int d = warp; d < R * B; d += nwarps) {
      const int r = d / B;
      const int b = d - r * B;
      const float* wr = w_s + r * H;
      const float* hb = h_s + b * H;
      float acc = 0.f;
      for (int k = lane; k < H; k += 32) acc = fmaf(wr[k], hb[k], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) g_s[r * B + b] = acc;
    }
    __syncthreads();

    if (has_cell) {
      const float gi = xg[0] + g_s[(0 * U + cj) * B + cb];
      const float gf = xg[1] + g_s[(1 * U + cj) * B + cb];
      const float gg = xg[2] + g_s[(2 * U + cj) * B + cb];
      const float go = xg[3] + g_s[(3 * U + cj) * B + cb];
      const float c = sigmoidf(gf) * c_s[cj * B + cb] + sigmoidf(gi) * tanhf(gg);
      c_s[cj * B + cb] = c;
      out[((size_t)cb * T + t) * H + u0 + cj] = sigmoidf(go) * tanhf(c);
    }
    if (t + 1 < T) grid_barrier(counter, gridDim.x * (unsigned int)(t + 1));
  }
}

}  // namespace

extern "C" {

const char* lstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int lstm_scan_max_cells() { return MAX_CELLS; }

// xp [B, T, 4H], w_hh [4H, H], out [B, T, H] (all contiguous f32);
// counter: one zeroed uint32 on the device. U units per CTA.
int lstm_scan_launch(const float* xp, const float* w_hh, float* out,
                     unsigned int* counter, int B, int T, int H, int U,
                     void* stream) {
  if (B == 0 || T == 0) return 0;
  if (U < 1 || U * B > MAX_CELLS) return cudaErrorInvalidValue;
  const int R = 4 * U;
  const int smem = static_cast<int>(
      ((size_t)R * H + (size_t)B * H + (size_t)R * B + (size_t)U * B) *
      sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      lstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + U - 1) / U);
  void* args[] = {(void*)&xp, (void*)&w_hh, (void*)&out, (void*)&counter,
                  (void*)&B,  (void*)&T,    (void*)&H,   (void*)&U};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lstm_scan_kernel),
                                    grid, dim3(THREADS), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
