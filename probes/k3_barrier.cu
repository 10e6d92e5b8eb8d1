// The step boundary of K3's grid kernels alone, at their launch shape (one
// CTA of 512 threads per SM, cooperative): T steps of nothing but the
// exchange, to time what a step costs before any arithmetic.
//
// mode 0: the arrival-counter barrier alone (__syncthreads; thread 0:
//         __threadfence, atomicAdd, acquire spin; __syncthreads), as
//         PR 8's lstm_grid.cu and lstm_bwd.cu run it;
// mode 1: mode 0, then every CTA reads h_t [B, H] back through L2
//         (ld.global.cg float4) into shared memory: PR 8's forward step
//         boundary;
// mode 2: no barrier: `buf` [T, B, H] starts EMPTY (0xffffffff), each CTA
//         writes its U units of h_t (st.relaxed.gpu) and polls all of h_t
//         (ld.relaxed.gpu float4, 8 in flight per thread) until no word is
//         EMPTY: polling as lstm_grid.cu does below B=10 (it copies with
//         cp.async instead of loads into registers).
// Built and timed by probes/k3_compare.py --barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int IN_FLIGHT = 8;
constexpr unsigned EMPTY = 0xffffffffu;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_poll4(const float* p) {
  float4 v;
  asm volatile("ld.relaxed.gpu.global.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ bool empty4(float4 v) {
  return (__float_as_uint(v.x) == EMPTY) | (__float_as_uint(v.y) == EMPTY) |
         (__float_as_uint(v.z) == EMPTY) | (__float_as_uint(v.w) == EMPTY);
}

__global__ void __launch_bounds__(THREADS, 1)
boundary_kernel(float* buf, unsigned* counter, int mode, int B, int T, int H,
                int U) {
  extern __shared__ __align__(16) float h_s[];
  const int u0 = blockIdx.x * U;
  const int n4 = B * H / 4;
  float sink = 0.f;
  for (int t = 0; t < T; ++t) {
    float* h = buf + (size_t)t * B * H;
    // this CTA's units of h_t
    for (int e = threadIdx.x; e < B * U; e += THREADS) {
      const int b = e / U, u = u0 + e % U;
      if (u < H) {
        float* p = h + (size_t)b * H + u;
        const float v = (float)(t + b);
        asm volatile("st.relaxed.gpu.global.f32 [%0], %1;" :: "l"(p), "f"(v)
                     : "memory");
      }
    }
    if (mode < 2) {
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(counter, 1u);
        const unsigned target = gridDim.x * (unsigned)(t + 1);
        for (uint32_t i = 0; ld_acquire(counter) < target; ++i)
          if (i == (1u << 24)) __trap();
      }
      __syncthreads();
      if (mode == 1) {
        for (int e = threadIdx.x; e < n4; e += THREADS)
          reinterpret_cast<float4*>(h_s)[e] =
              __ldcg(reinterpret_cast<const float4*>(h) + e);
        __syncthreads();
        sink += h_s[threadIdx.x % (B * H)];
      }
    } else {
      for (int e0 = threadIdx.x; e0 < n4; e0 += THREADS * IN_FLIGHT) {
        float4 v[IN_FLIGHT];
#pragma unroll
        for (int j = 0; j < IN_FLIGHT; ++j)
          if (e0 + j * THREADS < n4)
            v[j] = ld_poll4(h + 4 * (e0 + j * THREADS));
        for (uint32_t spin = 0;; ++spin) {
          bool waiting = false;
#pragma unroll
          for (int j = 0; j < IN_FLIGHT; ++j) {
            const int e = e0 + j * THREADS;
            if (e < n4 && empty4(v[j])) {
              waiting = true;
              v[j] = ld_poll4(h + 4 * e);
            }
          }
          if (!waiting) break;
          if (spin == (1u << 24)) __trap();
        }
#pragma unroll
        for (int j = 0; j < IN_FLIGHT; ++j)
          if (e0 + j * THREADS < n4)
            reinterpret_cast<float4*>(h_s)[e0 + j * THREADS] = v[j];
      }
      __syncthreads();
      sink += h_s[threadIdx.x % (B * H)];
      __syncthreads();
    }
  }
  if (sink == -1.f) buf[0] = sink;  // keep the reads
}

}  // namespace

extern "C" {

// buf: T x B x H floats (mode 2: filled with EMPTY here first); counter:
// one zeroed uint32. G CTAs of U units each.
int k3_boundary_launch(float* buf, unsigned* counter, int mode, int B, int T,
                       int H, int U, int G, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)B * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      boundary_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (mode == 2) {
    err = cudaMemsetAsync(buf, 0xff, (size_t)T * B * H * sizeof(float), st);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, boundary_kernel, buf, counter, mode, B, T, H,
                           U);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
