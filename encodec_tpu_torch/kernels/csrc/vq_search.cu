// RVQ codebook search for Hopper (sm_90a): K1 and K2 of the port.
//
// K1 `vq_nearest_launch` replaces encodec_tpu/kernels/vq_pallas.py
//    nearest_codebook_pallas (body _nearest_kernel): per row of x [N, D],
//    idx = argmax_j -(|x|^2 - 2 x.e_j + |e_j|^2), first max wins. It also
//    returns margin = best - max_{j != idx}, the top-2 gap the container
//    writer's near-tie guard reads (encodec_tpu/quant/rvq.py
//    rvq_encode_margins).
// K2 `vq_rvq_launch` replaces vq_pallas.py rvq_encode_pallas (body
//    _rvq_kernel): all n_q stages in one launch; the residual tile stays in
//    shared memory across stages, stage k searches book k (book 0 when
//    shared), writes codes[k], then applies the exact update r -= E_k[idx].
//
// What bounds it: 2*N*bins*D FP32 FMAs per stage against N*D + bins*D
// floats of input, so at the 24 kHz shapes (D=128, bins=1024) it is
// compute-bound on the FP32 pipes (not the tensor cores: the indices must
// match an IEEE f32 dot, which TF32/bf16 do not give). The [N, bins]
// distance matrix never reaches device memory.
//
// Design: one CTA owns TILE_N=16 rows (8 warps x 2 rows) held in shared
// memory, and streams the book through shared memory in tiles of 64 bins.
// Each lane keeps a register block of 2 rows x 2 bins of FFMA dot products
// and a running (best, idx, second) per row; a new value replaces the best
// only when strictly greater, so the lowest index wins. Lanes then merge
// across the warp by shuffles, breaking ties by the lower index. Rows are
// padded by one float so the 32 lanes of a warp read 32 distinct banks.
// K2 reads the E_k[idx] rows for the residual update straight from global
// memory / L2 (the whole 24 kHz book set, 16 MiB, fits in the 50 MB L2).
// Simple first version: no wgmma/TMA; the D-loop does one shared load per
// FFMA, so it runs well below the FP32 peak (see PERF.md).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TX = 32;            // lanes over bins
constexpr int TY = 8;             // warps per CTA
constexpr int RM = 2;             // rows per warp
constexpr int BN = 2;             // bins per lane per tile
constexpr int TILE_N = TY * RM;   // rows per CTA
constexpr int TILE_B = TX * BN;   // bins per shared-memory tile
constexpr int THREADS = TX * TY;

struct Best {
  float best;
  int idx;
  float second;
};

__device__ __forceinline__ void push(Best& s, float v, int j) {
  // values arrive in increasing j: strictly greater replaces (first max
  // wins); an equal or smaller value can only raise the runner-up
  if (v > s.best) {
    s.second = s.best;
    s.best = v;
    s.idx = j;
  } else {
    s.second = fmaxf(s.second, v);
  }
}

__device__ __forceinline__ void merge(Best& a, float b_best, int b_idx,
                                      float b_second) {
  // a and b cover disjoint bins; the winner's runner-up is the larger of
  // its own runner-up and the loser's best (an exact tie leaves second ==
  // best, i.e. margin 0, like the reference's masked max)
  const bool take = (b_best > a.best) || (b_best == a.best && b_idx < a.idx);
  if (take) {
    a.second = fmaxf(b_second, a.best);
    a.best = b_best;
    a.idx = b_idx;
  } else {
    a.second = fmaxf(a.second, b_best);
  }
}

__host__ __device__ constexpr size_t smem_floats(int D) {
  return (size_t)(TILE_N + TILE_B) * (D + 1) + TILE_N;
}

// Search `book` [bins, D] for the TILE_N rows in xs (shared, stride D+1).
// Warp w owns rows w*RM .. w*RM+RM-1; on return every lane of the warp
// holds their merged results.
__device__ void search(const float* __restrict__ book, int bins, int D,
                       const float* xs, float* es, Best (&st)[RM]) {
  const int lane = threadIdx.x % TX;
  const int warp = threadIdx.x / TX;
  const int ld = D + 1;

  __syncthreads();  // xs complete (loaded or updated by the caller)
  float xsq[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float* xr = xs + (warp * RM + i) * ld;
    float s = 0.f;
    for (int d = lane; d < D; d += TX) s = fmaf(xr[d], xr[d], s);
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    xsq[i] = s;
    st[i].best = -CUDART_INF_F;
    st[i].idx = 0;
    st[i].second = -CUDART_INF_F;
  }

  for (int b0 = 0; b0 < bins; b0 += TILE_B) {
    __syncthreads();  // previous tile fully consumed
    for (int e = threadIdx.x; e < TILE_B * D; e += THREADS) {
      const int r = e / D;
      const int d = e - r * D;
      es[r * ld + d] = (b0 + r < bins) ? book[(size_t)(b0 + r) * D + d] : 0.f;
    }
    __syncthreads();

    float acc[RM][BN];
    float esq[BN];
#pragma unroll
    for (int q = 0; q < BN; ++q) {
      esq[q] = 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i) acc[i][q] = 0.f;
    }
    for (int d = 0; d < D; ++d) {
      float ev[BN];
      float xv[RM];
#pragma unroll
      for (int q = 0; q < BN; ++q) ev[q] = es[(lane + q * TX) * ld + d];
#pragma unroll
      for (int i = 0; i < RM; ++i) xv[i] = xs[(warp * RM + i) * ld + d];
#pragma unroll
      for (int q = 0; q < BN; ++q) {
        esq[q] = fmaf(ev[q], ev[q], esq[q]);
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][q] = fmaf(xv[i], ev[q], acc[i][q]);
      }
    }
#pragma unroll
    for (int q = 0; q < BN; ++q) {
      const int j = b0 + lane + q * TX;
      if (j < bins) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          // the reference association order: -((|x|^2 - 2 x.e) + |e|^2)
          const float v = -((xsq[i] - 2.f * acc[i][q]) + esq[q]);
          push(st[i], v, j);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, st[i].best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, st[i].idx, off);
      const float os = __shfl_xor_sync(0xffffffffu, st[i].second, off);
      merge(st[i], ob, oi, os);
    }
  }
}

__device__ void load_rows(const float* __restrict__ x, int N, int D, int n0,
                          float* xs) {
  const int ld = D + 1;
  for (int e = threadIdx.x; e < TILE_N * D; e += THREADS) {
    const int r = e / D;
    const int d = e - r * D;
    xs[r * ld + d] = (n0 + r < N) ? x[(size_t)(n0 + r) * D + d] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
vq_nearest_kernel(const float* __restrict__ x, const float* __restrict__ book,
                  int N, int bins, int D, int* __restrict__ idx_out,
                  float* __restrict__ margin_out) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* es = xs + TILE_N * (D + 1);
  const int n0 = blockIdx.x * TILE_N;
  load_rows(x, N, D, n0, xs);
  Best st[RM];
  search(book, bins, D, xs, es, st);
  const int lane = threadIdx.x % TX;
  const int warp = threadIdx.x / TX;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = n0 + warp * RM + i;
      if (row < N) {
        idx_out[row] = st[i].idx;
        margin_out[row] = st[i].best - st[i].second;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
vq_rvq_kernel(const float* __restrict__ x, const float* __restrict__ books,
              int N, int bins, int D, int n_q, int shared,
              int* __restrict__ codes) {
  extern __shared__ float smem[];
  float* xs = smem;                                  // residual tile
  float* es = xs + TILE_N * (D + 1);
  int* idx_s = reinterpret_cast<int*>(es + TILE_B * (D + 1));
  const int ld = D + 1;
  const int n0 = blockIdx.x * TILE_N;
  const int lane = threadIdx.x % TX;
  const int warp = threadIdx.x / TX;
  load_rows(x, N, D, n0, xs);
  for (int k = 0; k < n_q; ++k) {
    const float* book = books + (size_t)(shared ? 0 : k) * bins * D;
    Best st[RM];
    search(book, bins, D, xs, es, st);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = warp * RM + i;
        idx_s[r] = st[i].idx;
        if (n0 + r < N) codes[(size_t)k * N + n0 + r] = st[i].idx;
      }
    }
    __syncthreads();
    // exact residual update r -= E_k[idx], rows read from global / L2
    for (int e = threadIdx.x; e < TILE_N * D; e += THREADS) {
      const int r = e / D;
      const int d = e - r * D;
      if (n0 + r < N) xs[r * ld + d] -= book[(size_t)idx_s[r] * D + d];
    }
  }
}

}  // namespace

extern "C" {

const char* vq_search_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int vq_nearest_launch(const float* x, const float* book, int N, int bins,
                      int D, int* idx_out, float* margin_out, void* stream) {
  if (N == 0) return 0;
  const int smem = static_cast<int>(smem_floats(D) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      vq_nearest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TILE_N - 1) / TILE_N);
  vq_nearest_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, book, N, bins, D, idx_out, margin_out);
  return cudaGetLastError();
}

int vq_rvq_launch(const float* x, const float* books, int N, int bins, int D,
                  int n_q, int shared, int* codes, void* stream) {
  if (N == 0 || n_q == 0) return 0;
  const int smem = static_cast<int>(smem_floats(D) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      vq_rvq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TILE_N - 1) / TILE_N);
  vq_rvq_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, books, N, bins, D, n_q, shared, codes);
  return cudaGetLastError();
}

}  // extern "C"
