// RVQ codebook search for Hopper (sm_90a): K1 and K2 of the port.
//
// K1 `vq_nearest_launch` replaces encodec_tpu/kernels/vq_pallas.py:43
//    nearest_codebook_pallas (body _nearest_kernel): per row of x [N, D],
//    idx = argmax_j -(|x|^2 - 2 x.e_j + |e_j|^2), first max wins. It also
//    returns margin = best - max_{j != idx}, the top-2 gap the container
//    writer's near-tie guard reads (encodec_tpu/quant/rvq.py
//    rvq_encode_margins).
// K2 `vq_rvq_launch` replaces vq_pallas.py:124 rvq_encode_pallas (body
//    _rvq_kernel): all n_q stages in one launch; the residual tile stays in
//    shared memory across stages, stage k searches book k (book 0 when
//    shared), writes codes[k], then applies the exact update r -= E_k[idx].
//
// What bounds them: 2*N*bins*D FP32 FMAs per stage against N*D + bins*D
// floats of input, so at the 24 kHz shapes (D=128, bins=1024) the work is
// compute-bound on the FP32 pipes (not the tensor cores: the indices must
// match an IEEE f32 dot, which TF32/bf16 do not give, and the .ecdc tie
// guard's 1e-3 threshold is the cross-writer contract). The [N, bins]
// distance matrix never reaches device memory. At the main path's N=750
// (one stage of a 10 s request) the FLOPs take ~3 us at peak, so what
// bounds a launch in practice is how much of the card it fills.
//
// K1 design (cluster split-bins search):
// - A thread-block cluster of C CTAs (C <= 8, chosen by the wrapper's plan)
//   shares one tile of 32 rows; CTA r of the cluster searches only bins
//   [r*per_cta, (r+1)*per_cta). The plan takes the largest C that keeps the
//   grid within one wave of CTA slots (2 per SM, set by shared memory): at
//   N=750, bins=1024 that is 24 tiles x 8 = 192 CTAs; at N=3000, 94 x 2.
// - 128 threads; thread (row group rg, bin group bg) keeps a 4 rows x 4
//   bins register tile of FFMA dot products (rows rg*4+i, bins bg+16*q of
//   a 64-bin stage), fed by 16-byte (float4) shared loads: 8 LDS.128 per
//   64 FFMAs (plus 16 for |e|^2).
//   Rows are padded to a stride of 4*odd floats, so the 8 lanes of each
//   LDS.128 phase hit 8 distinct 16-byte bank groups.
// - The book slice streams through a two-stage ring of 64-bin tiles filled
//   by cp.async (16-byte copies when D % 4 == 0 and the rows are aligned,
//   else 4-byte ones); tile t+1 lands while tile t is computed.
// - Each thread keeps a running (best, idx, second) per row in increasing
//   j, where only a strictly greater value replaces the best; shuffles
//   merge the 16 bin groups of a row, then CTA r merges rows r, r+C, ...
//   over the cluster's partial results read through distributed shared
//   memory. Every merge breaks an exact tie by the lower index, and the
//   loser's best becomes the winner's runner-up, so duplicate rows in
//   different CTAs' bin ranges give the lowest index and margin 0, as
//   `argmax` and the reference's masked max do.
//
// K2 design: one CTA owns TILE_N=16 rows (8
// warps x 2 rows) held in shared memory and streams each book through
// shared memory in tiles of 64 bins, a 2 rows x 2 bins register block per
// lane and one shared load per FFMA; E_k[idx] rows for the residual update
// are read from global memory / L2 (the 24 kHz book set, 16 MiB, fits in
// the 50 MB L2).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

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

// ---------------------------------------------------------------- K1 ----

constexpr int K1_ROWS = 32;                     // rows per cluster tile
constexpr int K1_TILE_B = 64;                   // bins per ring stage
constexpr int K1_RM = 4;                        // rows per thread
constexpr int K1_BN = 4;                        // bins per thread
constexpr int K1_BG = K1_TILE_B / K1_BN;        // bin groups (16 lanes)
constexpr int K1_RG = K1_ROWS / K1_RM;          // row groups
constexpr int K1_THREADS = K1_BG * K1_RG;       // 128
constexpr int K1_STAGES = 2;
constexpr int K1_MAX_CLUSTER = 8;               // portable cluster size

// shared row stride: D rounded up to 4, then to 4 * (an odd number)
__host__ __device__ constexpr int k1_ld(int D) {
  return 4 * ((((D + 3) / 4) + 1) | 1);
}

__host__ __device__ constexpr size_t k1_smem_bytes(int D) {
  return ((size_t)(K1_ROWS + K1_STAGES * K1_TILE_B) * k1_ld(D) +
          4 * K1_ROWS) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// generic address of `p` (this CTA's shared memory) in cluster CTA `rank`
template <typename T>
__device__ __forceinline__ T* map_rank(T* p, unsigned rank) {
  T* out;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(out) : "l"(p), "r"(rank));
  return out;
}

// Copy `n` rows of length D from global `src` (row stride D) into shared
// `dst` (row stride ld) with cp.async; columns >= D are left alone.
__device__ __forceinline__ void k1_copy_rows(float* dst, const float* src,
                                             int n, int D, int ld,
                                             bool vec16) {
  if (vec16) {
    const int c4 = D / 4;
    for (int e = threadIdx.x; e < n * c4; e += K1_THREADS) {
      const int r = e / c4;
      const int c = e - r * c4;
      cp_async16(dst + r * ld + 4 * c, src + (size_t)r * D + 4 * c);
    }
  } else {
    for (int e = threadIdx.x; e < n * D; e += K1_THREADS) {
      const int r = e / D;
      const int c = e - r * D;
      cp_async4(dst + r * ld + c, src + (size_t)r * D + c);
    }
  }
}

__global__ void __launch_bounds__(K1_THREADS)
vq_nearest_kernel(const float* __restrict__ x, const float* __restrict__ book,
                  int N, int bins, int D, int per_cta, int vec16,
                  int* __restrict__ idx_out, float* __restrict__ margin_out) {
  extern __shared__ __align__(16) float smem[];
  const int ld = k1_ld(D);
  const int Dp = (D + 3) & ~3;
  float* xs = smem;                                  // [K1_ROWS][ld]
  float* es = xs + K1_ROWS * ld;                     // [STAGES][TILE_B][ld]
  float* xsq_s = es + K1_STAGES * K1_TILE_B * ld;    // [K1_ROWS]
  float* part_best = xsq_s + K1_ROWS;                // [K1_ROWS] each
  int* part_idx = reinterpret_cast<int*>(part_best + K1_ROWS);
  float* part_second = part_best + 2 * K1_ROWS;

  const unsigned rank = cluster_rank();
  const unsigned csize = cluster_size();
  const int n0 = (blockIdx.x / csize) * K1_ROWS;
  const int nrows = min(K1_ROWS, N - n0);
  const int j0 = (int)rank * per_cta;
  const int j1 = min(bins, j0 + per_cta);
  const int ntiles = (j1 - j0 + K1_TILE_B - 1) / K1_TILE_B;
  const int tid = threadIdx.x;
  const int bg = tid % K1_BG;
  const int rg = tid / K1_BG;

  // zero what cp.async never writes: pad columns of every row, and whole
  // rows past N (their results are never stored)
  const int pad = ld - D;
  for (int e = tid; e < (K1_ROWS + K1_STAGES * K1_TILE_B) * pad;
       e += K1_THREADS) {
    const int r = e / pad;
    smem[r * ld + D + (e - r * pad)] = 0.f;
  }
  for (int e = tid; e < (K1_ROWS - nrows) * D; e += K1_THREADS) {
    const int r = nrows + e / D;
    xs[r * ld + e % D] = 0.f;
  }

  // group 0: the row tile and book tile 0; group 1: book tile 1 (or empty)
  k1_copy_rows(xs, x + (size_t)n0 * D, nrows, D, ld, vec16);
#pragma unroll
  for (int s = 0; s < K1_STAGES; ++s) {
    if (s < ntiles) {
      const int b = j0 + s * K1_TILE_B;
      k1_copy_rows(es + s * K1_TILE_B * ld, book + (size_t)b * D,
                   min(K1_TILE_B, j1 - b), D, ld, vec16);
    }
    cp_async_commit();
  }

  Best st[K1_RM];
  float xsq[K1_RM];
#pragma unroll
  for (int i = 0; i < K1_RM; ++i) {
    st[i].best = -CUDART_INF_F;
    st[i].idx = 0;
    st[i].second = -CUDART_INF_F;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_one();  // tile t (and the row tile) landed for this thread
    __syncthreads();      // ... and for every thread
    if (t == 0 && tid < K1_ROWS) {
      const float* xr = xs + tid * ld;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(xr[d], xr[d], s);
      xsq_s[tid] = s;
    }
    const float* et = es + (t % K1_STAGES) * K1_TILE_B * ld;
    float acc[K1_RM][K1_BN];
    float esq[K1_BN];
#pragma unroll
    for (int q = 0; q < K1_BN; ++q) {
      esq[q] = 0.f;
#pragma unroll
      for (int i = 0; i < K1_RM; ++i) acc[i][q] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < Dp; d += 4) {  // columns D..Dp-1 are zero
      float4 xv[K1_RM];
      float4 ev[K1_BN];
#pragma unroll
      for (int i = 0; i < K1_RM; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xs + (rg * K1_RM + i) * ld + d);
#pragma unroll
      for (int q = 0; q < K1_BN; ++q)
        ev[q] = *reinterpret_cast<const float4*>(et + (bg + q * K1_BG) * ld + d);
#pragma unroll
      for (int q = 0; q < K1_BN; ++q) {
        esq[q] = fmaf(ev[q].x, ev[q].x, esq[q]);
        esq[q] = fmaf(ev[q].y, ev[q].y, esq[q]);
        esq[q] = fmaf(ev[q].z, ev[q].z, esq[q]);
        esq[q] = fmaf(ev[q].w, ev[q].w, esq[q]);
#pragma unroll
        for (int i = 0; i < K1_RM; ++i) {
          float a = acc[i][q];
          a = fmaf(xv[i].x, ev[q].x, a);
          a = fmaf(xv[i].y, ev[q].y, a);
          a = fmaf(xv[i].z, ev[q].z, a);
          a = fmaf(xv[i].w, ev[q].w, a);
          acc[i][q] = a;
        }
      }
    }
    if (t == 0) {
      __syncthreads();  // xsq_s written
#pragma unroll
      for (int i = 0; i < K1_RM; ++i) xsq[i] = xsq_s[rg * K1_RM + i];
    }
#pragma unroll
    for (int q = 0; q < K1_BN; ++q) {
      const int j = j0 + t * K1_TILE_B + bg + q * K1_BG;
      if (j < j1) {
#pragma unroll
        for (int i = 0; i < K1_RM; ++i) {
          // the reference association order: -((|x|^2 - 2 x.e) + |e|^2)
          push(st[i], -((xsq[i] - 2.f * acc[i][q]) + esq[q]), j);
        }
      }
    }
    __syncthreads();  // stage t % STAGES fully consumed
    if (t + K1_STAGES < ntiles) {
      const int b = j0 + (t + K1_STAGES) * K1_TILE_B;
      k1_copy_rows(es + (t % K1_STAGES) * K1_TILE_B * ld,
                   book + (size_t)b * D, min(K1_TILE_B, j1 - b), D, ld,
                   vec16);
    }
    cp_async_commit();
  }

  // merge the 16 bin groups of each row (lanes of one half-warp)
#pragma unroll
  for (int i = 0; i < K1_RM; ++i) {
#pragma unroll
    for (int off = K1_BG / 2; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, st[i].best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, st[i].idx, off);
      const float os = __shfl_xor_sync(0xffffffffu, st[i].second, off);
      merge(st[i], ob, oi, os);
    }
    if (bg == 0) {
      const int r = rg * K1_RM + i;
      part_best[r] = st[i].best;
      part_idx[r] = st[i].idx;
      part_second[r] = st[i].second;
    }
  }

  cluster_sync();  // every CTA's partial results are written and visible
  if (tid < nrows && tid % (int)csize == (int)rank) {
    Best m{part_best[tid], part_idx[tid], part_second[tid]};
    for (unsigned c = 0; c < csize; ++c) {
      if (c == rank) continue;
      merge(m, map_rank(part_best, c)[tid], map_rank(part_idx, c)[tid],
            map_rank(part_second, c)[tid]);
    }
    idx_out[n0 + tid] = m.idx;
    margin_out[n0 + tid] = m.best - m.second;
  }
  cluster_sync();  // no CTA leaves while another still reads its results
}

// ---------------------------------------------------------------- K2 ----

constexpr int TX = 32;            // lanes over bins
constexpr int TY = 8;             // warps per CTA
constexpr int RM = 2;             // rows per warp
constexpr int BN = 2;             // bins per lane per tile
constexpr int TILE_N = TY * RM;   // rows per CTA
constexpr int TILE_B = TX * BN;   // bins per shared-memory tile
constexpr int THREADS = TX * TY;

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

// Layout constants of K1, for the wrapper's plan and its checks.
int vq_nearest_rows_per_cta() { return K1_ROWS; }
int vq_nearest_tile_bins() { return K1_TILE_B; }
int vq_nearest_threads() { return K1_THREADS; }
int vq_nearest_max_cluster() { return K1_MAX_CLUSTER; }
int vq_nearest_smem_bytes(int D) { return static_cast<int>(k1_smem_bytes(D)); }

// x [N, D], book [bins, D] (contiguous f32). The plan: `cluster` CTAs per
// 32-row tile, CTA r searching bins [r*per_cta, min(bins, (r+1)*per_cta)).
int vq_nearest_launch(const float* x, const float* book, int N, int bins,
                      int D, int cluster, int per_cta, int* idx_out,
                      float* margin_out, void* stream) {
  if (N == 0) return 0;
  if (D < 1 || cluster < 1 || cluster > K1_MAX_CLUSTER || per_cta < 1 ||
      (long long)cluster * per_cta < bins ||
      (long long)(cluster - 1) * per_cta >= bins)
    return cudaErrorInvalidValue;
  const int smem = static_cast<int>(k1_smem_bytes(D));
  cudaError_t err = cudaFuncSetAttribute(
      vq_nearest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec16 = (D % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(book) % 16 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + K1_ROWS - 1) / K1_ROWS) * cluster);
  cfg.blockDim = dim3(K1_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, vq_nearest_kernel, x, book, N, bins, D,
                           per_cta, vec16, idx_out, margin_out);
  if (err != cudaSuccess) return err;
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
