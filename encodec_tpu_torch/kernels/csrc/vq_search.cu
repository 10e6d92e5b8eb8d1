// RVQ codebook search for Hopper (sm_90a): K1 and K2 of the port.
//
// K1 `vq_nearest_launch` replaces encodec_tpu/kernels/vq_pallas.py:43
//    nearest_codebook_pallas (body _nearest_kernel): per row of x [N, D],
//    idx = argmax_j -(|x|^2 - 2 x.e_j + |e_j|^2), first max wins. It also
//    returns margin = best - max_{j != idx}, the top-2 gap the container
//    writer's near-tie guard reads (encodec_tpu/quant/rvq.py
//    rvq_encode_margins), and optionally the winner's score (its negated
//    distance), on which the codebook-sharded search (parallel/tp.py)
//    merges shards.
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
// Both kernels are one cluster split-bins search (`search_slice`):
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
// - |x|^2, |e|^2 and x.e are sequential fmaf chains over d, and every value
//   is -((|x|^2 - 2 x.e) + |e|^2): the same IEEE operations in the same
//   order whichever thread, CTA or kernel computes them.
// - Each thread keeps a running (best, idx, second) per row in increasing
//   j, where only a strictly greater value replaces the best; shuffles
//   merge the 16 bin groups of a row, then the cluster's partial results
//   merge through distributed shared memory (DSMEM). Every merge breaks an
//   exact tie by the lower index, so the result is the first maximum over
//   all bins whatever the split, and K2's codes equal those of K1 run once
//   per stage with the same f32 update (rvq_encode_margins) bit for bit.
//   In K1 the loser's best becomes the winner's runner-up, so duplicate
//   rows in different CTAs' bin ranges give the lowest index and margin 0,
//   as `argmax` and the reference's masked max do. K2 keeps no runner-up.
//
// K2 on top of that search (one launch for all stages):
// - Every CTA of the cluster holds its own copy of the 32-row residual
//   tile for all n_q stages and searches its bin slice of book k.
// - The ring counts tiles across stages, so stage k+1's first book tiles
//   are copied while stage k's last tiles are computed, before its merge:
//   the book does not depend on the residual.
// - Per stage, each CTA writes its 32 (best, idx) pairs into a partial
//   buffer chosen by stage parity and arrives at one cluster barrier; then
//   every CTA merges all C partials of the 32 rows (DSMEM reads), CTA 0
//   stores codes[k], and every CTA applies r -= E_k[idx] in f32 with the
//   rows read from L2 (the 24 kHz book set, 16 MiB, fits in the 50 MB L2).
// - Two partial buffers suffice with one barrier per stage: a CTA writes
//   buffer k%2 in stage k+2 only after the barrier of stage k+1, which no
//   CTA reaches before it has finished reading the stage-k partials. A
//   final barrier keeps every CTA resident until no one reads its buffers.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

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

constexpr int ROWS = 32;                  // rows per cluster tile
constexpr int TILE_B = 64;                // bins per ring stage
constexpr int RM = 4;                     // rows per thread
constexpr int BN = 4;                     // bins per thread
constexpr int BG = TILE_B / BN;           // bin groups (16 lanes)
constexpr int RG = ROWS / RM;             // row groups
constexpr int THREADS = BG * RG;          // 128
constexpr int STAGES = 2;
constexpr int MAX_CLUSTER = 8;            // portable cluster size
constexpr int MAX_D = 352;                // largest D whose CTA fits
constexpr int MAX_DEVICES = 64;

// shared row stride: D rounded up to 4, then to 4 * (an odd number)
__host__ __device__ constexpr int row_stride(int D) {
  return 4 * ((((D + 3) / 4) + 1) | 1);
}

// the row tile and the ring, shared by both kernels
__host__ __device__ constexpr size_t tiles_floats(int D) {
  return (size_t)(ROWS + STAGES * TILE_B) * row_stride(D);
}

// K1: + |x|^2, and best, idx, runner-up of the CTA's slice [ROWS] each
__host__ __device__ constexpr size_t k1_smem_bytes(int D) {
  return (tiles_floats(D) + 4 * ROWS) * sizeof(float);
}

// K2: + |x|^2 [ROWS], two stage buffers of (best, idx) pairs [2][ROWS],
// the merged indices [ROWS]
__host__ __device__ constexpr size_t k2_smem_bytes(int D) {
  return (tiles_floats(D) + 6 * ROWS) * sizeof(float);
}

static_assert(k2_smem_bytes(MAX_D) <= 232448, "K2 CTA above 227 KB");
static_assert(k2_smem_bytes(MAX_D + 1) > 232448, "MAX_D is not the limit");

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
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int n,
                                          int D, int ld, bool vec16) {
  if (vec16) {
    const int c4 = D / 4;
    for (int e = threadIdx.x; e < n * c4; e += THREADS) {
      const int r = e / c4;
      const int c = e - r * c4;
      cp_async16(dst + r * ld + 4 * c, src + (size_t)r * D + 4 * c);
    }
  } else {
    for (int e = threadIdx.x; e < n * D; e += THREADS) {
      const int r = e / D;
      const int c = e - r * D;
      cp_async4(dst + r * ld + c, src + (size_t)r * D + c);
    }
  }
}

// Zero what cp.async never writes: the pad columns of the row tile and the
// ring, and whole rows of the tile past N (their results are never stored).
__device__ __forceinline__ void zero_unwritten(float* xs, int D, int ld,
                                               int nrows) {
  const int pad = ld - D;
  for (int e = threadIdx.x; e < (ROWS + STAGES * TILE_B) * pad;
       e += THREADS) {
    const int r = e / pad;
    xs[r * ld + D + (e - r * pad)] = 0.f;
  }
  for (int e = threadIdx.x; e < (ROWS - nrows) * D; e += THREADS) {
    const int r = nrows + e / D;
    xs[r * ld + e % D] = 0.f;
  }
}

// Search bins [j0, j1) for the ROWS rows of xs (shared, stride ld, pad
// columns zero). The slice's 64-bin tiles are ring tiles g0, g0+1, ... in
// slot g % STAGES; `refill(g, slot)` issues the cp.async copies of ring tile
// g (or nothing), and this function commits one group per tile consumed,
// refilling the slot with tile g + STAGES. On return, st[i] holds the
// thread's (best, idx, second) for row rg*RM+i over its bins of the slice,
// and every thread has finished reading xs and the ring.
template <class Refill>
__device__ __forceinline__ void search_slice(const float* xs, float* es,
                                             float* xsq_s, int D, int ld,
                                             int j0, int j1, int g0,
                                             const Refill& refill,
                                             Best (&st)[RM]) {
  const int Dp = (D + 3) & ~3;
  const int ntiles = (j1 - j0 + TILE_B - 1) / TILE_B;
  const int tid = threadIdx.x;
  const int bg = tid % BG;
  const int rg = tid / BG;
  float xsq[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    st[i].best = -CUDART_INF_F;
    st[i].idx = 0;
    st[i].second = -CUDART_INF_F;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int g = g0 + t;
    float* slot = es + (g % STAGES) * TILE_B * ld;
    cp_async_wait_one();  // tile g (and the row tile) landed for this thread
    __syncthreads();      // ... and for every thread
    if (t == 0 && tid < ROWS) {
      const float* xr = xs + tid * ld;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(xr[d], xr[d], s);
      xsq_s[tid] = s;
    }
    float acc[RM][BN];
    float esq[BN];
#pragma unroll
    for (int q = 0; q < BN; ++q) {
      esq[q] = 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i) acc[i][q] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < Dp; d += 4) {  // columns D..Dp-1 are zero
      float4 xv[RM];
      float4 ev[BN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xs + (rg * RM + i) * ld + d);
#pragma unroll
      for (int q = 0; q < BN; ++q)
        ev[q] = *reinterpret_cast<const float4*>(slot + (bg + q * BG) * ld + d);
#pragma unroll
      for (int q = 0; q < BN; ++q) {
        esq[q] = fmaf(ev[q].x, ev[q].x, esq[q]);
        esq[q] = fmaf(ev[q].y, ev[q].y, esq[q]);
        esq[q] = fmaf(ev[q].z, ev[q].z, esq[q]);
        esq[q] = fmaf(ev[q].w, ev[q].w, esq[q]);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
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
      for (int i = 0; i < RM; ++i) xsq[i] = xsq_s[rg * RM + i];
    }
#pragma unroll
    for (int q = 0; q < BN; ++q) {
      const int j = j0 + t * TILE_B + bg + q * BG;
      if (j < j1) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          // the reference association order: -((|x|^2 - 2 x.e) + |e|^2)
          push(st[i], -((xsq[i] - 2.f * acc[i][q]) + esq[q]), j);
        }
      }
    }
    __syncthreads();  // slot fully consumed
    refill(g + STAGES, slot);
    cp_async_commit();
  }
}

// Merge the 16 bin groups of each row (lanes of one half-warp): afterwards
// every lane of the half-warp holds the CTA's result for its rows.
__device__ __forceinline__ void merge_bin_groups(Best (&st)[RM]) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int off = BG / 2; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, st[i].best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, st[i].idx, off);
      const float os = __shfl_xor_sync(0xffffffffu, st[i].second, off);
      merge(st[i], ob, oi, os);
    }
  }
}

// ---------------------------------------------------------------- K1 ----

__global__ void __launch_bounds__(THREADS)
vq_nearest_kernel(const float* __restrict__ x, const float* __restrict__ book,
                  int N, int bins, int D, int per_cta, int vec16,
                  int* __restrict__ idx_out, float* __restrict__ margin_out,
                  float* __restrict__ score_out) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(D);
  float* xs = smem;                                  // [ROWS][ld]
  float* es = xs + ROWS * ld;                        // [STAGES][TILE_B][ld]
  float* xsq_s = es + STAGES * TILE_B * ld;          // [ROWS]
  float* part_best = xsq_s + ROWS;                   // [ROWS] each
  int* part_idx = reinterpret_cast<int*>(part_best + ROWS);
  float* part_second = part_best + 2 * ROWS;

  const unsigned rank = cluster_rank();
  const unsigned csize = cluster_size();
  const int n0 = (blockIdx.x / csize) * ROWS;
  const int nrows = min(ROWS, N - n0);
  const int j0 = (int)rank * per_cta;
  const int j1 = min(bins, j0 + per_cta);
  const int ntiles = (j1 - j0 + TILE_B - 1) / TILE_B;
  const int tid = threadIdx.x;

  zero_unwritten(xs, D, ld, nrows);
  auto refill = [&](int g, float* slot) {
    if (g < ntiles) {
      const int b = j0 + g * TILE_B;
      copy_rows(slot, book + (size_t)b * D, min(TILE_B, j1 - b), D, ld,
                vec16);
    }
  };
  // group 0: the row tile and book tile 0; group 1: book tile 1 (or empty)
  copy_rows(xs, x + (size_t)n0 * D, nrows, D, ld, vec16);
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    refill(s, es + s * TILE_B * ld);
    cp_async_commit();
  }

  Best st[RM];
  search_slice(xs, es, xsq_s, D, ld, j0, j1, 0, refill, st);
  merge_bin_groups(st);
  if (tid % BG == 0) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = (tid / BG) * RM + i;
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
    if (score_out != nullptr) score_out[n0 + tid] = m.best;
  }
  cluster_sync();  // no CTA leaves while another still reads its results
}

// ---------------------------------------------------------------- K2 ----

__global__ void __launch_bounds__(THREADS)
vq_rvq_kernel(const float* __restrict__ x, const float* __restrict__ books,
              int N, int bins, int D, int n_q, int shared, int per_cta,
              int vec16, int* __restrict__ codes) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(D);
  float* xs = smem;                                  // residual [ROWS][ld]
  float* es = xs + ROWS * ld;                        // [STAGES][TILE_B][ld]
  float* xsq_s = es + STAGES * TILE_B * ld;          // [ROWS]
  // (best bits, idx) per row, one buffer per stage parity: [2][ROWS]
  int2* part = reinterpret_cast<int2*>(xsq_s + ROWS);
  int* idx_s = reinterpret_cast<int*>(part + 2 * ROWS);  // [ROWS]

  const unsigned rank = cluster_rank();
  const unsigned csize = cluster_size();
  const int n0 = (blockIdx.x / csize) * ROWS;
  const int nrows = min(ROWS, N - n0);
  const int j0 = (int)rank * per_cta;
  const int j1 = min(bins, j0 + per_cta);
  const int ntiles = (j1 - j0 + TILE_B - 1) / TILE_B;
  const int total = n_q * ntiles;                    // ring tiles, all stages
  const size_t book_step = shared ? 0 : (size_t)bins * D;
  const int tid = threadIdx.x;

  zero_unwritten(xs, D, ld, nrows);
  // ring tile g is tile g % ntiles of stage g / ntiles's slice
  auto refill = [&](int g, float* slot) {
    if (g < total) {
      const int k = g / ntiles;
      const int b = j0 + (g - k * ntiles) * TILE_B;
      copy_rows(slot, books + k * book_step + (size_t)b * D,
                min(TILE_B, j1 - b), D, ld, vec16);
    }
  };
  copy_rows(xs, x + (size_t)n0 * D, nrows, D, ld, vec16);
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    refill(s, es + s * TILE_B * ld);
    cp_async_commit();
  }

  for (int k = 0; k < n_q; ++k) {
    const float* book = books + k * book_step;
    Best st[RM];
    search_slice(xs, es, xsq_s, D, ld, j0, j1, k * ntiles, refill, st);
    merge_bin_groups(st);
    int2* mine = part + (k & 1) * ROWS;
    if (tid % BG == 0) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
        mine[(tid / BG) * RM + i] =
            make_int2(__float_as_int(st[i].best), st[i].idx);
    }

    cluster_sync();  // every CTA's stage-k partials are written and visible
    if (tid < ROWS) {
      int2 p[MAX_CLUSTER];
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c)
        if (c < (int)csize) p[c] = map_rank(mine, c)[tid];
      Best m{-CUDART_INF_F, 0, -CUDART_INF_F};
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c)
        if (c < (int)csize) merge(m, __int_as_float(p[c].x), p[c].y, 0.f);
      idx_s[tid] = m.idx;
      if (rank == 0 && tid < nrows) codes[(size_t)k * N + n0 + tid] = m.idx;
    }
    __syncthreads();  // idx_s complete

    // r -= E_k[idx] in f32, rows read from L2; rows past N stay zero
    if (vec16) {
      const int c4 = D / 4;
      for (int e = tid; e < nrows * c4; e += THREADS) {
        const int r = e / c4;
        const int c = e - r * c4;
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            book + (size_t)idx_s[r] * D) + c);
        float4* dst = reinterpret_cast<float4*>(xs + r * ld) + c;
        float4 a = *dst;
        a.x -= v.x;
        a.y -= v.y;
        a.z -= v.z;
        a.w -= v.w;
        *dst = a;
      }
    } else {
      for (int e = tid; e < nrows * D; e += THREADS) {
        const int r = e / D;
        const int d = e - r * D;
        xs[r * ld + d] -= __ldg(book + (size_t)idx_s[r] * D + d);
      }
    }
    // search_slice's first __syncthreads orders the update before any read
  }
  cluster_sync();  // no CTA leaves while another still reads its partials
}

// cudaFuncAttributeMaxDynamicSharedMemorySize, set once per device to the
// most any valid D needs (the launch itself asks for what its D needs)
std::atomic<bool> k1_ready[MAX_DEVICES];
std::atomic<bool> k2_ready[MAX_DEVICES];

cudaError_t allow_smem(const void* kernel, std::atomic<bool>* ready,
                       size_t most) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (ready[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(most));
  if (err == cudaSuccess) ready[dev].store(true, std::memory_order_release);
  return err;
}

bool bad_split(int bins, int cluster, int per_cta) {
  return bins < 1 || cluster < 1 || cluster > MAX_CLUSTER || per_cta < 1 ||
         (long long)cluster * per_cta < bins ||
         (long long)(cluster - 1) * per_cta >= bins;
}

cudaLaunchConfig_t cluster_config(int N, int cluster, size_t smem,
                                  cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + ROWS - 1) / ROWS) * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

const char* vq_search_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Layout constants of K1 and K2 (one search, one layout), for the
// wrapper's plans and their checks.
int vq_nearest_rows_per_cta() { return ROWS; }
int vq_nearest_tile_bins() { return TILE_B; }
int vq_nearest_threads() { return THREADS; }
int vq_nearest_max_cluster() { return MAX_CLUSTER; }
int vq_nearest_smem_bytes(int D) { return static_cast<int>(k1_smem_bytes(D)); }
int vq_rvq_rows_per_cta() { return ROWS; }
int vq_rvq_tile_bins() { return TILE_B; }
int vq_rvq_threads() { return THREADS; }
int vq_rvq_max_cluster() { return MAX_CLUSTER; }
int vq_rvq_smem_bytes(int D) { return static_cast<int>(k2_smem_bytes(D)); }

// x [N, D], book [bins, D] (contiguous f32). The plan: `cluster` CTAs per
// 32-row tile, CTA r searching bins [r*per_cta, min(bins, (r+1)*per_cta)).
// score_out (may be null): the winner's negated distance, the number the
// search compared, so that codebook shards can be merged on it.
int vq_nearest_launch(const float* x, const float* book, int N, int bins,
                      int D, int cluster, int per_cta, int* idx_out,
                      float* margin_out, float* score_out, void* stream) {
  if (N == 0) return 0;
  if (N < 0 || D < 1 || D > MAX_D || bad_split(bins, cluster, per_cta))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(vq_nearest_kernel),
                               k1_ready, k1_smem_bytes(MAX_D));
  if (err != cudaSuccess) return err;
  const int vec16 = (D % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(book) % 16 == 0);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(N, cluster, k1_smem_bytes(D), &attr, stream);
  err = cudaLaunchKernelEx(&cfg, vq_nearest_kernel, x, book, N, bins, D,
                           per_cta, vec16, idx_out, margin_out, score_out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// x [N, D], books [n_books, bins, D] (contiguous f32; book 0 for every
// stage when `shared`), codes [n_q, N]. The plan as for K1.
int vq_rvq_launch(const float* x, const float* books, int N, int bins, int D,
                  int n_q, int shared, int cluster, int per_cta, int* codes,
                  void* stream) {
  if (N == 0 || n_q == 0) return 0;
  if (N < 0 || n_q < 0 || D < 1 || D > MAX_D ||
      bad_split(bins, cluster, per_cta))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(vq_rvq_kernel),
                               k2_ready, k2_smem_bytes(MAX_D));
  if (err != cudaSuccess) return err;
  const int vec16 = (D % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(books) % 16 == 0);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(N, cluster, k2_smem_bytes(D), &attr, stream);
  err = cudaLaunchKernelEx(&cfg, vq_rvq_kernel, x, books, N, bins, D, n_q,
                           shared, per_cta, vec16, codes);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
