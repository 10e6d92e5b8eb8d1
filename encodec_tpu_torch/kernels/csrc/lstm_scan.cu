// LSTM recurrence for Hopper (sm_90a): K3's cluster kernel, H <= 512.
//
// Replaces encodec_tpu/kernels/lstm_pallas.py:55 lstm_scan_pallas (body
// _scan_kernel): one LSTM layer's recurrence over gate inputs xp [B, T, 4H]
// (= x W_ih^T + b_ih + b_hh, computed before the scan), gate order i, f,
// g, o:
//   gates_t = xp_t + h_{t-1} W_hh^T
//   c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g),  h_t = sigmoid(o) tanh(c_t)
// with IEEE expf/tanhf (no fast math). Output h [B, T, H]. The TPU kernel
// starts from zero state only; this one also starts from a given (h0, c0)
// [B, H] and can write the final c [B, H] (the final h is out[:, T-1]),
// which is what a chunked stream carries. With a state, step 0 copies
// h0[b] into the h buffer it reads and runs the same matvec, butterfly and
// cell code as every later step, so one launch over T steps and launches
// over any split of T with (h, c) carried give the same bits. Without one
// (h0 == nullptr) step 0 skips the recurrent term. The state code is a
// second instantiation (STATE = true), so the zero-state kernel of the
// offline path compiles as it did without it: at 255 registers per thread
// the state code doubles the local spill (16 -> 32 B per thread at
// H=512). Training needs every step's c for the backward (lstm_bwd.cu):
// a third instantiation (STATE = true, SAVE = true) also stores c_t into
// c_seq [B, T, H]; its arithmetic is the state kernel's, so `out` has the
// same bits, and the two inference instantiations do not change.
//
// What bounds it: the T-step dependency chain, not FLOPs or bytes (at the
// 24 kHz shapes 2*B*T*H*4H FLOPs and ~12 MB run in tens of microseconds at
// peak). Each step needs all of h_{t-1}, so the time is T x (one step's
// latency), and W_hh (4 MiB at H=512) is too large for one SM.
//
// Design: one thread-block cluster per sequence in flight; no grid-wide
// barrier, no global atomics, no L2 round trip for h.
// - A cluster of C CTAs (C = the smallest power of two with 32*C >= H, at
//   most 16: C=16 at H=512, a non-portable size) splits the hidden units;
//   CTA r owns units [r*U, r*U+U), U = ceil(H/C) <= 32, and their 4U rows of
//   W_hh stay resident for the whole launch: per warp 16 rows (4 gates x 4
//   units), REG_ROWS=12 of them in registers (a float4 per lane per 128 k)
//   and 4 in shared memory (at H=512: 96 + 32 rows of the CTA's 128). Each
//   row moved into registers saves its shared-memory loads every step; 12
//   is what 255 registers per thread hold without spilling.
// - h_{t-1} (the whole vector, zero-padded to a multiple of 128) sits in a
//   double-buffered array in every CTA's shared memory, each buffer with an
//   mbarrier. After step t, lane r of each warp sends the warp's four h
//   values to CTA r with one st.async (DSMEM store that counts its bytes on
//   the receiver's mbarrier); a CTA starts step t+1 when its barrier has
//   counted all 4*H bytes. A step waits only for its inputs; an all-CTA
//   barrier.cluster per step measured ~0.5 us on its own (H100, H=512,
//   16 CTAs). Two buffers suffice: a CTA
//   sends into buffer b at step t+1 only after it received every CTA's
//   h_t, which each CTA sends only after reading b at step t. The last
//   step sends nothing, so no message outlives its receiver.
// - Each lane accumulates 16 row partials over its k slice (4 per float4),
//   a butterfly of 16 shuffles leaves lane l with the sum of row l>>1, and
//   four shuffles gather a unit's i, f, g, o gates into lanes 0..3, which
//   keep that unit's cell state in a register. Gate inputs are prefetched
//   two steps ahead into registers.
// - Sequences are independent: the grid is n_clusters x C CTAs, and cluster
//   k runs sequences k, k + n_clusters, ... (n_clusters = min(B, what the
//   card can hold at once: 7 clusters of 16 on an H100), so B up to that
//   costs about what B=1 costs.
// - H > 512 is not taken here (the k slice of a lane is at most 4
//   float4s, and no cluster holds a larger W_hh: 16 MiB at H=1024).
//   lstm_grid.cu takes 512 < H <= 1024, the breathing configurations,
//   with W_hh spread over a cooperative grid of one CTA per SM and h
//   exchanged through L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int UNITS_PER_WARP = 4;
constexpr int ROWS_PER_WARP = 4 * UNITS_PER_WARP;      // 16 gate rows
constexpr int MAX_UNITS = WARPS * UNITS_PER_WARP;      // 32 units per CTA
constexpr int REG_ROWS = 12;                           // rows in registers
constexpr int SMEM_ROWS = ROWS_PER_WARP - REG_ROWS;    // rows in shared
constexpr int KCHUNK = 128;                            // k per float4 x 32
constexpr int MAX_KM = 4;                              // H <= 512
constexpr int MAX_CLUSTER = 16;
static_assert(REG_ROWS > 0 && REG_ROWS <= ROWS_PER_WARP, "REG_ROWS");

__host__ __device__ constexpr int k_chunks(int H) {
  return (H + KCHUNK - 1) / KCHUNK;
}

// shared W rows, two h buffers, two mbarriers
__host__ __device__ constexpr size_t smem_bytes(int H) {
  return ((size_t)WARPS * SMEM_ROWS + 2) * k_chunks(H) * KCHUNK *
             sizeof(float) + 2 * sizeof(uint64_t);
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// shared::cluster address of this CTA's shared `addr` in cluster CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, unsigned rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// arrive once on `bar` and expect `bytes` of st.async data in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
      :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for the phase of `bar` with this parity to complete. A message that
// never comes would be a bug; the bounded spin turns it into a kernel fault
// instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  for (uint32_t i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;"
        "\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (i == (1u << 22)) __trap();
  }
}

// store into another CTA's shared memory and count the bytes on its barrier
__device__ __forceinline__ void st_async(uint32_t dst, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];"
      :: "r"(dst), "f"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async4(uint32_t dst, float a, float b,
                                          float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(dst), "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar) : "memory");
}

__device__ __forceinline__ float dot4(float4 w, float4 h, float acc) {
  acc = fmaf(w.x, h.x, acc);
  acc = fmaf(w.y, h.y, acc);
  acc = fmaf(w.z, h.z, acc);
  return fmaf(w.w, h.w, acc);
}

// One butterfly level over 2*HALF row partials: lanes with bit 2*HALF set
// keep the upper half, the others the lower, each adding its partner's.
template <int HALF>
__device__ __forceinline__ void fold(float (&acc)[ROWS_PER_WARP], int lane) {
  const bool up = (lane & (2 * HALF)) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? acc[i] : acc[i + HALF];
    const float keep = up ? acc[i + HALF] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
  }
}

template <int KM, bool STATE, bool SAVE>
__global__ void __launch_bounds__(THREADS, 1)
lstm_scan_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
                 const float* __restrict__ h0, const float* __restrict__ c0,
                 float* __restrict__ out, float* __restrict__ c_out,
                 float* __restrict__ c_seq, int B, int T, int H, int U) {
  constexpr int HP = KM * KCHUNK;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                          // [WARPS][SMEM_ROWS][HP]
  float* h_s = w_s + WARPS * SMEM_ROWS * HP;  // [2][HP]: h_{t-1}, zero pad
  uint64_t* bar = reinterpret_cast<uint64_t*>(h_s + 2 * HP);  // [2]

  const unsigned rank = cluster_rank();
  const unsigned csize = cluster_size();
  const int cl = blockIdx.x / csize;
  const int n_cl = gridDim.x / csize;
  const int u0 = (int)rank * U;
  const int nu = min(U, H - u0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int H4 = 4 * H;
  const unsigned h_bytes = 4u * H;  // what every CTA receives per step

  // warp row q = g*4 + jj is gate g of local unit warp*4 + jj
  auto w_row = [&](int q) -> const float* {
    const int lu = warp * UNITS_PER_WARP + (q & 3);
    return lu < nu ? w_hh + (size_t)((q >> 2) * H + u0 + lu) * H : nullptr;
  };
  auto w_at = [&](const float* row, int k) -> float {
    return (row != nullptr && k < H) ? row[k] : 0.f;
  };

  float4 wr[REG_ROWS][KM];
#pragma unroll
  for (int q = 0; q < REG_ROWS; ++q) {
    const float* row = w_row(q);
#pragma unroll
    for (int m = 0; m < KM; ++m) {
      const int k = m * KCHUNK + 4 * lane;
      wr[q][m] = make_float4(w_at(row, k), w_at(row, k + 1), w_at(row, k + 2),
                             w_at(row, k + 3));
    }
  }
  for (int q = 0; q < SMEM_ROWS; ++q) {
    const float* row = w_row(REG_ROWS + q);
    float* dst = w_s + (warp * SMEM_ROWS + q) * HP;
    for (int k = lane; k < HP; k += 32) dst[k] = w_at(row, k);
  }
  for (int e = threadIdx.x; e < 2 * HP; e += THREADS) h_s[e] = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar + i, 1);
      mbar_expect_tx(bar + i, h_bytes);  // the first message into buffer i
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA of the cluster is running, with its buffers zeroed and its
  // barriers armed, before any CTA sends into them
  cluster_arrive();
  cluster_wait();

  // after the butterfly, lane l holds the sum of warp row l >> 1 (both
  // lanes of a pair); its gate input is xp[b, t, g*H + u0 + lu]
  const int my_q = lane >> 1;
  const int my_lu = warp * UNITS_PER_WARP + (my_q & 3);
  const bool my_valid = my_lu < nu;
  const size_t my_col = (size_t)(my_q >> 2) * H + u0 + my_lu;
  // lanes 0..3 update unit warp*4 + lane; lane r < csize sends the warp's
  // four h values to CTA r, as one 16-byte store when they are all valid
  // and 16-byte aligned
  const int cell_lu = warp * UNITS_PER_WARP + (lane & 3);
  const int warp_u = u0 + warp * UNITS_PER_WARP;  // global unit of lane 0
  const int warp_nu = max(0, min(UNITS_PER_WARP, nu - warp * UNITS_PER_WARP));
  const bool vec_send = warp_nu == UNITS_PER_WARP && warp_u % 4 == 0;
  const bool sender = lane < (int)csize && warp_nu > 0;
  const uint32_t h_remote = sender ? map_rank(smem_addr(h_s + warp_u), lane) : 0;
  const uint32_t bar_remote = sender ? map_rank(smem_addr(bar), lane) : 0;

  // The cluster's steps run back to back over its sequences; step s reads
  // buffer s & 1 (sent at step s-1) and sends into buffer (s+1) & 1. The
  // last step sends nothing, so every message is awaited by a live CTA.
  // Step 0 of a sequence with a state overwrites buffer s & 1 with h0[b]:
  // the message it awaited (the previous sequence's last h) has fully
  // arrived, and the next one into that buffer is sent only after every
  // CTA has received this step's h, so nothing else writes it meanwhile.
  const int n_seq = (B - cl + n_cl - 1) / n_cl;
  const unsigned n_steps = (unsigned)n_seq * T;
  const bool stateful = STATE && h0 != nullptr;
  unsigned phase = 0;  // bit i: parity of buffer i's next phase
  unsigned s = 0;
  for (int b = cl; b < B; b += n_cl) {
    const float* xrow = xp + (size_t)b * T * H4 + my_col;
    // gate inputs of steps t and t+1, prefetched two steps ahead
    float xv = my_valid ? __ldg(xrow) : 0.f;
    float xv1 = (my_valid && T > 1) ? __ldg(xrow + H4) : 0.f;
    // lanes 0..3 keep the cell state of unit warp*4 + lane
    float c = (STATE && c0 != nullptr && lane < warp_nu)
                  ? c0[(size_t)b * H + warp_u + lane] : 0.f;
    for (int t = 0; t < T; ++t, ++s) {
      const unsigned cb = s & 1;
      float* hb = h_s + cb * HP;
      if (s > 0) {
        mbar_wait(bar + cb, (phase >> cb) & 1);
        phase ^= 1u << cb;
        __syncthreads();  // all threads saw this phase before it is re-armed
        if (threadIdx.x == 0) mbar_expect_tx(bar + cb, h_bytes);
      }
      if (stateful && t == 0) {
        // h_{-1} = h0[b]; the zero padding past H stays as it is
        for (int k = threadIdx.x; k < H; k += THREADS)
          hb[k] = h0[(size_t)b * H + k];
        __syncthreads();
      }
      float v = 0.f;  // zero state: the recurrent term of step 0 is 0
      if (t > 0 || stateful) {
        float acc[ROWS_PER_WARP];
#pragma unroll
        for (int q = 0; q < ROWS_PER_WARP; ++q) acc[q] = 0.f;
#pragma unroll
        for (int m = 0; m < KM; ++m) {
          const int k = m * KCHUNK + 4 * lane;
          const float4 h4 = *reinterpret_cast<const float4*>(hb + k);
#pragma unroll
          for (int q = 0; q < REG_ROWS; ++q)
            acc[q] = dot4(wr[q][m], h4, acc[q]);
#pragma unroll
          for (int q = 0; q < SMEM_ROWS; ++q) {
            const float4 w4 = *reinterpret_cast<const float4*>(
                w_s + (warp * SMEM_ROWS + q) * HP + k);
            acc[REG_ROWS + q] = dot4(w4, h4, acc[REG_ROWS + q]);
          }
        }
        // butterfly: 16 rows x 32 lanes -> lane l holds row l >> 1
        fold<8>(acc, lane);
        fold<4>(acc, lane);
        fold<2>(acc, lane);
        fold<1>(acc, lane);
        v = acc[0] + __shfl_xor_sync(0xffffffffu, acc[0], 1);
      }
      v = xv + v;  // gates_t = xp_t + h_{t-1} W_hh^T
      const int jj = lane & 3;
      const float gi = __shfl_sync(0xffffffffu, v, 2 * (0 * 4 + jj));
      const float gf = __shfl_sync(0xffffffffu, v, 2 * (1 * 4 + jj));
      const float gg = __shfl_sync(0xffffffffu, v, 2 * (2 * 4 + jj));
      const float go = __shfl_sync(0xffffffffu, v, 2 * (3 * 4 + jj));
      float h = 0.f;
      if (lane < UNITS_PER_WARP) {
        c = sigmoidf(gf) * c + sigmoidf(gi) * tanhf(gg);
        h = sigmoidf(go) * tanhf(c);
      }
      float hw[UNITS_PER_WARP];
#pragma unroll
      for (int j = 0; j < UNITS_PER_WARP; ++j)
        hw[j] = __shfl_sync(0xffffffffu, h, j);
      if (sender && s + 1 < n_steps) {
        const unsigned nb = (s + 1) & 1;
        const uint32_t dst = h_remote + nb * HP * 4;
        const uint32_t nbar = bar_remote + nb * 8;
        if (vec_send) {
          st_async4(dst, hw[0], hw[1], hw[2], hw[3], nbar);
        } else {
          for (int j = 0; j < warp_nu; ++j) st_async(dst + 4 * j, hw[j], nbar);
        }
      }
      if (lane < warp_nu) out[((size_t)b * T + t) * H + warp_u + lane] = h;
      if (SAVE && lane < warp_nu)
        c_seq[((size_t)b * T + t) * H + warp_u + lane] = c;
      if (STATE && c_out != nullptr && t == T - 1 && lane < warp_nu)
        c_out[(size_t)b * H + warp_u + lane] = c;
      xv = xv1;
      xv1 = (my_valid && t + 2 < T) ? __ldg(xrow + (size_t)(t + 2) * H4) : 0.f;
    }
  }
}

template <int KM, bool STATE, bool SAVE>
cudaError_t prepare(int H, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      lstm_scan_kernel<KM, STATE, SAVE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(H)));
  if (err != cudaSuccess) return err;
  if (cluster > 8)
    err = cudaFuncSetAttribute(lstm_scan_kernel<KM, STATE, SAVE>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

cudaLaunchConfig_t config(int H, int cluster, int n_clusters,
                          cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(H);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// (all instantiations take the same shared memory and threads, and run at
// the launch bound's one CTA per SM)
template <int KM>
int max_clusters(int H, int cluster) {
  cudaError_t err = prepare<KM, false, false>(H, cluster);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(H, cluster, 1, &attr, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, lstm_scan_kernel<KM, false, false>,
                                       &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <int KM, bool STATE, bool SAVE>
int launch_as(const float* xp, const float* w_hh, const float* h0,
              const float* c0, float* out, float* c_out, float* c_seq, int B,
              int T, int H, int cluster, int U, int n_clusters,
              cudaStream_t stream) {
  cudaError_t err = prepare<KM, STATE, SAVE>(H, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(H, cluster, n_clusters, &attr, stream);
  err = cudaLaunchKernelEx(&cfg, lstm_scan_kernel<KM, STATE, SAVE>, xp, w_hh,
                           h0, c0, out, c_out, c_seq, B, T, H, U);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the saving instantiation when every step's c is stored, else the state
// instantiation when a state is read or written
template <int KM>
int launch(const float* xp, const float* w_hh, const float* h0,
           const float* c0, float* out, float* c_out, float* c_seq, int B,
           int T, int H, int cluster, int U, int n_clusters,
           cudaStream_t stream) {
  if (c_seq != nullptr)
    return launch_as<KM, true, true>(xp, w_hh, h0, c0, out, c_out, c_seq, B,
                                     T, H, cluster, U, n_clusters, stream);
  if (h0 != nullptr || c_out != nullptr)
    return launch_as<KM, true, false>(xp, w_hh, h0, c0, out, c_out, c_seq, B,
                                      T, H, cluster, U, n_clusters, stream);
  return launch_as<KM, false, false>(xp, w_hh, h0, c0, out, c_out, c_seq, B,
                                     T, H, cluster, U, n_clusters, stream);
}

template <int KM>
int attributes(int variant, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const void* fn =
      variant == 2 ? reinterpret_cast<const void*>(lstm_scan_kernel<KM, true, true>)
      : variant == 1
          ? reinterpret_cast<const void*>(lstm_scan_kernel<KM, true, false>)
          : reinterpret_cast<const void*>(lstm_scan_kernel<KM, false, false>);
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

bool valid_h(int H) { return H >= 1 && H <= MAX_KM * KCHUNK; }

}  // namespace

extern "C" {

const char* lstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Layout constants, for the wrapper's plan and its checks.
int lstm_scan_units_per_cta_max() { return MAX_UNITS; }
int lstm_scan_max_cluster() { return MAX_CLUSTER; }
int lstm_scan_reg_rows() { return REG_ROWS; }
int lstm_scan_threads() { return THREADS; }
int lstm_scan_smem_bytes(int H) {
  return valid_h(H) ? static_cast<int>(smem_bytes(H)) : -1;
}

// How many clusters of `cluster` CTAs the card holds at once (negative: a
// CUDA error).
int lstm_scan_max_clusters(int H, int cluster) {
  if (!valid_h(H) || cluster < 1 || cluster > MAX_CLUSTER)
    return -static_cast<int>(cudaErrorInvalidValue);
  switch (k_chunks(H)) {
    case 1: return max_clusters<1>(H, cluster);
    case 2: return max_clusters<2>(H, cluster);
    case 3: return max_clusters<3>(H, cluster);
    default: return max_clusters<4>(H, cluster);
  }
}

// Registers per thread and local (spill) bytes of the kernel for H, the
// zero-state instantiation (state = 0), the one with a state (1) or the
// saving one (2).
int lstm_scan_attributes(int H, int state, int* regs, int* local_bytes) {
  if (!valid_h(H) || state < 0 || state > 2) return cudaErrorInvalidValue;
  switch (k_chunks(H)) {
    case 1: return attributes<1>(state, regs, local_bytes);
    case 2: return attributes<2>(state, regs, local_bytes);
    case 3: return attributes<3>(state, regs, local_bytes);
    default: return attributes<4>(state, regs, local_bytes);
  }
}

// xp [B, T, 4H], w_hh [4H, H], out [B, T, H] (all contiguous f32); h0 and
// c0 [B, H], the initial state (both null: zero state), and c_out [B, H],
// the final cell state (null: not written), and c_seq [B, T, H], every
// step's cell state (null: not written). The plan: clusters of `cluster`
// CTAs, CTA r owning units [r*U, r*U+U), and `n_clusters` clusters sharing
// the batch.
int lstm_scan_launch(const float* xp, const float* w_hh, const float* h0,
                     const float* c0, float* out, float* c_out, float* c_seq,
                     int B, int T, int H, int cluster, int U, int n_clusters,
                     void* stream) {
  if (B == 0 || T == 0) return 0;
  if (!valid_h(H) || cluster < 1 || cluster > MAX_CLUSTER || U < 1 ||
      U > MAX_UNITS || cluster * U < H || (cluster - 1) * U >= H ||
      n_clusters < 1 || (h0 == nullptr) != (c0 == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k_chunks(H)) {
    case 1:
      return launch<1>(xp, w_hh, h0, c0, out, c_out, c_seq, B, T, H,
                       cluster, U, n_clusters, st);
    case 2:
      return launch<2>(xp, w_hh, h0, c0, out, c_out, c_seq, B, T, H,
                       cluster, U, n_clusters, st);
    case 3:
      return launch<3>(xp, w_hh, h0, c0, out, c_out, c_seq, B, T, H,
                       cluster, U, n_clusters, st);
    default:
      return launch<4>(xp, w_hh, h0, c0, out, c_out, c_seq, B, T, H,
                       cluster, U, n_clusters, st);
  }
}

}  // extern "C"
