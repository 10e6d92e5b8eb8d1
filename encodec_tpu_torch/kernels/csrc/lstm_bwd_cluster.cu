// LSTM recurrence backward for Hopper (sm_90a): K3's backward as a cluster
// kernel, H <= 512.
//
// The TPU kernel (encodec_tpu/kernels/lstm_pallas.py:55 lstm_scan_pallas)
// is forward-only: the JAX trainer differentiates the `lax.scan` of
// encodec_tpu/ops/lstm.py:56-72 instead, and XLA runs that VJP. On the card
// the forward at H <= 512 is lstm_scan.cu's cluster kernel (in training its
// SAVE instantiation, which also stores every step's c), and this kernel is
// its gradient, the same function as lstm_bwd.cu's grid kernel (which keeps
// 512 < H <= 1024): one launch per layer runs the reverse recurrence
//   dh_t = dy_t + dgates_{t+1} W_hh            (dgates_T = 0)
//   dc_t = dc_{t+1} f_{t+1} + dh_t o_t (1 - tanh^2 c_t)   (dc_T = dc_last)
//   dgates_t = [dc_t g_t i_t (1 - i_t),  dc_t c_{t-1} f_t (1 - f_t),
//               dc_t i_t (1 - g_t^2),    dh_t tanh(c_t) o_t (1 - o_t)]
// (gate order i, f, g, o; i, f, o = sigmoid, g = tanh of the
// pre-activations `pre` = xp + h_{t-1} W_hh^T), and writes dgates [B, T, 4H]
// (= d xp), dh0 = dgates_0 W_hh and dc0 = dc_0 f_0. The pre-activations and
// dW_hh = dgates^T [h0; h_{<T-1}] are one large matmul each, outside the
// kernel. IEEE expf/tanhf, as in the forward.
//
// What bounds it: the T-step chain, as in the forward: dh_t needs all of
// dgates_{t+1}. At the training shapes (B=8, H=512) a step is 8 x 4 M FMAs
// over the whole card, a fraction of a microsecond at peak; the time is T x
// one step, and a step is the product at 2 warps per scheduler (its FMAs
// and its shared loads), the exchange, four times the forward's bytes, and
// the cells' IEEE math, each per sequence (PERF.md §6 splits them).
//
// Design: the forward's cluster design, transposed.
// - A cluster of C CTAs (C = the smallest power of two with 32*C >= H: 16
//   at H=512) splits the hidden units; CTA r owns units [r*U, r*U+U),
//   U = ceil(H/C) <= 32, and holds the 4H x U slab of W_hh's COLUMNS of its
//   units for the whole launch (256 KiB at H=512, as the forward's 128 rows).
//   Warp w takes units w*4 .. w*4+3; its warp row q = g*4 + jj is the column
//   of unit w*4 + jj within gate g's block of W_hh: the H values
//   W_hh[g*H + k, u], k < H. Each lane holds k = m*128 + 4*lane .. +3 of
//   each row (m < ceil(H/128)), 12 rows in registers and 4 in shared
//   memory, as the forward.
// - dgates_{t+1} (4H floats, gate g at offset g*HP, zero-padded to HP = a
//   multiple of 128) sits in a double-buffered array in every CTA's shared
//   memory, each buffer with an mbarrier. After its cells, each warp holds
//   its 16 dgates (4 gates x 4 units), and lane r sends them to CTA r as
//   four 16-byte st.async (one per gate; 4-byte ones for a partial or
//   unaligned warp), counted on the receiver's barrier; a CTA runs its
//   next step when its barrier has counted all 16*H bytes. Two buffers
//   suffice, as in the forward: a CTA sends message m into buffer m & 1
//   only after it received every CTA's message m-1, which each CTA sends
//   only after reading message m-2 from that buffer.
// - dh_t[k] for the CTA's units: each lane sums its k slice of the 16 rows
//   against the matching gate segment of dgates_{t+1} (a float4 of
//   dgates per gate per m, used by the gate's 4 rows), the forward's
//   butterfly leaves lane l with row l>>1's sum, and lanes 0..3 add their
//   unit's four gate sums in gate order, ((i + f) + g) + o, then dy_t.
//   The order is fixed, so a sequence's bits are the same from run to run
//   and depend neither on its slot, nor on B, nor on the split of the batch
//   over launches (there is one launch).
// - Lanes 0..3 keep their unit's dc in a register. The pre-activations are
//   prefetched two steps ahead (lane l holds its row's gate), c_{t-1} and
//   dy_{t-1} one step ahead.
// - A sequence's first step (t = T-1) receives nothing; each step sends
//   dgates_t to the next one, and with dh0 wanted step 0's dgates go to a
//   last step (t = -1) that runs the product alone: dh0 = dgates_0 W_hh.
//   A message is always awaited by the next step of the same sequence, so
//   none outlives its receiver.
// - Sequences are independent: n_clusters clusters (at most what the card
//   holds at once: 7 of 16 CTAs on an H100), cluster k taking sequences k,
//   k + n_clusters, ...; as in the forward, a cluster runs S = 1 or 2 of
//   them side by side, so B up to twice the cluster count runs in one
//   wave: it takes them in rounds of S, slot j with dgates buffers and
//   mbarriers of its own, and steps a round's sequences together (one pass
//   over the weights for both, one wait); their accumulators take the
//   registers of two W_hh columns per warp, which move to shared memory
//   (reg_rows). The product, the cells and the exchange (16*H bytes per
//   sequence into every CTA) are still paid per sequence: a step of two
//   costs about 1.55 steps of one on an H100 (PERF.md §6).
// - No grid barrier, no partial sums through L2, no scratch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int UNITS_PER_WARP = 4;
constexpr int ROWS_PER_WARP = 4 * UNITS_PER_WARP;      // 16 W_hh columns
constexpr int MAX_UNITS = WARPS * UNITS_PER_WARP;      // 32 units per CTA
constexpr int REG_ROWS = 12;                // rows in registers (S = 1)
constexpr int KCHUNK = 128;                            // k per float4 x 32
constexpr int MAX_KM = 4;                              // H <= 512
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_SEQS = 2;                            // sequences per cluster
static_assert(REG_ROWS > 0 && REG_ROWS <= ROWS_PER_WARP, "REG_ROWS");

__host__ __device__ constexpr int k_chunks(int H) {
  return (H + KCHUNK - 1) / KCHUNK;
}

// W_hh columns per warp held in registers: 12 of 16 with one sequence per
// cluster; with two, their accumulators take the registers of two columns
__host__ __device__ constexpr int reg_rows(int S) {
  return S == 1 ? REG_ROWS : REG_ROWS - 2;
}

// shared W columns, two dgates buffers (4 gate segments each) and two
// mbarriers per sequence slot
__host__ __device__ constexpr size_t smem_bytes(int H, int S) {
  return ((size_t)WARPS * (ROWS_PER_WARP - reg_rows(S)) + 2 * S * 4) *
             k_chunks(H) * KCHUNK * sizeof(float) +
         2 * S * sizeof(uint64_t);
}

template <int KM, int S>
__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_cluster_kernel(const float* __restrict__ pre,
                        const float* __restrict__ c_seq,
                        const float* __restrict__ c0,
                        const float* __restrict__ dy,
                        const float* __restrict__ dc_last,
                        const float* __restrict__ w_hh,
                        float* __restrict__ dgates, float* __restrict__ dh0,
                        float* __restrict__ dc0, int B, int T, int H, int U) {
  constexpr int HP = KM * KCHUNK;
  constexpr int GP = 4 * HP;                  // one dgates buffer
  constexpr int RR = reg_rows(S);             // columns in registers
  constexpr int SR = ROWS_PER_WARP - RR;      // columns in shared memory
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                          // [WARPS][SR][HP]
  float* g_s = w_s + WARPS * SR * HP;         // [S][2][4][HP]: dgates_{t+1}
  uint64_t* bar = reinterpret_cast<uint64_t*>(g_s + 2 * S * GP);  // [S][2]

  const unsigned rank = cluster_rank();
  const unsigned csize = cluster_size();
  const int cl = blockIdx.x / csize;
  const int n_cl = gridDim.x / csize;
  const int u0 = (int)rank * U;
  const int nu = min(U, H - u0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int H4 = 4 * H;
  const unsigned msg_bytes = 16u * H;  // what every CTA receives per step

  // warp row q = g*4 + jj: W_hh[g*H + k, u0 + warp*4 + jj] over k
  auto w_col = [&](int q) -> const float* {
    const int lu = warp * UNITS_PER_WARP + (q & 3);
    return lu < nu ? w_hh + (size_t)(q >> 2) * H * H + u0 + lu : nullptr;
  };
  auto w_at = [&](const float* col, int k) -> float {
    return (col != nullptr && k < H) ? col[(size_t)k * H] : 0.f;
  };

  float4 wr[RR][KM];
#pragma unroll
  for (int q = 0; q < RR; ++q) {
    const float* col = w_col(q);
#pragma unroll
    for (int m = 0; m < KM; ++m) {
      const int k = m * KCHUNK + 4 * lane;
      wr[q][m] = make_float4(w_at(col, k), w_at(col, k + 1), w_at(col, k + 2),
                             w_at(col, k + 3));
    }
  }
  for (int q = 0; q < SR; ++q) {
    const float* col = w_col(RR + q);
    float* dst = w_s + (warp * SR + q) * HP;
    for (int k = lane; k < HP; k += 32) dst[k] = w_at(col, k);
  }
  for (int e = threadIdx.x; e < 2 * S * GP; e += THREADS) g_s[e] = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * S; ++i) {
      mbar_init(bar + i, 1);
      mbar_expect_tx(bar + i, msg_bytes);  // the first message into buffer i
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA of the cluster is running, with its buffers zeroed and its
  // barriers armed, before any CTA sends into them
  cluster_arrive();
  cluster_wait();

  // after the butterfly, lane l holds the sum of warp row l >> 1 (both
  // lanes of a pair); its pre-activation is pre[b, t, g*H + u0 + lu]
  const int my_q = lane >> 1;
  const int my_lu = warp * UNITS_PER_WARP + (my_q & 3);
  const bool my_valid = my_lu < nu;
  const size_t my_col = (size_t)(my_q >> 2) * H + u0 + my_lu;
  // lanes 0..3 run the cell of unit warp_u + lane; lane r < csize sends
  // the warp's 16 dgates to CTA r
  const int warp_u = u0 + warp * UNITS_PER_WARP;  // global unit of lane 0
  const int warp_nu = max(0, min(UNITS_PER_WARP, nu - warp * UNITS_PER_WARP));
  const bool cell = lane < warp_nu;
  const bool vec_send = warp_nu == UNITS_PER_WARP && warp_u % 4 == 0;
  const bool sender = lane < (int)csize && warp_nu > 0;
  const uint32_t g_remote = sender ? map_rank(smem_addr(g_s + warp_u), lane) : 0;
  const uint32_t bar_remote = sender ? map_rank(smem_addr(bar), lane) : 0;
  const bool grad_h0 = dh0 != nullptr;

  // The cluster runs its sequences (cl, cl + n_clusters, ...: n_seq of
  // them) in rounds of S, slot j taking the round's j-th, and steps the
  // round's sequences together. msg counts the messages sent: message m
  // of slot j goes into the slot's buffer m & 1, whose phase (m >> 1) & 1
  // completes when all of it has arrived; the next step of the same
  // sequence awaits it.
  const int n_seq = (B - cl + n_cl - 1) / n_cl;
  unsigned msg = 0;
  for (int i0 = 0; i0 < n_seq; i0 += S) {
    const int n_on = min(S, n_seq - i0);  // the round's active slots
    int b[S];
    float xv[S], xv1[S];         // pre of steps t and t-1 (lane's row)
    float ct[S], cp[S], dyv[S];  // c_t, c_{t-1}, dy_t (cell lanes)
    float dc[S];                 // dc_{t+1} f_{t+1} (cell lanes)
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const bool on = j < n_on;
      b[j] = cl + (i0 + (on ? j : 0)) * n_cl;
      const size_t bt = (size_t)b[j] * T + (T - 1);
      const size_t cu = (size_t)b[j] * H + warp_u + lane;
      xv[j] = (on && my_valid) ? __ldg(pre + bt * H4 + my_col) : 0.f;
      xv1[j] = (on && my_valid && T > 1) ? __ldg(pre + (bt - 1) * H4 + my_col)
                                         : 0.f;
      const bool mine = on && cell;
      ct[j] = mine ? c_seq[bt * H + warp_u + lane] : 0.f;
      cp[j] = !mine ? 0.f
              : T > 1 ? c_seq[(bt - 1) * H + warp_u + lane]
              : c0 != nullptr ? c0[cu] : 0.f;
      dyv[j] = mine ? dy[bt * H + warp_u + lane] : 0.f;
      dc[j] = (mine && dc_last != nullptr) ? dc_last[cu] : 0.f;
    }
    for (int t = T - 1; t >= (grad_h0 ? -1 : 0); --t) {
      const bool recur = t < T - 1;  // dgates_{t+1} exists
      float rec[S];                  // dgates_{t+1} W_hh, this lane's unit
#pragma unroll
      for (int j = 0; j < S; ++j) rec[j] = 0.f;
      if (recur) {
        const unsigned m = msg - 1;  // sent by the step before
        const unsigned cb = m & 1;
#pragma unroll
        for (int j = 0; j < S; ++j)
          if (j < n_on) mbar_wait(bar + 2 * j + cb, (m >> 1) & 1);
        __syncthreads();  // all threads saw this phase before it is re-armed
        if (threadIdx.x == 0) {
#pragma unroll
          for (int j = 0; j < S; ++j)
            if (j < n_on) mbar_expect_tx(bar + 2 * j + cb, msg_bytes);
        }
        // the round's sequences side by side: one pass over the weights,
        // each sequence's rows summed in the one-sequence order
        float acc[S][ROWS_PER_WARP];
#pragma unroll
        for (int j = 0; j < S; ++j)
#pragma unroll
          for (int q = 0; q < ROWS_PER_WARP; ++q) acc[j][q] = 0.f;
#pragma unroll
        for (int mm = 0; mm < KM; ++mm) {
          const int k = mm * KCHUNK + 4 * lane;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float4 d4[S];
#pragma unroll
            for (int j = 0; j < S; ++j)
              d4[j] = *reinterpret_cast<const float4*>(
                  g_s + (2 * j + cb) * GP + g * HP + k);
#pragma unroll
            for (int jj = 0; jj < UNITS_PER_WARP; ++jj) {
              const int q = g * UNITS_PER_WARP + jj;
              if (q < RR) {
#pragma unroll
                for (int j = 0; j < S; ++j)
                  acc[j][q] = dot4(wr[q][mm], d4[j], acc[j][q]);
              } else {
                const float4 w4 = *reinterpret_cast<const float4*>(
                    w_s + (warp * SR + q - RR) * HP + k);
#pragma unroll
                for (int j = 0; j < S; ++j)
                  acc[j][q] = dot4(w4, d4[j], acc[j][q]);
              }
            }
          }
        }
        const int jj = lane & 3;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const float v = butterfly16(acc[j], lane);
          // the unit's four gate sums, in gate order
          const float r0 = __shfl_sync(0xffffffffu, v, 2 * (0 * 4 + jj));
          const float r1 = __shfl_sync(0xffffffffu, v, 2 * (1 * 4 + jj));
          const float r2 = __shfl_sync(0xffffffffu, v, 2 * (2 * 4 + jj));
          const float r3 = __shfl_sync(0xffffffffu, v, 2 * (3 * 4 + jj));
          rec[j] = ((r0 + r1) + r2) + r3;
        }
      }
      if (t < 0) {  // the last step: dh0 = dgates_0 W_hh
#pragma unroll
        for (int j = 0; j < S; ++j)
          if (j < n_on && cell) dh0[(size_t)b[j] * H + warp_u + lane] = rec[j];
        continue;
      }
      const int jj = lane & 3;
      const bool send = t > 0 || grad_h0;
      const unsigned nb = msg & 1;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const float a_i = __shfl_sync(0xffffffffu, xv[j], 2 * (0 * 4 + jj));
        const float a_f = __shfl_sync(0xffffffffu, xv[j], 2 * (1 * 4 + jj));
        const float a_g = __shfl_sync(0xffffffffu, xv[j], 2 * (2 * 4 + jj));
        const float a_o = __shfl_sync(0xffffffffu, xv[j], 2 * (3 * 4 + jj));
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        if (lane < UNITS_PER_WARP) {
          float dh = dyv[j];
          if (recur) dh += rec[j];
          const float i = sigmoidf(a_i);
          const float f = sigmoidf(a_f);
          const float g = tanhf(a_g);
          const float o = sigmoidf(a_o);
          const float tc = tanhf(ct[j]);
          dc[j] = fmaf(dh * o, 1.f - tc * tc, dc[j]);
          d[0] = dc[j] * g * (i * (1.f - i));
          d[1] = dc[j] * cp[j] * (f * (1.f - f));
          d[2] = dc[j] * i * (1.f - g * g);
          d[3] = dh * tc * (o * (1.f - o));
          dc[j] *= f;
        }
        const size_t bt = (size_t)b[j] * T + t;
        if (j < n_on && cell) {
          float* out = dgates + bt * H4 + warp_u + lane;
#pragma unroll
          for (int g = 0; g < 4; ++g) out[(size_t)g * H] = d[g];
          if (t == 0 && dc0 != nullptr)
            dc0[(size_t)b[j] * H + warp_u + lane] = dc[j];
        }
        if (send) {
          // every lane gets the warp's 16 dgates; lane r sends them to CTA r
          float hw[4][UNITS_PER_WARP];
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int u = 0; u < UNITS_PER_WARP; ++u)
              hw[g][u] = __shfl_sync(0xffffffffu, d[g], u);
          if (j < n_on && sender) {
            const uint32_t dst = g_remote + (2 * j + nb) * GP * 4;
            const uint32_t nbar = bar_remote + (2 * j + nb) * 8;
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              if (vec_send) {
                st_async4(dst + g * HP * 4, hw[g][0], hw[g][1], hw[g][2],
                          hw[g][3], nbar);
              } else {
#pragma unroll
                for (int u = 0; u < UNITS_PER_WARP; ++u)
                  if (u < warp_nu)
                    st_async(dst + (g * HP + u) * 4, hw[g][u], nbar);
              }
            }
          }
        }
        // the next step's inputs: pre of t-2 (two ahead), c_{t-2}, dy_{t-1}
        const bool mine = j < n_on && cell;
        xv[j] = xv1[j];
        xv1[j] = (j < n_on && my_valid && t >= 2)
                     ? __ldg(pre + (bt - 2) * H4 + my_col) : 0.f;
        ct[j] = cp[j];
        if (mine && t >= 1) {
          cp[j] = t >= 2 ? c_seq[(bt - 2) * H + warp_u + lane]
                  : c0 != nullptr ? c0[(size_t)b[j] * H + warp_u + lane]
                  : 0.f;
          dyv[j] = dy[(bt - 1) * H + warp_u + lane];
        }
      }
      if (send) ++msg;
    }
  }
}

template <int KM, int S>
cudaError_t prepare(int H, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_cluster_kernel<KM, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(H, S)));
  if (err != cudaSuccess) return err;
  if (cluster > 8)
    err = cudaFuncSetAttribute(lstm_bwd_cluster_kernel<KM, S>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

cudaLaunchConfig_t config(int H, int S, int cluster, int n_clusters,
                          cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(H, S);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// (both instantiations run at the launch bound's one CTA per SM; asked of
// the one with two slots, which takes the most shared memory)
template <int KM>
int max_clusters(int H, int cluster) {
  cudaError_t err = prepare<KM, MAX_SEQS>(H, cluster);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(H, MAX_SEQS, cluster, 1, &attr,
                                        nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, lstm_bwd_cluster_kernel<KM, MAX_SEQS>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <int KM, int S>
int launch_as(const float* pre, const float* c_seq, const float* c0,
              const float* dy, const float* dc_last, const float* w_hh,
              float* dgates, float* dh0, float* dc0, int B, int T, int H,
              int cluster, int U, int n_clusters, cudaStream_t stream) {
  cudaError_t err = prepare<KM, S>(H, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(H, S, cluster, n_clusters, &attr,
                                        stream);
  err = cudaLaunchKernelEx(&cfg, lstm_bwd_cluster_kernel<KM, S>, pre, c_seq,
                           c0, dy, dc_last, w_hh, dgates, dh0, dc0, B, T, H,
                           U);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int KM>
int launch(const float* pre, const float* c_seq, const float* c0,
           const float* dy, const float* dc_last, const float* w_hh,
           float* dgates, float* dh0, float* dc0, int B, int T, int H,
           int cluster, int U, int S, int n_clusters, cudaStream_t stream) {
  if (S == 2)
    return launch_as<KM, 2>(pre, c_seq, c0, dy, dc_last, w_hh, dgates, dh0,
                            dc0, B, T, H, cluster, U, n_clusters, stream);
  return launch_as<KM, 1>(pre, c_seq, c0, dy, dc_last, w_hh, dgates, dh0,
                          dc0, B, T, H, cluster, U, n_clusters, stream);
}

template <int KM>
int attributes(int S, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, S == 2 ? reinterpret_cast<const void*>(lstm_bwd_cluster_kernel<KM, 2>)
                 : reinterpret_cast<const void*>(lstm_bwd_cluster_kernel<KM, 1>));
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

bool valid_h(int H) { return H >= 1 && H <= MAX_KM * KCHUNK; }

bool valid_s(int S) { return S >= 1 && S <= MAX_SEQS; }

}  // namespace

extern "C" {

const char* lstm_bwd_cluster_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Layout constants, for the wrapper's plan and its checks.
int lstm_bwd_cluster_units_per_cta_max() { return MAX_UNITS; }
int lstm_bwd_cluster_max_cluster() { return MAX_CLUSTER; }
int lstm_bwd_cluster_reg_rows(int S) {
  return valid_s(S) ? reg_rows(S) : -1;
}
int lstm_bwd_cluster_threads() { return THREADS; }
int lstm_bwd_cluster_max_seqs() { return MAX_SEQS; }
int lstm_bwd_cluster_smem_bytes(int H, int S) {
  return valid_h(H) && valid_s(S) ? static_cast<int>(smem_bytes(H, S)) : -1;
}

// How many clusters of `cluster` CTAs the card holds at once (negative: a
// CUDA error).
int lstm_bwd_cluster_max_clusters(int H, int cluster) {
  if (!valid_h(H) || cluster < 1 || cluster > MAX_CLUSTER)
    return -static_cast<int>(cudaErrorInvalidValue);
  switch (k_chunks(H)) {
    case 1: return max_clusters<1>(H, cluster);
    case 2: return max_clusters<2>(H, cluster);
    case 3: return max_clusters<3>(H, cluster);
    default: return max_clusters<4>(H, cluster);
  }
}

// Registers per thread and local (spill) bytes of the kernel for H with S
// sequences per cluster.
int lstm_bwd_cluster_attributes(int H, int S, int* regs, int* local_bytes) {
  if (!valid_h(H) || !valid_s(S)) return cudaErrorInvalidValue;
  switch (k_chunks(H)) {
    case 1: return attributes<1>(S, regs, local_bytes);
    case 2: return attributes<2>(S, regs, local_bytes);
    case 3: return attributes<3>(S, regs, local_bytes);
    default: return attributes<4>(S, regs, local_bytes);
  }
}

// pre [B, T, 4H] (the forward's pre-activations), c_seq [B, T, H] (its cell
// states), dy [B, T, H] (the gradient of its h outputs), w_hh [4H, H],
// dgates [B, T, 4H] (out), all contiguous f32; c0 [B, H], the initial cell
// state (null: zero), dc_last [B, H], the gradient of the final c (null:
// zero), dh0 and dc0 [B, H], the gradients of the initial state (null: not
// written). The plan: clusters of `cluster` CTAs, CTA r owning units
// [r*U, r*U+U), `n_clusters` clusters sharing the batch, each running S
// sequences side by side.
int lstm_bwd_cluster_launch(const float* pre, const float* c_seq,
                            const float* c0, const float* dy,
                            const float* dc_last, const float* w_hh,
                            float* dgates, float* dh0, float* dc0, int B,
                            int T, int H, int cluster, int U, int S,
                            int n_clusters, void* stream) {
  if (B == 0 || T == 0) return 0;
  if (!valid_h(H) || cluster < 1 || cluster > MAX_CLUSTER || U < 1 ||
      U > MAX_UNITS || cluster * U < H || (cluster - 1) * U >= H ||
      !valid_s(S) || n_clusters < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k_chunks(H)) {
    case 1:
      return launch<1>(pre, c_seq, c0, dy, dc_last, w_hh, dgates, dh0, dc0,
                       B, T, H, cluster, U, S, n_clusters, st);
    case 2:
      return launch<2>(pre, c_seq, c0, dy, dc_last, w_hh, dgates, dh0, dc0,
                       B, T, H, cluster, U, S, n_clusters, st);
    case 3:
      return launch<3>(pre, c_seq, c0, dy, dc_last, w_hh, dgates, dh0, dc0,
                       B, T, H, cluster, U, S, n_clusters, st);
    default:
      return launch<4>(pre, c_seq, c0, dy, dc_last, w_hh, dgates, dh0, dc0,
                       B, T, H, cluster, U, S, n_clusters, st);
  }
}

}  // extern "C"
