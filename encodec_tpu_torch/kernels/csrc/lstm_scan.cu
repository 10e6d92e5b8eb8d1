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
// - Above that count a cluster may run S = 2 sequences side by side (the
//   wrapper's plan takes S = 2, on ceil(B / 2) clusters at most the count,
//   only where its rounds cost less than more waves of one sequence per
//   cluster: B <= 14 at H=512 runs in one wave instead of two, B = 15-21
//   stays at three waves of one). The cluster takes its sequences in
//   rounds of S, slot j with h buffers and mbarriers of its own, and steps
//   a round's sequences together (lstm_scan_kernel_pair): one pass over
//   the weights feeds both sequences' accumulators (a row in shared memory
//   is loaded once for both), the two butterflies and cell updates are
//   independent chains, and one wait serves both. The product's FMAs, the
//   cells' IEEE expf/tanhf and the exchange are still paid per sequence,
//   so a step of two costs about 1.7 steps of one on an H100 (PERF.md
//   §6), not one. The two sequences' accumulators take the registers of
//   two W_hh rows per warp, which move to shared memory (reg_rows). Each
//   sequence's rows are summed in the one-sequence order, so its bits
//   depend neither on its slot nor on S nor on B.
// - The one-sequence kernel is a kernel of its own, not the pair's body at
//   S = 1: that instantiation took 3-6% longer per step at B = 1, 4 and
//   15-21 (H100, PERF.md §6), on the 24 kHz path and the stream.
// - H > 512 is not taken here (the k slice of a lane is at most 4
//   float4s, and no cluster holds a larger W_hh: 16 MiB at H=1024).
//   lstm_grid.cu takes 512 < H <= 1024, the breathing configurations,
//   with W_hh spread over a cooperative grid of one CTA per SM and h
//   exchanged through L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

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

constexpr int MAX_SEQS = 2;                            // sequences per cluster

// W_hh rows per warp held in registers: 12 of 16 with one sequence per
// cluster; with two, their accumulators take the registers of two rows
__host__ __device__ constexpr int reg_rows(int S) {
  return S == 1 ? REG_ROWS : REG_ROWS - 2;
}

// shared W rows, two h buffers and two mbarriers per sequence slot
__host__ __device__ constexpr size_t smem_bytes(int H, int S) {
  return ((size_t)WARPS * (ROWS_PER_WARP - reg_rows(S)) + 2 * S) *
             k_chunks(H) * KCHUNK * sizeof(float) +
         2 * S * sizeof(uint64_t);
}

// One sequence per cluster: the kernel of the 24 kHz path, the stream and
// every launch of B up to the card's cluster count.
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

// Two sequences per cluster (above the card's cluster count): the same
// exchange, one pass over the weights for both sequences of a round.
template <int KM, bool STATE, bool SAVE>
__global__ void __launch_bounds__(THREADS, 1)
lstm_scan_kernel_pair(const float* __restrict__ xp,
                      const float* __restrict__ w_hh,
                      const float* __restrict__ h0,
                      const float* __restrict__ c0, float* __restrict__ out,
                      float* __restrict__ c_out, float* __restrict__ c_seq,
                      int B, int T, int H, int U) {
  constexpr int S = MAX_SEQS;
  constexpr int HP = KM * KCHUNK;
  constexpr int RR = reg_rows(S);             // rows in registers
  constexpr int SR = ROWS_PER_WARP - RR;      // rows in shared memory
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                          // [WARPS][SR][HP]
  float* h_s = w_s + WARPS * SR * HP;         // [S][2][HP]: h_{t-1}, zero pad
  uint64_t* bar = reinterpret_cast<uint64_t*>(h_s + 2 * S * HP);  // [S][2]

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

  float4 wr[RR][KM];
#pragma unroll
  for (int q = 0; q < RR; ++q) {
    const float* row = w_row(q);
#pragma unroll
    for (int m = 0; m < KM; ++m) {
      const int k = m * KCHUNK + 4 * lane;
      wr[q][m] = make_float4(w_at(row, k), w_at(row, k + 1), w_at(row, k + 2),
                             w_at(row, k + 3));
    }
  }
  for (int q = 0; q < SR; ++q) {
    const float* row = w_row(RR + q);
    float* dst = w_s + (warp * SR + q) * HP;
    for (int k = lane; k < HP; k += 32) dst[k] = w_at(row, k);
  }
  for (int e = threadIdx.x; e < 2 * S * HP; e += THREADS) h_s[e] = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * S; ++i) {
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
  const int warp_u = u0 + warp * UNITS_PER_WARP;  // global unit of lane 0
  const int warp_nu = max(0, min(UNITS_PER_WARP, nu - warp * UNITS_PER_WARP));
  const bool vec_send = warp_nu == UNITS_PER_WARP && warp_u % 4 == 0;
  const bool sender = lane < (int)csize && warp_nu > 0;
  const uint32_t h_remote = sender ? map_rank(smem_addr(h_s + warp_u), lane) : 0;
  const uint32_t bar_remote = sender ? map_rank(smem_addr(bar), lane) : 0;

  // The cluster runs its sequences (cl, cl + n_clusters, ...: n_seq of
  // them) in rounds of S, slot j taking the round's j-th, and steps the
  // round's sequences together: step s waits for every active slot's
  // buffer s & 1 (sent at step s-1) and sends into (s+1) & 1. A slot is
  // active in a prefix of the rounds; its last step sends nothing, so
  // every message is awaited by a live CTA. Step 0 of a sequence with a
  // state overwrites its slot's buffer s & 1 with h0[b]: the message it
  // awaited (the slot's previous sequence's last h) has fully arrived, and
  // the next one into that buffer is sent only after every CTA has
  // received this step's h, so nothing else writes it meanwhile.
  const int n_seq = (B - cl + n_cl - 1) / n_cl;
  const bool stateful = STATE && h0 != nullptr;
  unsigned n_steps[S];  // the slot's steps in all
#pragma unroll
  for (int j = 0; j < S; ++j)
    n_steps[j] = (unsigned)max(0, (n_seq - j + S - 1) / S) * T;
  unsigned phase = 0;  // bit i: parity of the buffers i's next phase
  unsigned s = 0;
  for (int i0 = 0; i0 < n_seq; i0 += S) {
    const int n_on = min(S, n_seq - i0);  // the round's active slots
    int b[S];
    const float* xrow[S];
    float xv[S], xv1[S], c[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const bool on = j < n_on;
      b[j] = cl + (i0 + (on ? j : 0)) * n_cl;
      xrow[j] = xp + (size_t)b[j] * T * H4 + my_col;
      // gate inputs of steps t and t+1, prefetched two steps ahead
      xv[j] = (on && my_valid) ? __ldg(xrow[j]) : 0.f;
      xv1[j] = (on && my_valid && T > 1) ? __ldg(xrow[j] + H4) : 0.f;
      // lanes 0..3 keep the cell state of unit warp*4 + lane
      c[j] = (on && STATE && c0 != nullptr && lane < warp_nu)
                 ? c0[(size_t)b[j] * H + warp_u + lane] : 0.f;
    }
    for (int t = 0; t < T; ++t, ++s) {
      const unsigned cb = s & 1;
      if (s > 0) {
#pragma unroll
        for (int j = 0; j < S; ++j)
          if (j < n_on) mbar_wait(bar + 2 * j + cb, (phase >> cb) & 1);
        phase ^= 1u << cb;
        __syncthreads();  // all threads saw this phase before it is re-armed
        if (threadIdx.x == 0) {
#pragma unroll
          for (int j = 0; j < S; ++j)
            if (j < n_on) mbar_expect_tx(bar + 2 * j + cb, h_bytes);
        }
      }
      if (stateful && t == 0) {
        // h_{-1} = h0[b]; the zero padding past H stays as it is
#pragma unroll
        for (int j = 0; j < S; ++j) {
          if (j >= n_on) continue;
          float* hb = h_s + (2 * j + cb) * HP;
          for (int k = threadIdx.x; k < H; k += THREADS)
            hb[k] = h0[(size_t)b[j] * H + k];
        }
        __syncthreads();
      }
      float v[S];
#pragma unroll
      for (int j = 0; j < S; ++j) v[j] = 0.f;  // zero state: step 0's term
      if (t > 0 || stateful) {
        // the round's sequences side by side: one pass over the weights,
        // each sequence's rows summed in the one-sequence order
        float acc[S][ROWS_PER_WARP];
#pragma unroll
        for (int j = 0; j < S; ++j)
#pragma unroll
          for (int q = 0; q < ROWS_PER_WARP; ++q) acc[j][q] = 0.f;
#pragma unroll
        for (int m = 0; m < KM; ++m) {
          const int k = m * KCHUNK + 4 * lane;
          float4 h4[S];
#pragma unroll
          for (int j = 0; j < S; ++j)
            h4[j] = *reinterpret_cast<const float4*>(
                h_s + (2 * j + cb) * HP + k);
#pragma unroll
          for (int q = 0; q < RR; ++q)
#pragma unroll
            for (int j = 0; j < S; ++j)
              acc[j][q] = dot4(wr[q][m], h4[j], acc[j][q]);
#pragma unroll
          for (int q = 0; q < SR; ++q) {
            const float4 w4 = *reinterpret_cast<const float4*>(
                w_s + (warp * SR + q) * HP + k);
#pragma unroll
            for (int j = 0; j < S; ++j)
              acc[j][RR + q] = dot4(w4, h4[j], acc[j][RR + q]);
          }
        }
#pragma unroll
        for (int j = 0; j < S; ++j) v[j] = butterfly16(acc[j], lane);
      }
      // the slots' gates, cells and sends side by side (one basic block
      // each), so that their latency chains overlap
      const int jj = lane & 3;
      float gi[S], gf[S], gg[S], go[S], h[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const float vj = xv[j] + v[j];  // gates_t = xp_t + h_{t-1} W_hh^T
        gi[j] = __shfl_sync(0xffffffffu, vj, 2 * (0 * 4 + jj));
        gf[j] = __shfl_sync(0xffffffffu, vj, 2 * (1 * 4 + jj));
        gg[j] = __shfl_sync(0xffffffffu, vj, 2 * (2 * 4 + jj));
        go[j] = __shfl_sync(0xffffffffu, vj, 2 * (3 * 4 + jj));
        h[j] = 0.f;
      }
      if (lane < UNITS_PER_WARP) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          c[j] = sigmoidf(gf[j]) * c[j] + sigmoidf(gi[j]) * tanhf(gg[j]);
          h[j] = sigmoidf(go[j]) * tanhf(c[j]);
        }
      }
      float hw[S][UNITS_PER_WARP];
#pragma unroll
      for (int j = 0; j < S; ++j)
#pragma unroll
        for (int u = 0; u < UNITS_PER_WARP; ++u)
          hw[j][u] = __shfl_sync(0xffffffffu, h[j], u);
      if (sender) {
        const unsigned nb = (s + 1) & 1;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          if (j >= n_on || s + 1 >= n_steps[j]) continue;
          const uint32_t dst = h_remote + (2 * j + nb) * HP * 4;
          const uint32_t nbar = bar_remote + (2 * j + nb) * 8;
          if (vec_send) {
            st_async4(dst, hw[j][0], hw[j][1], hw[j][2], hw[j][3], nbar);
          } else {
#pragma unroll
            for (int u = 0; u < UNITS_PER_WARP; ++u)
              if (u < warp_nu) st_async(dst + 4 * u, hw[j][u], nbar);
          }
        }
      }
      if (lane < warp_nu) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          if (j >= n_on) continue;
          const size_t o = ((size_t)b[j] * T + t) * H + warp_u + lane;
          out[o] = h[j];
          if (SAVE) c_seq[o] = c[j];
          if (STATE && c_out != nullptr && t == T - 1)
            c_out[(size_t)b[j] * H + warp_u + lane] = c[j];
        }
      }
#pragma unroll
      for (int j = 0; j < S; ++j) {
        xv[j] = xv1[j];
        xv1[j] = (j < n_on && my_valid && t + 2 < T)
                     ? __ldg(xrow[j] + (size_t)(t + 2) * H4) : 0.f;
      }
    }
  }
}

using KernelFn = void (*)(const float*, const float*, const float*,
                         const float*, float*, float*, float*, int, int, int,
                         int);

// the kernel for S sequences per cluster
template <int KM, bool STATE, bool SAVE, int S>
constexpr KernelFn kernel_fn() {
  if constexpr (S == 1) return lstm_scan_kernel<KM, STATE, SAVE>;
  else return lstm_scan_kernel_pair<KM, STATE, SAVE>;
}

template <int KM, bool STATE, bool SAVE, int S>
cudaError_t prepare(int H, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel_fn<KM, STATE, SAVE, S>(),
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(H, S)));
  if (err != cudaSuccess) return err;
  if (cluster > 8)
    err = cudaFuncSetAttribute(kernel_fn<KM, STATE, SAVE, S>(),
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

// (every instantiation runs at the launch bound's one CTA per SM; asked of
// the saving one with two slots, which takes the most shared memory)
template <int KM>
int max_clusters(int H, int cluster) {
  cudaError_t err = prepare<KM, true, true, MAX_SEQS>(H, cluster);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(H, MAX_SEQS, cluster, 1, &attr,
                                        nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, kernel_fn<KM, true, true, MAX_SEQS>(), &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <int KM, bool STATE, bool SAVE, int S>
int launch_as(const float* xp, const float* w_hh, const float* h0,
              const float* c0, float* out, float* c_out, float* c_seq, int B,
              int T, int H, int cluster, int U, int n_clusters,
              cudaStream_t stream) {
  cudaError_t err = prepare<KM, STATE, SAVE, S>(H, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(H, S, cluster, n_clusters, &attr,
                                        stream);
  err = cudaLaunchKernelEx(&cfg, kernel_fn<KM, STATE, SAVE, S>(), xp, w_hh,
                           h0, c0, out, c_out, c_seq, B, T, H, U);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int KM, int S>
int launch_seqs(const float* xp, const float* w_hh, const float* h0,
                const float* c0, float* out, float* c_out, float* c_seq,
                int B, int T, int H, int cluster, int U, int n_clusters,
                cudaStream_t stream) {
  if (c_seq != nullptr)
    return launch_as<KM, true, true, S>(xp, w_hh, h0, c0, out, c_out, c_seq,
                                        B, T, H, cluster, U, n_clusters,
                                        stream);
  if (h0 != nullptr || c_out != nullptr)
    return launch_as<KM, true, false, S>(xp, w_hh, h0, c0, out, c_out, c_seq,
                                         B, T, H, cluster, U, n_clusters,
                                         stream);
  return launch_as<KM, false, false, S>(xp, w_hh, h0, c0, out, c_out, c_seq,
                                        B, T, H, cluster, U, n_clusters,
                                        stream);
}

// the saving instantiation when every step's c is stored, else the state
// instantiation when a state is read or written; S sequences per cluster
template <int KM>
int launch(const float* xp, const float* w_hh, const float* h0,
           const float* c0, float* out, float* c_out, float* c_seq, int B,
           int T, int H, int cluster, int U, int S, int n_clusters,
           cudaStream_t stream) {
  if (S == 2)
    return launch_seqs<KM, 2>(xp, w_hh, h0, c0, out, c_out, c_seq, B, T, H,
                              cluster, U, n_clusters, stream);
  return launch_seqs<KM, 1>(xp, w_hh, h0, c0, out, c_out, c_seq, B, T, H,
                            cluster, U, n_clusters, stream);
}

template <int KM, int S>
const void* variant_fn(int variant) {
  return reinterpret_cast<const void*>(
      variant == 2   ? kernel_fn<KM, true, true, S>()
      : variant == 1 ? kernel_fn<KM, true, false, S>()
                     : kernel_fn<KM, false, false, S>());
}

template <int KM>
int attributes(int variant, int S, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, S == 2 ? variant_fn<KM, 2>(variant) : variant_fn<KM, 1>(variant));
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

bool valid_h(int H) { return H >= 1 && H <= MAX_KM * KCHUNK; }

bool valid_s(int S) { return S >= 1 && S <= MAX_SEQS; }

}  // namespace

extern "C" {

const char* lstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Layout constants, for the wrapper's plan and its checks.
int lstm_scan_units_per_cta_max() { return MAX_UNITS; }
int lstm_scan_max_cluster() { return MAX_CLUSTER; }
int lstm_scan_reg_rows(int S) { return valid_s(S) ? reg_rows(S) : -1; }
int lstm_scan_threads() { return THREADS; }
int lstm_scan_max_seqs() { return MAX_SEQS; }
int lstm_scan_smem_bytes(int H, int S) {
  return valid_h(H) && valid_s(S) ? static_cast<int>(smem_bytes(H, S)) : -1;
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
// saving one (2), with S sequences per cluster.
int lstm_scan_attributes(int H, int state, int S, int* regs,
                         int* local_bytes) {
  if (!valid_h(H) || state < 0 || state > 2 || !valid_s(S))
    return cudaErrorInvalidValue;
  switch (k_chunks(H)) {
    case 1: return attributes<1>(state, S, regs, local_bytes);
    case 2: return attributes<2>(state, S, regs, local_bytes);
    case 3: return attributes<3>(state, S, regs, local_bytes);
    default: return attributes<4>(state, S, regs, local_bytes);
  }
}

// xp [B, T, 4H], w_hh [4H, H], out [B, T, H] (all contiguous f32); h0 and
// c0 [B, H], the initial state (both null: zero state), and c_out [B, H],
// the final cell state (null: not written), and c_seq [B, T, H], every
// step's cell state (null: not written). The plan: clusters of `cluster`
// CTAs, CTA r owning units [r*U, r*U+U), `n_clusters` clusters sharing
// the batch, each running S sequences side by side.
int lstm_scan_launch(const float* xp, const float* w_hh, const float* h0,
                     const float* c0, float* out, float* c_out, float* c_seq,
                     int B, int T, int H, int cluster, int U, int S,
                     int n_clusters, void* stream) {
  if (B == 0 || T == 0) return 0;
  if (!valid_h(H) || cluster < 1 || cluster > MAX_CLUSTER || U < 1 ||
      U > MAX_UNITS || cluster * U < H || (cluster - 1) * U >= H ||
      !valid_s(S) || n_clusters < 1 || (h0 == nullptr) != (c0 == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k_chunks(H)) {
    case 1:
      return launch<1>(xp, w_hh, h0, c0, out, c_out, c_seq, B, T, H,
                       cluster, U, S, n_clusters, st);
    case 2:
      return launch<2>(xp, w_hh, h0, c0, out, c_out, c_seq, B, T, H,
                       cluster, U, S, n_clusters, st);
    case 3:
      return launch<3>(xp, w_hh, h0, c0, out, c_out, c_seq, B, T, H,
                       cluster, U, S, n_clusters, st);
    default:
      return launch<4>(xp, w_hh, h0, c0, out, c_out, c_seq, B, T, H,
                       cluster, U, S, n_clusters, st);
  }
}

}  // extern "C"
