// Thread-block cluster helpers shared by K3's cluster kernels (sm_90a):
// lstm_scan.cu (the forward, H <= 512) and lstm_bwd_cluster.cu (its
// backward). Each CTA of a cluster keeps a vector in a double-buffered
// array of its own shared memory; every CTA writes its slice of the next
// step's vector into every CTA's buffer with st.async, which counts the
// bytes on the receiver's mbarrier, and a CTA starts the next step when its
// barrier has counted the whole vector. The arithmetic helpers (IEEE expf,
// the 4-wide dot product, the butterfly) are here so that both directions
// sum in the same order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
template <int HALF, int N>
__device__ __forceinline__ void fold(float (&acc)[N], int lane) {
  const bool up = (lane & (2 * HALF)) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? acc[i] : acc[i + HALF];
    const float keep = up ? acc[i + HALF] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
  }
}

// 16 row partials x 32 lanes -> lane l holds the sum of row l >> 1 (both
// lanes of a pair): four folds, then the pair's two halves
__device__ __forceinline__ float butterfly16(float (&acc)[16], int lane) {
  fold<8>(acc, lane);
  fold<4>(acc, lane);
  fold<2>(acc, lane);
  fold<1>(acc, lane);
  return acc[0] + __shfl_xor_sync(0xffffffffu, acc[0], 1);
}

}  // namespace
