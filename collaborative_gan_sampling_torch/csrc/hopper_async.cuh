// What the refine kernels share on Hopper (sm_90a): the phase clocks of
// -DCGS_PHASE_CLOCKS builds, mbarriers and the 1-D bulk async copy (all
// three), and a ring of weight tiles in shared memory that one producer
// thread fills and consumer warps drain, in a fixed order (the two conv
// kernels).
//
// The ring: stage s holds tile it (it % STAGES == s, its (it / STAGES)-th
// use); full[s] completes when the tile's bytes have landed, empty[s] when
// every consumer warp has arrived on it. Each kernel includes this header
// once (one shared library per kernel source).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Build with -DCGS_PHASE_CLOCKS to count clock64() cycles per phase
// (conv_refine_phases.py at the repo root); the counters compile to nothing
// otherwise. Slot is a sample's (or another unit's) row of counters, one
// recording thread per slot.
#ifdef CGS_PHASE_CLOCKS
constexpr int CGS_NPHASE = 8;
constexpr int CGS_WAIT_PHASE = 6;  // ring waits, a part of the other phases
__device__ unsigned long long cgs_phase_sum[CGS_NPHASE];
__shared__ long long cgs_phase_acc[2][CGS_NPHASE];
__shared__ long long cgs_phase_last[2];
#define CGS_PHASE_BEGIN(rec, slot)                                       \
  if (rec) {                                                             \
    for (int i_ = 0; i_ < CGS_NPHASE; ++i_) cgs_phase_acc[slot][i_] = 0; \
    cgs_phase_last[slot] = clock64();                                    \
  }
#define CGS_PHASE(rec, slot, i)                          \
  if (rec) {                                             \
    const long long now_ = clock64();                    \
    cgs_phase_acc[slot][i] += now_ - cgs_phase_last[slot]; \
    cgs_phase_last[slot] = now_;                         \
  }
#define CGS_PHASE_END(rec, slot)                                   \
  if (rec) {                                                       \
    for (int i_ = 0; i_ < CGS_NPHASE; ++i_)                        \
      atomicAdd(&cgs_phase_sum[i_],                                \
                static_cast<unsigned long long>(cgs_phase_acc[slot][i_])); \
  }
extern "C" int cgs_phase_clocks(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, cgs_phase_sum,
                                         sizeof(cgs_phase_sum));
  if (err == cudaSuccess && reset) {
    unsigned long long zero[CGS_NPHASE] = {};
    err = cudaMemcpyToSymbol(cgs_phase_sum, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#else
#define CGS_PHASE_BEGIN(rec, slot)
#define CGS_PHASE(rec, slot, i)
#define CGS_PHASE_END(rec, slot)
#endif

namespace cgs {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait that makes no
// progress for ~2^35 cycles (over 15 s) traps, so a fault in the schedule
// ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1LL << 35)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// One contiguous global -> shared copy that completes `bytes` on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Thread 0 of the block, before the block's first barrier: full[s] takes
// the producer's one arrival, empty[s] one arrival per consumer warp. The
// 2 * STAGES mbarriers lie at `full`, full[] then empty[].
template <int STAGES>
__device__ __forceinline__ void ring_init(uint32_t full, int consumer_warps) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(full + 8 * s, 1);
    mbar_init(full + 8 * (STAGES + s), consumer_warps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer (one thread): `passes` passes over PASS_TILES tiles of
// TILE_BYTES each; even passes copy tiles 0 .. PASS_TILES - 1 of `src`
// (the forward's), odd passes tiles PASS_TILES .. 2 PASS_TILES - 1 (the
// VJP's).
template <int STAGES, int TILE_BYTES, int PASS_TILES>
__device__ void ring_produce(uint32_t tiles, uint32_t full,
                             const unsigned char* src, int passes) {
  const int n = passes * PASS_TILES;
  for (int it = 0; it < n; ++it) {
    const int s = it % STAGES;
    mbar_wait(full + 8 * (STAGES + s), ((it / STAGES) & 1) ^ 1);
    const int pass = it / PASS_TILES, j = it % PASS_TILES;
    const int tile = (pass & 1) ? PASS_TILES + j : j;
    mbar_expect_tx(full + 8 * s, TILE_BYTES);
    bulk_copy(tiles + s * TILE_BYTES,
              src + static_cast<size_t>(tile) * TILE_BYTES, TILE_BYTES,
              full + 8 * s);
  }
}

// The ring as a consumer warp sees it: tiles are taken in order.
template <int STAGES, int TILE_BYTES>
struct Ring {
  uint32_t tiles;  // shared address of stage 0
  uint32_t full;   // shared address of full[0]; empty[s] follows full[]
  int it;          // tiles taken so far

  // Waits for tile `it`; returns the shared address of its stage. Under
  // CGS_PHASE_CLOCKS the wait adds to counter CGS_WAIT_PHASE of `slot`
  // where `rec`.
  __device__ __forceinline__ uint32_t wait(bool rec, int slot) {
    const int s = it % STAGES;
#ifdef CGS_PHASE_CLOCKS
    const long long t0 = clock64();
#endif
    mbar_wait(full + 8 * s, (it / STAGES) & 1);
#ifdef CGS_PHASE_CLOCKS
    if (rec) cgs_phase_acc[slot][CGS_WAIT_PHASE] += clock64() - t0;
#else
    (void)rec, (void)slot;
#endif
    return tiles + s * TILE_BYTES;
  }

  // Once every lane of this warp is done reading tile `it`.
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0)
      mbar_arrive(full + 8 * (STAGES + it % STAGES));
    ++it;
  }
};

}  // namespace cgs
