// Fused K-step refinement under the 28x28x1 / 64-filter DCGAN discriminator
// with bf16 matmul operands and float32 sums, on Hopper's tensor cores
// (sm_90a: wgmma, bulk async copies, mbarriers).
//
// Replaces the bf16 mode of the TPU kernel collaborative_gan_sampling_tpu/
// ops/conv_refine_pallas.py::fused_refine_conv28_v2 (_refine_kernel_v2 with
// mm_dtype bfloat16). It computes what ops/conv_refine_ref.py::
// refine_conv28_plain_bf16 computes, for the D in eval mode with BatchNorm
// folded into conv1 (the wrapper folds, rounds and packs):
//
//   K times:  x <- x - rate * d softplus(-D(x)) / dx
//   then:     logit = D(x)
//
//   D(x) = wd . lrelu(conv1(lrelu(conv0(x)))) + bd
//   conv0: 5x5 / stride 2, 1 -> 64,   28x28 -> 14x14
//   conv1: 5x5 / stride 2, 64 -> 128, 14x14 -> 7x7 (BN folded)
//
// Rounding points, as in v2: every matmul operand is rounded to bf16 (to
// nearest, ties to even) and the products are summed in f32. The operands
// are x (conv0), the post-lrelu h1 (conv1), dz2 = lrelu'(h2) * dlogit * wd
// (conv1's input-VJP), dz1 (conv0's input-VJP) and the weights w0, w1 (the
// wrapper rounds them after the fold). Biases, lrelu, the dense head, the
// sigmoid, the update and x itself stay f32. Only the order of the f32 sums
// differs from the plain version.
//
// Both convs use XLA's SAME padding (low 1, high 2): input index
// iy = 2*oy + dy - 1. The input-VJPs read the same taps as gathers,
// oy = (iy + 1 - dy) / 2 where that is an integer in range.
//
// What bounds it on this card: operations. (2K + 1) D passes of 17.36 MFLOP
// per sample (taps on the zero border not counted): 93.35 GFLOP at B = 256,
// K = 10, 0.094 ms at 989 TFLOP/s dense bf16. conv1 and its input-VJP are
// 94% of those FLOPs; each pass reads conv1's 400 KB of bf16 weights. The
// earlier kernel (one block per sample, mma.sync with weights read from L2
// in the tap loop, conv0 and its VJP as f32 FMAs) ran at 4% of that bound,
// 60% of its time in conv0 and its VJP.
//
// Design:
// - Two samples per block (one consumer warpgroup each) and one producer
//   warp; at B = 256, 128 blocks, one per SM. Per sample, shared memory
//   holds x (f32, zero-bordered 32x32 so that conv0's gather needs no range
//   test), h1 and one scratch area that is dz2 during conv1's VJP and
//   conv0's VJP partials after it; per block, the weight ring, w0 in both
//   layouts its GEMMs read, the dense head wd, the biases and a zero row
//   (what a gather reads on the border). h1 and dz2 rows hold their channels
//   permuted (slot()), so that a thread's A fragments of two k-steps are one
//   16-byte load. h2 never reaches shared memory: the conv1 epilogue keeps
//   lrelu'(h2) as a 64-bit sign mask per thread and sums the dense head from
//   the accumulators. dz1 overwrites h1 in place (each element's sign is
//   read by the thread that writes it).
// - conv1's weights stream through a ring of STAGES 16 KB tiles in shared
//   memory: the producer issues one 1-D bulk async copy per tile
//   (cp.async.bulk ... mbarrier::complete_tx), consumers wait on the tile's
//   "full" mbarrier and release it on its "empty" one (one arrival per
//   warp). Each tile feeds both samples. The schedule is fixed: 25 forward
//   taps, then the VJP's 25 taps by parity class, so the producer runs
//   ahead across phases, through the epilogues and conv0.
// - The wrapper packs w1 once per call into the exact shared-memory image
//   that wgmma's B descriptor reads (128-byte swizzle, K-major): two images,
//   forward tiles [co][ci] and VJP tiles [ci][co] in the VJP's tap order
//   (two 64-wide K atoms), 50 tiles in all. A contiguous tile needs no
//   tensor map, so the library needs no libcuda.
// - conv1's forward is wgmma m64n128k16 per tap (4 k-steps of 16 channels):
//   64 rows hold the 49 output cells, A comes from registers (the h1 rows
//   the tap reads, the zero row on the border), B from the ring. Its
//   input-VJP is wgmma m64n64k16 (8 k-steps), one GEMM per parity class
//   (iy % 2, ix % 2) of the 196 h1 cells over only the taps that reach it
//   (4, 6, 6 and 9), with A the gathered dz2 rows.
// - conv0 and its VJP are small tensor-core GEMMs on mma.sync m16n8k16:
//   the forward an im2col of bf16(x), 196 cells x 25 taps padded to K = 32,
//   against w0 (K = 32 x N = 64); the VJP dz1 (196 x 64) x w0^T (64 x 25,
//   padded to 32) into per-(cell, tap) partials, then a col2im sum per pixel
//   over its at most 9 (cell, tap) pairs in f32, and the update. Each
//   product of two bf16 values is exact in f32, so this only reorders sums;
//   im2col costs 32/25 of the direct FLOPs.
// - The rate is a runtime argument. A ragged batch leaves the last block's
//   second sample dead: it runs on zeros and writes nothing.
// - Build with -DCGS_PHASE_CLOCKS to count clock64() cycles per phase
//   (conv_refine_phases.py at the repo root); the counters compile to nothing
//   otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

using namespace cgs;

constexpr int H0 = 28, H1 = 14, H2 = 7, C1 = 64, C2 = 128, TAPS = 25;
constexpr int NX = H0 * H0;    // 784 pixels
constexpr int XS = 32;         // zero-bordered x row stride: x[iy][ix] at
constexpr int NXS = XS * XS;   //   (iy + 1) * XS + ix + 1
constexpr int NC1 = H1 * H1;   // 196 h1 cells
constexpr int NC2 = H2 * H2;   // 49 h2 cells
constexpr int K0 = 32;         // conv0's 25 taps padded to two k-steps
// h1 / dz1 and dz2 rows keep their channels permuted (slot()), so that a
// thread's A fragments of two k-steps are one 16-byte load; the strides put
// the two rows of a quarter-warp's loads in opposite halves of the banks.
constexpr int S1 = C1 + 16;    // h1 / dz1 row stride (bf16): 160 bytes
constexpr int S2 = C2 + 32;    // dz2 row stride (bf16): 320 bytes
constexpr int SP = 36;         // conv0-VJP partials row stride (f32)
constexpr int SW0T = K0 + 8;   // w0^T row stride (bf16): 20 words
constexpr int SWD = C2 + 8;    // dense-head weight row stride (f32)
constexpr int MT0 = (NC1 + 15) / 16;  // 13 m-tiles of conv0's GEMMs

constexpr int SAMPLES = 2;               // per block, one warpgroup each
constexpr int THREADS = SAMPLES * 128 + 32;  // + the producer warp
constexpr int STAGES = 4;                // ring of conv1 weight tiles
constexpr int TILE_ELEMS = C1 * C2;      // one tap: 64 x 128 bf16
constexpr int TILE_BYTES = 2 * TILE_ELEMS;  // 16 KB
constexpr int SCHED = TAPS + 5;          // VJP tap order + 5 class starts
constexpr float SLOPE = 0.2f;

// Shared memory, from a 1024-byte aligned base (the swizzle atom).
constexpr int X_BYTES = 4 * NXS;
constexpr int H1_BYTES = 2 * NC1 * S1;
constexpr int DZ2_BYTES = 2 * NC2 * S2;
constexpr int P_BYTES = 4 * NC1 * SP;
constexpr int SCR_BYTES = P_BYTES > DZ2_BYTES ? P_BYTES : DZ2_BYTES;
constexpr int SAMPLE_BYTES = X_BYTES + H1_BYTES + SCR_BYTES;
constexpr int OFF_RING = 0;
constexpr int OFF_SAMPLE = OFF_RING + STAGES * TILE_BYTES;
constexpr int OFF_W0 = OFF_SAMPLE + SAMPLES * SAMPLE_BYTES;
constexpr int OFF_W0T = OFF_W0 + 2 * K0 * C1;
constexpr int OFF_WD = OFF_W0T + 2 * C1 * SW0T;
constexpr int OFF_B0 = OFF_WD + 4 * NC2 * SWD;
constexpr int OFF_B1 = OFF_B0 + 4 * C1;
constexpr int OFF_ZERO = OFF_B1 + 4 * C2;  // a zero row of C2 bf16
constexpr int OFF_RED = OFF_ZERO + 2 * C2;
constexpr int OFF_SCHED = OFF_RED + 4 * SAMPLES * 4;
constexpr int OFF_BAR = OFF_SCHED + 4 * ((SCHED + 1) / 2 * 2);
constexpr int SMEM_BYTES = OFF_BAR + 8 * 2 * STAGES;
constexpr int SMEM_ALLOC = SMEM_BYTES + 1024;  // room to align the base

static_assert(SMEM_ALLOC <= 232448, "fits the 227 KB a block may use");
static_assert(X_BYTES % 16 == 0 && H1_BYTES % 16 == 0 &&
                  SCR_BYTES % 16 == 0 && OFF_W0T % 16 == 0 &&
                  OFF_WD % 16 == 0 && OFF_ZERO % 16 == 0 &&
                  OFF_BAR % 8 == 0,
              "aligned shared buffers");
static_assert(TILE_BYTES % 1024 == 0, "tiles keep the swizzle alignment");
static_assert(4 * 16 >= NC2, "the four warps' 64 rows cover 49 cells");

__device__ __forceinline__ float lrelu(float v) {
  return v > 0.0f ? v : SLOPE * v;
}

// Two consecutive bf16 values (the lower index in the low half), as one
// 32-bit fragment register.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Position of channel c (even: pairs stay together) in a permuted row.
// Within each group of 32 channels, the fragment channels {2t, 2t + 1,
// 2t + 8, 2t + 9} of both 16-channel k-steps sit together at 8t.
__device__ __forceinline__ int slot(int c) {
  const int k = c & 15;
  return (c & ~31) + ((k & 7) >> 1) * 8 + ((c >> 4) & 1) * 4 + (k >> 3) * 2 +
         (k & 1);
}

// A fragments of k-steps 2q and 2q + 1 (mma.sync's A layout, t = lane % 4)
// from two permuted rows: r0 holds fragment row g, r1 row g + 8.
__device__ __forceinline__ void ld_frag2(uint32_t (&a0)[4], uint32_t (&a1)[4],
                                         const __nv_bfloat16* r0,
                                         const __nv_bfloat16* r1, int q,
                                         int t) {
  const uint4 u = *reinterpret_cast<const uint4*>(r0 + 32 * q + 8 * t);
  const uint4 v = *reinterpret_cast<const uint4*>(r1 + 32 * q + 8 * t);
  a0[0] = u.x, a0[1] = v.x, a0[2] = u.y, a0[3] = v.y;
  a1[0] = u.z, a1[1] = v.z, a1[2] = u.w, a1[3] = v.w;
}

// bf16(lo) in the low half, bf16(hi) in the high half, rounded to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// d += A (16x16 bf16, row-major) * B (16x8 bf16, column-major), f32 sums.
// Fragments (g = lane / 4, t = lane % 4): a0 = A[g][2t..], a1 = A[g+8][2t..],
// a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; b0 = B[2t..][g], b1 = B[2t+8..][g];
// d0,d1 = D[g][2t..], d2,d3 = D[g+8][2t..].
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Barrier over one warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma (their registers are written after the asm returns).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16 bf16, registers: this warp's 16 rows in
// mma.sync's A layout) * B (16 x 128, shared memory via desc).
// Accumulator layout: d[4j + 2h + e] = D[16 * warp + g + 8h][8j + 2t + e].
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared memory).
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// ---- the consumer warpgroup's phases ----------------------------------------

using WeightRing = Ring<STAGES, TILE_BYTES>;

// h1[cell][c] = bf16(lrelu(b0[c] + sum_tap bf16(x at (cell, tap)) w0[tap][c]))
// as a GEMM: im2col rows of the 196 cells (13 m-tiles, warp w takes
// w, w + 4, ...) x w0 (K = 32, taps 25..31 zero; N = 64, 8 n-tiles).
__device__ void conv0_fwd(const float* xs, const __nv_bfloat16* w0t,
                          const float* b0, __nv_bfloat16* h1) {
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  // This thread's 8 taps: k = 16 ks + 8 hi + 2t + e.
  int toff[2][2][2];
  bool tok[2][2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 16 * ks + 8 * hi + 2 * t + e;
        tok[ks][hi][e] = k < TAPS;
        toff[ks][hi][e] = (k / 5) * XS + k % 5;
      }
  uint32_t b[8][2][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const __nv_bfloat16* w = w0t + (nt * 8 + g) * SW0T + 16 * ks + 2 * t;
      b[nt][ks][0] = ld_pair(w);
      b[nt][ks][1] = ld_pair(w + 8);
    }
  for (int mt = wl; mt < MT0; mt += 4) {
    int base[2];
    bool rok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      rok[h] = r < NC1;
      base[h] = 2 * (r / H1) * XS + 2 * (r % H1);
    }
    uint32_t a[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = (rok[h] && tok[ks][hi][e])
                       ? xs[base[h] + toff[ks][hi][e]]
                       : 0.0f;
          a[ks][2 * hi + h] = pack_bf16(v[0], v[1]);
        }
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        mma_bf16(acc[nt], a[ks][0], a[ks][1], a[ks][2], a[ks][3],
                 b[nt][ks][0], b[nt][ks][1]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      const float bias0 = b0[c], bias1 = b0[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        if (rok[h])
          *reinterpret_cast<uint32_t*>(h1 + r * S1 + slot(c)) =
              pack_bf16(lrelu(acc[nt][2 * h] + bias0),
                        lrelu(acc[nt][2 * h + 1] + bias1));
      }
    }
  }
}

// This thread's A fragment of conv1's forward at `tap` (rows g and g + 8
// of the warp's 16; k-step ks covers channels 16 ks .. 16 ks + 15): the h1
// rows the tap reads, the zero row where it reads the border or pads M.
__device__ __forceinline__ void gather_fwd(uint32_t (&a)[4][4],
                                           const __nv_bfloat16* h1,
                                           const __nv_bfloat16* zero,
                                           int tap) {
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int dy = tap / 5, dx = tap % 5;
  const __nv_bfloat16* src[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 16 * wl + g + 8 * h;
    const int iy = 2 * (m / H2) + dy - 1, ix = 2 * (m % H2) + dx - 1;
    const bool ok = m < NC2 && iy >= 0 && iy < H1 && ix >= 0 && ix < H1;
    src[h] = ok ? h1 + (iy * H1 + ix) * S1 : zero;
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
    ld_frag2(a[2 * q], a[2 * q + 1], src[0], src[1], q, t);
}

__device__ __forceinline__ void issue_fwd(float (&acc)[64],
                                          const uint32_t (&a)[4][4],
                                          uint64_t desc) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_n128(acc, a[ks], desc + 2 * ks);
  wgmma_commit();
}

// acc[cell][co] = sum_{tap, ci} h1[in(cell, tap)][ci] w1[tap][ci][co] on
// wgmma, one tap per ring tile. Each tap's group is waited for before the
// next gather; the other warpgroup's wgmmas fill the tensor cores meanwhile
// (keeping one group in flight over a second A buffer measured slower).
__device__ void conv1_fwd(const __nv_bfloat16* h1, const __nv_bfloat16* zero,
                          WeightRing& ring, bool rec, int wg,
                          float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int tap = 0; tap < TAPS; ++tap) {
    uint32_t a[4][4];
    gather_fwd(a, h1, zero, tap);
    issue_fwd(acc, a, sw128_desc(ring.wait(rec, wg)));
    wgmma_wait_all();
    fence_regs(acc);
    ring.release();
  }
}

// This thread's A fragment of conv1's VJP for parity class (py, px) at tap
// (dy, dx): the dz2 rows at output cell (jy + sy, jx + sx), the zero row
// outside.
__device__ __forceinline__ void gather_vjp(uint32_t (&a)[8][4],
                                           const __nv_bfloat16* dz2,
                                           const __nv_bfloat16* zero, int py,
                                           int px, int tap) {
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int sy = (py + 1 - tap / 5) / 2, sx = (px + 1 - tap % 5) / 2;
  const __nv_bfloat16* src[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 16 * wl + g + 8 * h;
    const int oy = m / H2 + sy, ox = m % H2 + sx;
    const bool ok = m < NC2 && oy >= 0 && oy < H2 && ox >= 0 && ox < H2;
    src[h] = ok ? dz2 + (oy * H2 + ox) * S2 : zero;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    ld_frag2(a[2 * q], a[2 * q + 1], src[0], src[1], q, t);
}

// K = 128 channels: two 64-wide swizzle atoms of 8 KB, 4 k-steps each.
__device__ __forceinline__ void issue_vjp(float (&acc)[32],
                                          const uint32_t (&a)[8][4],
                                          uint64_t desc) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    wgmma_n64(acc, a[ks], desc + (ks / 4) * (8192 >> 4) + 2 * (ks % 4));
  wgmma_commit();
}

// dz1[cell][ci] = bf16(lrelu'(h1) * sum_{tap, co} dz2[out(cell, tap)][co]
//                                                  w1[tap][ci][co]),
// written over h1. h1 cell (iy, ix) = (2 jy + py, 2 jx + px); tap dy reaches
// it only when py + 1 - dy is even, from output row jy + (py + 1 - dy) / 2
// (and so for x). One GEMM per parity class, tap by tap as conv1_fwd; the
// taps of class c are sched[sched[TAPS + c]] .. sched[sched[TAPS + c + 1]
// - 1], in ring order.
__device__ void conv1_vjp(const __nv_bfloat16* dz2, __nv_bfloat16* h1,
                          const __nv_bfloat16* zero, const int* sched,
                          WeightRing& ring, bool rec, int wg) {
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  for (int c = 0; c < 4; ++c) {
    const int py = c >> 1, px = c & 1;
    const int j0 = sched[TAPS + c], j1 = sched[TAPS + c + 1];
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    for (int j = j0; j < j1; ++j) {
      uint32_t a[8][4];
      gather_vjp(a, dz2, zero, py, px, sched[j]);
      issue_vjp(acc, a, sw128_desc(ring.wait(rec, wg)));
      wgmma_wait_all();
      fence_regs(acc);
      ring.release();
    }
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
      const int ci = 8 * j8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * wl + g + 8 * h;
        if (m >= NC2) continue;
        const int cell = (2 * (m / H2) + py) * H1 + 2 * (m % H2) + px;
        uint32_t* p =
            reinterpret_cast<uint32_t*>(h1 + cell * S1 + slot(ci));
        const float2 hv = unpack_bf16(*p);
        const float v0 = acc[4 * j8 + 2 * h], v1 = acc[4 * j8 + 2 * h + 1];
        *p = pack_bf16(hv.x > 0.0f ? v0 : SLOPE * v0,
                       hv.y > 0.0f ? v1 : SLOPE * v1);
      }
    }
  }
}

// part[cell][tap] = sum_c dz1[cell][c] w0[tap][c] for the 196 cells and 32
// (padded) taps: 13 m-tiles x 4 n-tiles, K = 64.
__device__ void conv0_vjp(const __nv_bfloat16* dz1, const __nv_bfloat16* w0s,
                          const __nv_bfloat16* zero, float* part) {
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  uint32_t b[4][4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const __nv_bfloat16* w = w0s + (nt * 8 + g) * C1 + 16 * ks + 2 * t;
      b[nt][ks][0] = ld_pair(w);
      b[nt][ks][1] = ld_pair(w + 8);
    }
  for (int mt = wl; mt < MT0; mt += 4) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    uint32_t a[4][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
      ld_frag2(a[2 * q], a[2 * q + 1], r0 < NC1 ? dz1 + r0 * S1 : zero,
               r1 < NC1 ? dz1 + r1 * S1 : zero, q, t);
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16(acc[nt], a[ks][0], a[ks][1], a[ks][2], a[ks][3],
                 b[nt][ks][0], b[nt][ks][1]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int tap = nt * 8 + 2 * t;
      if (r0 < NC1)
        *reinterpret_cast<float2*>(part + r0 * SP + tap) =
            make_float2(acc[nt][0], acc[nt][1]);
      if (r1 < NC1)
        *reinterpret_cast<float2*>(part + r1 * SP + tap) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// x[iy][ix] -= rate * sum of part[cell][tap] over the (cell, tap) pairs that
// read pixel (iy, ix): iy + 1 - dy = 2 oy with 0 <= oy < 14 (and so for x).
__device__ void col2im_update(const float* part, float* xs, float rate) {
  for (int p = threadIdx.x & 127; p < NX; p += 128) {
    const int iy = p / H0, ix = p % H0;
    float acc = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy) {
      const int ty = iy + 1 - dy;
      if (ty < 0 || (ty & 1) || (ty >> 1) >= H1) continue;
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) {
        const int tx = ix + 1 - dx;
        if (tx < 0 || (tx & 1) || (tx >> 1) >= H1) continue;
        acc += part[((ty >> 1) * H1 + (tx >> 1)) * SP + dy * 5 + dx];
      }
    }
    xs[(iy + 1) * XS + ix + 1] -= rate * acc;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS, 1)
    refine_bf16_kernel(const float* __restrict__ x0, float* __restrict__ x_out,
                       float* __restrict__ logits,
                       const __nv_bfloat16* __restrict__ w0,
                       const float* __restrict__ b0,
                       const __nv_bfloat16* __restrict__ w1s,
                       const int* __restrict__ sched,
                       const float* __restrict__ b1,
                       const float* __restrict__ wd,
                       const float* __restrict__ bd, int batch, int steps,
                       float rate) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* w0s = reinterpret_cast<__nv_bfloat16*>(smem + OFF_W0);
  __nv_bfloat16* w0t = reinterpret_cast<__nv_bfloat16*>(smem + OFF_W0T);
  float* wd_s = reinterpret_cast<float*>(smem + OFF_WD);
  float* b0_s = reinterpret_cast<float*>(smem + OFF_B0);
  float* b1_s = reinterpret_cast<float*>(smem + OFF_B1);
  __nv_bfloat16* zero = reinterpret_cast<__nv_bfloat16*>(smem + OFF_ZERO);
  float* red = reinterpret_cast<float*>(smem + OFF_RED);
  int* sched_s = reinterpret_cast<int*>(smem + OFF_SCHED);
  const uint32_t tiles = smem_u32(smem + OFF_RING);
  const uint32_t full = smem_u32(smem + OFF_BAR);  // full[s], then empty[s]

  const int tid = threadIdx.x, warp = tid >> 5;
  if (tid == 0) ring_init<STAGES>(full, 4 * SAMPLES);  // one per warp
  for (int i = tid; i < K0 * C1; i += THREADS) {
    const __nv_bfloat16 v = w0[i];
    w0s[i] = v;
    w0t[(i % C1) * SW0T + i / C1] = v;
  }
  for (int i = tid; i < SCHED; i += THREADS) sched_s[i] = sched[i];
  for (int i = tid; i < NC2 * C2; i += THREADS)
    wd_s[(i / C2) * SWD + i % C2] = wd[i];
  for (int i = tid; i < C1; i += THREADS) b0_s[i] = b0[i];
  for (int i = tid; i < C2; i += THREADS) {
    b1_s[i] = b1[i];
    zero[i] = __float2bfloat16_rn(0.0f);
  }
  for (int i = tid; i < SAMPLES * NXS; i += THREADS) {
    const int s = i / NXS, p = i % NXS, r = p / XS - 1, c = p % XS - 1;
    const long long b = 2LL * blockIdx.x + s;
    const bool in = b < batch && r >= 0 && r < H0 && c >= 0 && c < H0;
    reinterpret_cast<float*>(smem + OFF_SAMPLE + s * SAMPLE_BYTES)[p] =
        in ? x0[b * NX + r * H0 + c] : 0.0f;
  }
  __syncthreads();

  if (warp == 4 * SAMPLES) {
    // Producer: the fixed tile schedule, (2K + 1) passes of 25 tiles.
    if ((tid & 31) == 0)
      ring_produce<STAGES, TILE_BYTES, TAPS>(
          tiles, full, reinterpret_cast<const unsigned char*>(w1s),
          2 * steps + 1);
    return;
  }

  // Consumer warpgroup wg: sample 2 * blockIdx.x + wg.
  const int wg = warp >> 2, lane = tid & 31, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool rec = (tid & 127) == 0;
  unsigned char* mine = smem + OFF_SAMPLE + wg * SAMPLE_BYTES;
  float* xs = reinterpret_cast<float*>(mine);
  __nv_bfloat16* h1 = reinterpret_cast<__nv_bfloat16*>(mine + X_BYTES);
  __nv_bfloat16* dz2 =
      reinterpret_cast<__nv_bfloat16*>(mine + X_BYTES + H1_BYTES);
  float* part = reinterpret_cast<float*>(mine + X_BYTES + H1_BYTES);
  const long long b = 2LL * blockIdx.x + wg;
  const float bias_d = __ldg(bd);
  WeightRing ring{tiles, full, 0};
  CGS_PHASE_BEGIN(rec, wg)

  for (int k = 0;; ++k) {
    conv0_fwd(xs, w0t, b0_s, h1);
    wg_sync(wg);
    CGS_PHASE(rec, wg, 0)
    float acc[64];
    conv1_fwd(h1, zero, ring, rec, wg, acc);
    CGS_PHASE(rec, wg, 1)

    // Dense head from the accumulators; lrelu'(h2) kept as a sign mask.
    float s = 0.0f;
    uint64_t mask = 0;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int m = 16 * wl + g + 8 * ((i >> 1) & 1);
      const int co = 8 * (i >> 2) + 2 * t;
      if (m < NC2) {
        const float2 w = *reinterpret_cast<const float2*>(wd_s + m * SWD + co);
        const float v0 = acc[i] + b1_s[co], v1 = acc[i + 1] + b1_s[co + 1];
        if (v0 > 0.0f) mask |= 1ull << i;
        if (v1 > 0.0f) mask |= 1ull << (i + 1);
        s = fmaf(lrelu(v0), w.x, s);
        s = fmaf(lrelu(v1), w.y, s);
      }
    }
    s = warp_sum(s);
    if (lane == 0) red[4 * wg + wl] = s;
    wg_sync(wg);
    const float logit = red[4 * wg] + red[4 * wg + 1] + red[4 * wg + 2] +
                        red[4 * wg + 3] + bias_d;
    if (k == steps) {
      if (b < batch) {
        for (int p = tid & 127; p < NX; p += 128)
          x_out[b * NX + p] = xs[(p / H0 + 1) * XS + p % H0 + 1];
        if (rec) logits[b] = logit;
      }
      break;
    }

    // d softplus(-l) / dl = -sigmoid(-l); dz2 = bf16(lrelu'(h2) gl wd).
    const float gl = -1.0f / (1.0f + expf(logit));
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int m = 16 * wl + g + 8 * ((i >> 1) & 1);
      const int co = 8 * (i >> 2) + 2 * t;
      if (m < NC2) {
        const float2 w = *reinterpret_cast<const float2*>(wd_s + m * SWD + co);
        const float v0 = gl * w.x, v1 = gl * w.y;
        *reinterpret_cast<uint32_t*>(dz2 + m * S2 + slot(co)) =
            pack_bf16((mask >> i) & 1 ? v0 : SLOPE * v0,
                      (mask >> (i + 1)) & 1 ? v1 : SLOPE * v1);
      }
    }
    wg_sync(wg);
    CGS_PHASE(rec, wg, 2)
    conv1_vjp(dz2, h1, zero, sched_s, ring, rec, wg);
    wg_sync(wg);
    CGS_PHASE(rec, wg, 3)
    conv0_vjp(h1, w0s, zero, part);
    wg_sync(wg);
    CGS_PHASE(rec, wg, 4)
    col2im_update(part, xs, rate);
    wg_sync(wg);
    CGS_PHASE(rec, wg, 5)
  }
  CGS_PHASE_END(rec, wg)
}

}  // namespace

extern "C" {

const char* cgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x0, x_out: (batch, 28, 28) f32. w0: [32][64] bf16 (taps 25..31 zero),
// b0: [64] f32, w1s: 50 tiles of 64 x 128 bf16 in wgmma's 128-byte swizzled
// K-major image (ops/conv_refine.py::pack_conv1_bf16: 25 forward tiles
// [co][ci], then 25 VJP tiles [ci][co] in the VJP's tap order), sched: the
// VJP's 25 taps (dy * 5 + dx) by parity class and the 5 class starts
// (int32), b1: [128] f32, wd: [7*7*128] f32 in NHWC order, bd: [1] f32.
int conv_refine28_bf16(const float* x0, float* x_out, float* logits,
                       const void* w0, const float* b0, const void* w1s,
                       const void* sched, const float* b1, const float* wd,
                       const float* bd, int batch, int steps, float rate,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      refine_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_ALLOC);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  refine_bf16_kernel<<<(batch + SAMPLES - 1) / SAMPLES, THREADS, SMEM_ALLOC,
                       stream>>>(
      x0, x_out, logits, static_cast<const __nv_bfloat16*>(w0), b0,
      static_cast<const __nv_bfloat16*>(w1s), static_cast<const int*>(sched),
      b1, wd, bd, batch, steps, rate);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
