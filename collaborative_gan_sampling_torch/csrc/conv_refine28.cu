// Fused K-step refinement under the 28x28x1 / 64-filter DCGAN discriminator,
// all f32 on the CUDA cores of Hopper (sm_90a: bulk async copies, mbarriers).
//
// Replaces the TPU kernels collaborative_gan_sampling_tpu/ops/
// conv_refine_pallas.py: fused_refine_conv28 (_refine_kernel) and, at f32
// operands, fused_refine_conv28_v2 (_refine_kernel_v2). It computes what
// ops/conv_refine_ref.py::refine_conv28_plain computes, for the D in eval
// mode with BatchNorm folded into conv1 (the wrapper folds and packs):
//
//   K times:  x <- x - rate * d softplus(-D(x)) / dx
//   then:     logit = D(x)
//
//   D(x) = wd . lrelu(conv1(lrelu(conv0(x)))) + bd
//   conv0: 5x5 / stride 2, 1 -> 64,   28x28 -> 14x14
//   conv1: 5x5 / stride 2, 64 -> 128, 14x14 -> 7x7 (BN folded)
//
// Every product is f32 x f32 and every sum f32; only the order of the sums
// differs from the plain version. Both convs use XLA's SAME padding (low 1,
// high 2): input index iy = 2*oy + dy - 1. The input-VJPs read the same
// taps as gathers, oy = (iy + 1 - dy) / 2 where that is an integer in range.
//
// What bounds it on this card: operations. (2K + 1) D passes of 17.36 MFLOP
// per sample (taps on the zero border not counted): 93.35 GFLOP at B = 256,
// K = 10, 1.393 ms at 67 TFLOP/s f32. conv1 and its input-VJP are 94% of
// the FLOPs. The earlier kernel (one block per sample, conv1's weights read
// from L2 inside the tap loop, 4 loads for 28 FMAs) spent 83.5% of its
// cycles in conv1 and its VJP and ran at 19.6% of the bound.
//
// Design:
// - Two samples per block, 14 consumer warps and one producer warp; at
//   B = 256, 128 blocks, one per SM. Consumer warps 2r and 2r + 1 take
//   output row r of conv1 (and of each VJP parity class) for both samples,
//   each over half of conv1's weight tiles (K split in two): lanes 0-15
//   sample 0, lanes 16-31 sample 1, lane % 16 a group of channels. The odd
//   warp hands its sums to the even one through shared memory once a pass
//   (or a VJP class). Why two warps a row (the phase split, PERF.md): rows
//   0 and 6 skip 5 and 10 of the 25 taps, and with one warp a row (7 warps)
//   one of the 4 warp schedulers ran two full rows, 50 tap-units a pass
//   where 40 is the even share; with two warps a row the busiest scheduler
//   runs 42.5, and 3 or 4 warps hide each other's load latency. Per
//   sample, shared memory holds x (zero-bordered 32x32, so that conv0's
//   gather needs no range test), h1 (196 rows of 64 channels, stride 68 so
//   that rows 7 apart fall on other banks) and one scratch area: the odd
//   warps' forward sums, then dz2 during conv1's VJP, conv0's per-(cell,
//   tap) VJP partials after it. Per block: the weight ring, w0, the dense
//   head wd, the biases. h2 never reaches shared memory: the conv1 epilogue
//   keeps lrelu'(h2) as a sign mask and sums the dense head from its
//   accumulators. dz1 overwrites h1 in place (each element's sign is read
//   by the thread that writes it, before the odd warp's sums pass through
//   the same place).
// - conv1's weights stream through a ring of STAGES 8 KB tiles (a quarter
//   tap each) in shared memory: the producer issues one 1-D bulk async copy
//   per tile (hopper_async.cuh), consumer warps wait on the tile's "full"
//   mbarrier and release its "empty" one. Each tile feeds both samples, so
//   each sample's L2 traffic halves. The schedule is fixed: the 25 forward
//   taps as 4 tiles of 16 input channels x 128, then the VJP's taps by
//   parity class in vjp_schedule() order as 4 tiles of 32 output channels
//   x 64 ([co][ci]); the producer runs ahead across phases. The wrapper
//   packs w1 once per call in that order (ops/conv_refine.py::
//   pack_conv1_f32) and passes the tap table.
// - conv1 is a register-tiled implicit GEMM on f32 FMAs: each thread owns 7
//   output cells (a row) x 8 channels (4 at c and 4 at 64 + c, so that a
//   half-warp's float4 weight loads cover 256 contiguous bytes). Per 4 input
//   channels it loads 7 float4 of h1 (two addresses a warp: broadcasts) and
//   8 float4 of weights for 224 FMAs. Its VJP, per parity class (iy % 2,
//   ix % 2) of the h1 cells and over only the taps that reach it (4, 6, 6
//   and 9), gives each thread 7 cells x 4 channels: 11 float4 loads for 112
//   FMAs. Each warp multiplies two of each tap's four tiles. Rows on the
//   border are skipped for the whole warp; the cells of a row that a tap
//   puts on the border are left out at compile time (the tap column is a
//   template argument), and a tile's loops are unrolled whole.
// - conv0 is an im2col GEMM with register tiles of 7 cells x 8 channels
//   (x read as broadcasts, no range test); its VJP is a GEMM dz1 x w0^T
//   into per-(cell, tap) partials (tiles of 7 cells x 5 taps, K = 64 in
//   registers, no shuffles), then a col2im sum per pixel over its at most 9
//   (cell, tap) pairs, and the update.
// - Shared memory (the budget is 232,448 bytes a block): the ring 32,768;
//   per sample x 4,096 + h1 53,312 + scratch 25,088; w0 6,800; wd 25,088;
//   biases, sums, the tap table and the mbarriers 1,040; 230,800 with the
//   alignment slack.
// - The rate is a runtime argument. A ragged batch leaves the last block's
//   second sample dead: it runs on zeros and writes nothing.
// - Build with -DCGS_PHASE_CLOCKS to count clock64() cycles per phase
//   (conv_refine_phases.py --kernel f32 at the repo root).

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
constexpr int S1 = C1 + 4;     // h1 / dz1 row stride (floats)
constexpr int SW0 = C1 + 4;    // w0 row stride (floats)
constexpr int SP = TAPS;       // conv0-VJP partials row stride (floats)
constexpr int HALF_ROWS = 2 * H1;  // conv0's cell groups: 7 cells each

constexpr int SAMPLES = 2;
constexpr int CWARPS = 2 * H2;            // consumer warps, two per row
constexpr int CTHREADS = 32 * CWARPS;     // 448
constexpr int THREADS = CTHREADS + 32;    // + the producer warp
constexpr int STAGES = 4;                 // ring of conv1 weight tiles
constexpr int TILE_FLOATS = 2048;         // 16 ci x 128 co, or 32 co x 64 ci
constexpr int TILE_BYTES = 4 * TILE_FLOATS;
constexpr int CI_TILE = TILE_FLOATS / C2;  // 16 input channels a forward tile
constexpr int CO_TILE = TILE_FLOATS / C1;  // 32 output channels a VJP tile
constexpr int TAP_TILES = 4;               // tiles a tap, either direction
constexpr int PASS_TILES = TAPS * TAP_TILES;
constexpr int SCHED = TAPS + 5;           // VJP tap order + 5 class starts
constexpr float SLOPE = 0.2f;

// Shared memory, from a 128-byte aligned base.
constexpr int X_BYTES = 4 * NXS;
constexpr int H1_BYTES = 4 * NC1 * S1;
constexpr int DZ2_BYTES = 4 * NC2 * C2;
constexpr int P_BYTES = 4 * NC1 * SP;
constexpr int SCR_BYTES = P_BYTES > DZ2_BYTES ? P_BYTES : DZ2_BYTES;
constexpr int SAMPLE_BYTES = X_BYTES + H1_BYTES + SCR_BYTES;
constexpr int OFF_RING = 0;
constexpr int OFF_SAMPLE = OFF_RING + STAGES * TILE_BYTES;
constexpr int OFF_W0 = OFF_SAMPLE + SAMPLES * SAMPLE_BYTES;
constexpr int OFF_WD = OFF_W0 + 4 * TAPS * SW0;
constexpr int OFF_B0 = OFF_WD + 4 * NC2 * C2;
constexpr int OFF_B1 = OFF_B0 + 4 * C1;
constexpr int OFF_RED = OFF_B1 + 4 * C2;
constexpr int OFF_SCHED = OFF_RED + 4 * SAMPLES * H2 + 8;
constexpr int OFF_BAR = OFF_SCHED + 4 * 32;
constexpr int SMEM_BYTES = OFF_BAR + 8 * 2 * STAGES;
constexpr int SMEM_ALLOC = SMEM_BYTES + 128;  // room to align the base

static_assert(SMEM_ALLOC <= 232448, "fits the 227 KB a block may use");
static_assert(X_BYTES % 16 == 0 && H1_BYTES % 16 == 0 &&
                  SCR_BYTES % 16 == 0 && OFF_W0 % 16 == 0 &&
                  OFF_WD % 16 == 0 && OFF_B0 % 16 == 0 &&
                  OFF_B1 % 16 == 0 && OFF_BAR % 8 == 0,
              "aligned shared buffers");
static_assert(SAMPLE_BYTES % 128 == 64,
              "the two samples' rows fall on other banks");
static_assert(SCHED <= 32, "the tap table fits its slot");

__device__ __forceinline__ float lrelu(float v) {
  return v > 0.0f ? v : SLOPE * v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Barrier over the 14 consumer warps (id 1; 0 is __syncthreads).
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CTHREADS) : "memory");
}

using WeightRing = Ring<STAGES, TILE_BYTES>;

// h1[cell][c] = lrelu(b0[c] + sum_tap x at (cell, tap) * w0[tap][c]) for
// both samples: 448 tiles of 7 cells (half a row) x 8 channels (4 at 4 cg,
// 4 at 32 + 4 cg), one a thread.
__device__ void conv0_fwd(unsigned char* samples, const float* w0s,
                          const float* b0) {
  const int tid = threadIdx.x;
  constexpr int TILES = HALF_ROWS * 8;  // a sample's
#pragma unroll 1
  for (int t = tid; t < SAMPLES * TILES; t += CTHREADS) {
    const int s = t / TILES, r = t % TILES, cells = r >> 3, cg = r & 7;
    const int row = cells >> 1, col0 = 7 * (cells & 1);
    const float* xs =
        reinterpret_cast<const float*>(samples + s * SAMPLE_BYTES);
    float* h1 = reinterpret_cast<float*>(samples + s * SAMPLE_BYTES +
                                         X_BYTES);
    float acc[7][8];
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 1
    for (int dy = 0; dy < 5; ++dy) {
      const float* xr = xs + (2 * row + dy) * XS + 2 * col0;
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) {
        const float* w = w0s + (dy * 5 + dx) * SW0 + 4 * cg;
        const float4 wa = ld4(w), wb = ld4(w + 32);
#pragma unroll
        for (int i = 0; i < 7; ++i) {
          const float v = xr[2 * i + dx];
          acc[i][0] = fmaf(v, wa.x, acc[i][0]);
          acc[i][1] = fmaf(v, wa.y, acc[i][1]);
          acc[i][2] = fmaf(v, wa.z, acc[i][2]);
          acc[i][3] = fmaf(v, wa.w, acc[i][3]);
          acc[i][4] = fmaf(v, wb.x, acc[i][4]);
          acc[i][5] = fmaf(v, wb.y, acc[i][5]);
          acc[i][6] = fmaf(v, wb.z, acc[i][6]);
          acc[i][7] = fmaf(v, wb.w, acc[i][7]);
        }
      }
    }
    const float4 ba = ld4(b0 + 4 * cg), bb = ld4(b0 + 32 + 4 * cg);
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      float* p = h1 + (row * H1 + col0 + i) * S1 + 4 * cg;
      *reinterpret_cast<float4*>(p) = make_float4(
          lrelu(acc[i][0] + ba.x), lrelu(acc[i][1] + ba.y),
          lrelu(acc[i][2] + ba.z), lrelu(acc[i][3] + ba.w));
      *reinterpret_cast<float4*>(p + 32) = make_float4(
          lrelu(acc[i][4] + bb.x), lrelu(acc[i][5] + bb.y),
          lrelu(acc[i][6] + bb.z), lrelu(acc[i][7] + bb.w));
    }
  }
}

// One forward tile at tap column DX: acc[ox][j] += sum over the tile's 16
// input channels of h1[iy][2 ox + DX - 1][ci] w1[ci][co_j], for the ox
// whose input column is inside the image. hrow: h1 row iy at the tile's
// first channel; w: the tile at this thread's first channel.
template <int DX>
__device__ __forceinline__ void fwd_tile(float (&acc)[7][8], const float* hrow,
                                         const float* w) {
  constexpr int lo = DX == 0 ? 1 : 0, hi = DX >= 3 ? 6 : 7;
#pragma unroll
  for (int c4 = 0; c4 < CI_TILE; c4 += 4) {
    float4 h[7];
#pragma unroll
    for (int ox = lo; ox < hi; ++ox)
      h[ox] = ld4(hrow + (2 * ox + DX - 1) * S1 + c4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* wj = w + (c4 + j) * C2;
      const float4 wa = ld4(wj), wb = ld4(wj + 64);
#pragma unroll
      for (int ox = lo; ox < hi; ++ox) {
        const float v = comp(h[ox], j);
        acc[ox][0] = fmaf(v, wa.x, acc[ox][0]);
        acc[ox][1] = fmaf(v, wa.y, acc[ox][1]);
        acc[ox][2] = fmaf(v, wa.z, acc[ox][2]);
        acc[ox][3] = fmaf(v, wa.w, acc[ox][3]);
        acc[ox][4] = fmaf(v, wb.x, acc[ox][4]);
        acc[ox][5] = fmaf(v, wb.y, acc[ox][5]);
        acc[ox][6] = fmaf(v, wb.z, acc[ox][6]);
        acc[ox][7] = fmaf(v, wb.w, acc[ox][7]);
      }
    }
  }
}

// acc[ox][j] = sum_{tap, ci} h1[in(cell, tap)][ci] w1[tap][ci][co_j] for
// the cells (oy, 0..6) of this warp's row, co_j = 4 q + j (j < 4) and
// 64 + 4 q + j - 4, over this warp's half of the input channels: the ring
// tiles qt of each tap with qt % 2 == half (four tiles a tap).
__device__ void conv1_fwd(const float* h1, WeightRing& ring,
                          const unsigned char* ring_base, bool rec, int oy,
                          int half, int q, float (&acc)[7][8]) {
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 1
  for (int tap = 0; tap < TAPS; ++tap) {
    const int dy = tap / 5, dx = tap % 5, iy = 2 * oy + dy - 1;
    const bool row_in = iy >= 0 && iy < H1;  // the same for the whole warp
#pragma unroll 1
    for (int qt = 0; qt < TAP_TILES; ++qt) {
      const float* w = reinterpret_cast<const float*>(
          ring_base + (ring.wait(rec, 0) - ring.tiles)) + 4 * q;
      if (row_in && (qt & 1) == half) {
        const float* hrow = h1 + iy * H1 * S1 + qt * CI_TILE;
        switch (dx) {
          case 0: fwd_tile<0>(acc, hrow, w); break;
          case 1: fwd_tile<1>(acc, hrow, w); break;
          case 2: fwd_tile<2>(acc, hrow, w); break;
          case 3: fwd_tile<3>(acc, hrow, w); break;
          default: fwd_tile<4>(acc, hrow, w); break;
        }
      }
      ring.release();
    }
  }
}

// One VJP tile at output-column shift SX: acc[jx][j] += sum over the tile's
// 32 output channels of dz2[oy][jx + SX][co] w1[ci_j][co], for the jx whose
// output column is inside the image. drow: dz2 row oy at the tile's first
// channel; w: the tile ([co][ci]) at this thread's first channel.
template <int SX>
__device__ __forceinline__ void vjp_tile(float (&acc)[7][4], const float* drow,
                                         const float* w) {
  constexpr int lo = SX < 0 ? 1 : 0, hi = SX > 0 ? 6 : 7;
#pragma unroll
  for (int c4 = 0; c4 < CO_TILE; c4 += 4) {
    float4 d[7];
#pragma unroll
    for (int jx = lo; jx < hi; ++jx) d[jx] = ld4(drow + (jx + SX) * C2 + c4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 wv = ld4(w + (c4 + j) * C1);
#pragma unroll
      for (int jx = lo; jx < hi; ++jx) {
        const float v = comp(d[jx], j);
        acc[jx][0] = fmaf(v, wv.x, acc[jx][0]);
        acc[jx][1] = fmaf(v, wv.y, acc[jx][1]);
        acc[jx][2] = fmaf(v, wv.z, acc[jx][2]);
        acc[jx][3] = fmaf(v, wv.w, acc[jx][3]);
      }
    }
  }
}

// dz1[cell][ci] = lrelu'(h1) * sum_{tap, co} dz2[out(cell, tap)][co]
// w1[tap][ci][co], written over h1. h1 cell (iy, ix) = (2 jy + py,
// 2 jx + px); tap dy reaches it only when py + 1 - dy is even, from output
// row jy + (py + 1 - dy) / 2 (and so for x). The two warps of row jy sum
// over the ring tiles qt with qt % 2 == half (two of each tap's four);
// this thread takes channels 4 q .. 4 q + 3. The taps of class c are
// sched[sched[TAPS + c]] .. sched[sched[TAPS + c + 1] - 1], in ring order.
// The odd warp hands its sums to the even one through the class's own h1
// cells, whose signs the even warp has read first.
__device__ void conv1_vjp(const float* dz2, float* h1, const int* sched,
                          WeightRing& ring, const unsigned char* ring_base,
                          bool rec, int jy, int half, int q) {
  for (int c = 0; c < 4; ++c) {
    const int py = c >> 1, px = c & 1;
    float* cells = h1 + (2 * jy + py) * H1 * S1 + px * S1 + 4 * q;
    uint32_t pos = 0;  // lrelu'(h1): bit 4 jx + j where h1 > 0
    if (!half) {
#pragma unroll
      for (int jx = 0; jx < 7; ++jx) {
        const float4 hv = ld4(cells + 2 * jx * S1);
        pos |= (hv.x > 0.0f ? 1u : 0u) << (4 * jx);
        pos |= (hv.y > 0.0f ? 2u : 0u) << (4 * jx);
        pos |= (hv.z > 0.0f ? 4u : 0u) << (4 * jx);
        pos |= (hv.w > 0.0f ? 8u : 0u) << (4 * jx);
      }
    }
    float acc[7][4];
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 1
    for (int jt = sched[TAPS + c]; jt < sched[TAPS + c + 1]; ++jt) {
      const int tap = sched[jt];
      const int oy = jy + (py + 1 - tap / 5) / 2;
      const int sx = (px + 1 - tap % 5) / 2;
      const bool row_in = oy >= 0 && oy < H2;  // the same for the whole warp
#pragma unroll 1
      for (int qt = 0; qt < TAP_TILES; ++qt) {
        const float* w = reinterpret_cast<const float*>(
            ring_base + (ring.wait(rec, 0) - ring.tiles)) + 4 * q;
        if (row_in && (qt & 1) == half) {
          const float* drow = dz2 + oy * H2 * C2 + qt * CO_TILE;
          if (sx < 0) {
            vjp_tile<-1>(acc, drow, w);
          } else if (sx == 0) {
            vjp_tile<0>(acc, drow, w);
          } else {
            vjp_tile<1>(acc, drow, w);
          }
        }
        ring.release();
      }
    }
    csync();
    if (half) {
#pragma unroll
      for (int jx = 0; jx < 7; ++jx)
        *reinterpret_cast<float4*>(cells + 2 * jx * S1) =
            make_float4(acc[jx][0], acc[jx][1], acc[jx][2], acc[jx][3]);
    }
    csync();
    if (!half) {
#pragma unroll
      for (int jx = 0; jx < 7; ++jx) {
        float* p = cells + 2 * jx * S1;
        const float4 o = ld4(p);
        const float v[4] = {acc[jx][0] + o.x, acc[jx][1] + o.y,
                            acc[jx][2] + o.z, acc[jx][3] + o.w};
        float d[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          d[j] = (pos >> (4 * jx + j)) & 1 ? v[j] : SLOPE * v[j];
        *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
      }
    }
  }
}

// part[cell][tap] = sum_c dz1[cell][c] w0[tap][c] for both samples: 280
// tiles of 7 cells (half a row) x 5 taps (one dy), K = 64 in registers;
// at most one a thread.
__device__ void conv0_vjp(unsigned char* samples, const float* w0s) {
  const int tid = threadIdx.x;
  constexpr int TILES = HALF_ROWS * 5;  // a sample's
#pragma unroll 1
  for (int t = tid; t < SAMPLES * TILES; t += CTHREADS) {
    const int s = t / TILES, r = t % TILES, cells = r / 5, dy = r % 5;
    const int cell0 = (cells >> 1) * H1 + 7 * (cells & 1);
    unsigned char* mine = samples + s * SAMPLE_BYTES;
    const float* dz1 = reinterpret_cast<const float*>(mine + X_BYTES);
    float* part = reinterpret_cast<float*>(mine + X_BYTES + H1_BYTES);
    float acc[7][5];
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
    for (int c4 = 0; c4 < C1; c4 += 4) {
      float4 d[7], w[5];
#pragma unroll
      for (int i = 0; i < 7; ++i) d[i] = ld4(dz1 + (cell0 + i) * S1 + c4);
#pragma unroll
      for (int j = 0; j < 5; ++j) w[j] = ld4(w0s + (dy * 5 + j) * SW0 + c4);
#pragma unroll
      for (int i = 0; i < 7; ++i)
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          acc[i][j] = fmaf(d[i].x, w[j].x, acc[i][j]);
          acc[i][j] = fmaf(d[i].y, w[j].y, acc[i][j]);
          acc[i][j] = fmaf(d[i].z, w[j].z, acc[i][j]);
          acc[i][j] = fmaf(d[i].w, w[j].w, acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j)
        part[(cell0 + i) * SP + dy * 5 + j] = acc[i][j];
  }
}

// x[iy][ix] -= rate * sum of part[cell][tap] over the (cell, tap) pairs that
// read pixel (iy, ix): iy + 1 - dy = 2 oy with 0 <= oy < 14 (and so for x).
__device__ void col2im_update(unsigned char* samples, float rate) {
#pragma unroll 1
  for (int p = threadIdx.x; p < SAMPLES * NX; p += CTHREADS) {
    unsigned char* mine = samples + (p / NX) * SAMPLE_BYTES;
    float* xs = reinterpret_cast<float*>(mine);
    const float* part =
        reinterpret_cast<const float*>(mine + X_BYTES + H1_BYTES);
    const int iy = (p % NX) / H0, ix = (p % NX) % H0;
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

__global__ void __launch_bounds__(THREADS, 1)
    refine_kernel(const float* __restrict__ x0, float* __restrict__ x_out,
                  float* __restrict__ logits, const float* __restrict__ w0,
                  const float* __restrict__ b0,
                  const float* __restrict__ w1s,
                  const int* __restrict__ sched,
                  const float* __restrict__ b1, const float* __restrict__ wd,
                  const float* __restrict__ bd, int batch, int steps,
                  float rate) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  unsigned char* samples = smem + OFF_SAMPLE;
  float* w0s = reinterpret_cast<float*>(smem + OFF_W0);
  float* wd_s = reinterpret_cast<float*>(smem + OFF_WD);
  float* b0_s = reinterpret_cast<float*>(smem + OFF_B0);
  float* b1_s = reinterpret_cast<float*>(smem + OFF_B1);
  float* red = reinterpret_cast<float*>(smem + OFF_RED);
  int* sched_s = reinterpret_cast<int*>(smem + OFF_SCHED);
  const uint32_t tiles = smem_u32(smem + OFF_RING);
  const uint32_t full = smem_u32(smem + OFF_BAR);  // full[s], then empty[s]

  const int tid = threadIdx.x, warp = tid >> 5;
  if (tid == 0) ring_init<STAGES>(full, CWARPS);  // one arrival per warp
  for (int i = tid; i < TAPS * C1; i += THREADS)
    w0s[(i / C1) * SW0 + i % C1] = w0[i];
  for (int i = tid; i < SCHED; i += THREADS) sched_s[i] = sched[i];
  for (int i = tid; i < NC2 * C2; i += THREADS) wd_s[i] = wd[i];
  for (int i = tid; i < C1; i += THREADS) b0_s[i] = b0[i];
  for (int i = tid; i < C2; i += THREADS) b1_s[i] = b1[i];
  for (int i = tid; i < SAMPLES * NXS; i += THREADS) {
    const int s = i / NXS, p = i % NXS, r = p / XS - 1, c = p % XS - 1;
    const long long b = 2LL * blockIdx.x + s;
    const bool in = b < batch && r >= 0 && r < H0 && c >= 0 && c < H0;
    reinterpret_cast<float*>(samples + s * SAMPLE_BYTES)[p] =
        in ? x0[b * NX + r * H0 + c] : 0.0f;
  }
  __syncthreads();

  if (warp == CWARPS) {
    // Producer: the fixed tile schedule, (2K + 1) passes of 100 tiles.
    if ((tid & 31) == 0)
      ring_produce<STAGES, TILE_BYTES, PASS_TILES>(
          tiles, full, reinterpret_cast<const unsigned char*>(w1s),
          2 * steps + 1);
    return;
  }

  // Consumer warp `warp`: output row `row` of both samples, over half
  // `half` of conv1's tiles; lanes 0-15 sample 0, lanes 16-31 sample 1;
  // q = lane % 16 picks the channels.
  const int row = warp >> 1, half = warp & 1;
  const int lane = tid & 31, s = lane >> 4, q = lane & 15;
  const bool rec = tid == 0;
  unsigned char* mine = samples + s * SAMPLE_BYTES;
  float* h1 = reinterpret_cast<float*>(mine + X_BYTES);
  float* dz2 = reinterpret_cast<float*>(mine + X_BYTES + H1_BYTES);
  const unsigned char* ring_base = smem + OFF_RING;
  const float bias_d = __ldg(bd);
  WeightRing ring{tiles, full, 0};
  CGS_PHASE_BEGIN(rec, 0)

  for (int k = 0;; ++k) {
    conv0_fwd(samples, w0s, b0_s);
    csync();
    CGS_PHASE(rec, 0, 0)
    float acc[7][8];
    conv1_fwd(h1, ring, ring_base, rec, row, half, q, acc);
    // The odd warp of the row hands its sums to the even one through the
    // dz2 area, at the places the even warp's dz2 goes.
    if (half) {
#pragma unroll
      for (int ox = 0; ox < 7; ++ox) {
        float* p = dz2 + (row * H2 + ox) * C2 + 4 * q;
        *reinterpret_cast<float4*>(p) =
            make_float4(acc[ox][0], acc[ox][1], acc[ox][2], acc[ox][3]);
        *reinterpret_cast<float4*>(p + 64) =
            make_float4(acc[ox][4], acc[ox][5], acc[ox][6], acc[ox][7]);
      }
    }
    csync();
    CGS_PHASE(rec, 0, 1)

    // Dense head from the accumulators; lrelu'(h2) kept as a sign mask.
    uint64_t mask = 0;
    if (!half) {
      float sum = 0.0f;
#pragma unroll
      for (int ox = 0; ox < 7; ++ox) {
        const int cell = row * H2 + ox;
        const float* w = wd_s + cell * C2 + 4 * q;
        const float4 oa = ld4(dz2 + cell * C2 + 4 * q);
        const float4 ob = ld4(dz2 + cell * C2 + 64 + 4 * q);
        const float other[8] = {oa.x, oa.y, oa.z, oa.w,
                                ob.x, ob.y, ob.z, ob.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int co = 4 * q + (j < 4 ? j : 60 + j);
          const float v = acc[ox][j] + other[j] + b1_s[co];
          if (v > 0.0f) mask |= 1ull << (8 * ox + j);
          sum = fmaf(lrelu(v), w[j < 4 ? j : 60 + j], sum);
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (q == 0) red[H2 * s + row] = sum;
    }
    csync();
    float logit = bias_d;
#pragma unroll
    for (int r = 0; r < H2; ++r) logit += red[H2 * s + r];
    if (k == steps) {
      for (int i = tid; i < SAMPLES * NX; i += CTHREADS) {
        const long long b = 2LL * blockIdx.x + i / NX;
        const int p = i % NX;
        const float* xs =
            reinterpret_cast<const float*>(samples + (i / NX) * SAMPLE_BYTES);
        if (b < batch) x_out[b * NX + p] = xs[(p / H0 + 1) * XS + p % H0 + 1];
      }
      const long long b = 2LL * blockIdx.x + s;
      if (warp == 0 && q == 0 && b < batch) logits[b] = logit;
      CGS_PHASE(rec, 0, 2)
      break;
    }

    // d softplus(-l) / dl = -sigmoid(-l); dz2 = lrelu'(h2) gl wd, over the
    // odd warp's sums (each element by the thread that read it).
    if (!half) {
      const float gl = -1.0f / (1.0f + expf(logit));
#pragma unroll
      for (int ox = 0; ox < 7; ++ox) {
        const int cell = row * H2 + ox;
        const float* w = wd_s + cell * C2 + 4 * q;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float g = gl * w[j < 4 ? j : 60 + j];
          v[j] = (mask >> (8 * ox + j)) & 1 ? g : SLOPE * g;
        }
        float* p = dz2 + cell * C2 + 4 * q;
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(p + 64) =
            make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    csync();
    CGS_PHASE(rec, 0, 2)
    conv1_vjp(dz2, h1, sched_s, ring, ring_base, rec, row, half, q);
    csync();
    CGS_PHASE(rec, 0, 3)
    conv0_vjp(samples, w0s);
    csync();
    col2im_update(samples, rate);
    csync();
    CGS_PHASE(rec, 0, 4)
  }
  CGS_PHASE_END(rec, 0)
}

}  // namespace

extern "C" {

const char* cgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x0, x_out: (batch, 28, 28) f32. w0: [25][64] f32, b0: [64] f32, w1s: 200
// tiles of 2048 f32 (ops/conv_refine.py::pack_conv1_f32: the 25 forward
// taps as 4 tiles [16 ci][128 co] each, then the VJP's 25 taps in the VJP's
// tap order as 4 tiles [32 co][64 ci] each), sched: the VJP's 25 taps
// (dy * 5 + dx) by parity class and the 5 class starts (int32), b1: [128]
// f32, wd: [7*7*128] f32 in NHWC order, bd: [1] f32.
int conv_refine28(const float* x0, float* x_out, float* logits,
                  const float* w0, const float* b0, const void* w1s,
                  const void* sched, const float* b1, const float* wd,
                  const float* bd, int batch, int steps, float rate,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_ALLOC);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  refine_kernel<<<(batch + SAMPLES - 1) / SAMPLES, THREADS, SMEM_ALLOC,
                  stream>>>(x0, x_out, logits, w0, b0,
                            static_cast<const float*>(w1s),
                            static_cast<const int*>(sched), b1, wd, bd, batch,
                            steps, rate);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
