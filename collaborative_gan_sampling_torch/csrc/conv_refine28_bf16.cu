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
// 94% of those FLOPs; each pass reads conv1's 400 KB of bf16 weights. It
// runs at ~30% of that bound (0.318 ms at B = 256, 2.44 ms at 2,048 on an
// H100 at 700 W; one block alone takes as long as a full wave, so neither
// L2 nor HBM sets the pace). By cycles: conv1's forward runs at ~550
// cycles a tap for both samples against 512 of tensor work; its VJP at
// ~880 against the ~625 that shared memory needs to move its operands
// (m64n64 steps read A and B, 4 KB per 32 tensor cycles, and the ring
// writes 16 KB a tap); the CUDA-core phases (conv0, the head, conv0's VJP,
// the update: a third of the cycles) leave the tensor cores idle, since the
// shared ring keeps the two warpgroups in step and they reach those phases
// together.
//
// Design:
// - Two samples per block (one consumer warpgroup each) and a producer
//   warpgroup, of which one thread issues the copies; at B = 256, 128
//   blocks, one per SM. The producer gives its registers back (setmaxnreg),
//   so that a consumer thread may hold 232. Per sample, shared memory
//   holds x (f32, zero-bordered 32x32 so that conv0's gather needs no range
//   test), h1 and one scratch area that is dz2 during conv1's VJP and
//   conv0's VJP partials after it; per block, the weight ring, w0 in both
//   layouts its GEMMs read, the biases and a zero row (what conv0's VJP
//   reads past its 196 rows). Each consumer thread holds the 64 weights of
//   the dense head wd beside its accumulators in registers. h2 never
//   reaches shared memory: the conv1 epilogue keeps lrelu'(h2) as a 64-bit
//   sign mask per thread and sums the dense head from the accumulators.
//   dz1 overwrites h1 in place (each element's sign is read by the thread
//   that writes it).
// - conv1's A operands lie in planes, in wgmma's no-swizzle K-major layout:
//   for each 16-byte chunk of 8 channels, a plane's cells at a 16-byte
//   stride (SBO 128 bytes: 8 cells; LBO: the distance between chunks). A
//   plane is 7x7 cells at a row pitch of PITCH = 8 (7 real and 1 zero
//   column), after one zero cell and a zero row and before a zero row:
//   PLANE = 73 cells, cell (jy, jx) at LEAD + jy * PITCH + jx for jy, jx in
//   -1 .. 7. h1 (and dz1 over it) is four planes by parity (iy % 2, ix % 2),
//   REGION = 76 cells apart within a chunk (76 = 4 mod 8 puts the two x
//   parities in opposite halves of the banks); dz2 is one plane. Output row
//   m = oy * PITCH + ox of conv1's GEMMs (ox = 7 and m > 54 are junk rows,
//   49 of the 64 real) then reads one run of 64 cells: forward tap (dy, dx)
//   the h1 plane of the parities of (dy - 1, dx - 1) from the cell of
//   output (0, 0) on (fwd_run), the VJP's class (py, px) at tap (dy, dx)
//   dz2 from cell ((py + 1 - dy) / 2, (px + 1 - dx) / 2). A tap's A operand
//   is a descriptor at a 16-byte aligned address: no gather, no registers,
//   and the border is the planes' zero cells. Junk rows read past a plane
//   into the next region or the zero tail and feed only junk accumulators;
//   no epilogue writes a junk row, since its cell is a plane's zero cell.
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
// - conv1's forward is wgmma m64n128k16 per tap (4 k-steps of 16 channels),
//   its input-VJP wgmma m64n64k16 (8 k-steps), one GEMM per parity class of
//   the h1 cells over only the taps that reach it (4, 6, 6 and 9). Each
//   tap's group is committed, then the one INFLIGHT = 1 before it waited
//   for and its ring tile released (2 in flight measured slower: each
//   warpgroup then holds 3 of the 4 tiles). The accumulators are drained
//   once a forward pass; the VJP's classes alternate between two sets of
//   accumulators, so that a class's epilogue runs under the next class's
//   first group, and only the last class is drained.
// - conv0 and its VJP are small tensor-core GEMMs on mma.sync m16n8k16:
//   the forward an im2col of bf16(x), 196 cells x 25 taps padded to K = 32,
//   against w0 (K = 32 x N = 64), its epilogue writing h1 into the planes;
//   the VJP dz1 (196 x 64, ldmatrix from the planes) x w0^T (64 x 25,
//   padded to 32) into per-(tap, cell) partials, then a col2im sum per pixel
//   over its at most 9 (cell, tap) pairs in f32, and the update. Each
//   product of two bf16 values is exact in f32, so this only reorders sums;
//   im2col costs 32/25 of the direct FLOPs.
// - Shared memory: 214,248 bytes, 215,272 allocated with the room to align
//   the base, of the 232,448 a block may use.
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
constexpr int K0 = 32;         // conv0's 25 taps padded to two k-steps
// conv0-VJP partials, a row of the 196 cells per tap (f32): 204 = 12 mod
// 32 puts a warp's stores (8 cells x 4 tap pairs) on 32 banks.
constexpr int SP = NC1 + 8;
constexpr int SW0T = K0 + 8;   // w0^T row stride (bf16): 20 words
constexpr int MT0 = (NC1 + 15) / 16;  // 13 m-tiles of conv0's GEMMs

// The planes (cells of 16 bytes: 8 channels of bf16).
constexpr int PITCH = 8;     // cells a plane row: 7 real, 1 zero
constexpr int LEAD = 9;      // cell (0, 0): after a zero cell and a zero row
constexpr int PLANE = 73;    // LEAD, 7 rows, a zero row
constexpr int REGION = 76;   // cells between planes of one chunk
constexpr int H1_CHUNK = 4 * REGION;       // cells between h1's chunks
constexpr int H1_CELLS = 8 * H1_CHUNK + 8;  // + a zero tail for junk rows
constexpr int DZ2_CHUNK = REGION;          // cells between dz2's chunks
constexpr int DZ2_CELLS = 16 * DZ2_CHUNK;
constexpr int RUN_END = LEAD + PITCH + 1 + 64;  // past the last cell a run reads
static_assert(LEAD == PITCH + 1 && PLANE == LEAD + (H2 + 1) * PITCH &&
                  PITCH == H2 + 1,
              "a plane: a zero cell and row, 7 rows of 7 + 1 zero, a zero row");
static_assert(REGION >= PLANE && REGION % 8 == 4, "planes 64 bytes apart");
static_assert(RUN_END <= REGION + H1_CELLS - 8 * H1_CHUNK,
              "the last plane's junk rows read inside the zero tail");

constexpr int SAMPLES = 2;               // per block, one warpgroup each
constexpr int THREADS = SAMPLES * 128 + 128;  // + a producer warpgroup
// Registers a thread: the producer warpgroup gives its own up so that the
// consumers may hold more than the 168 that 384 threads get at launch.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(SAMPLES * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536,
              "the register file");
constexpr int STAGES = 4;                // ring of conv1 weight tiles
constexpr int INFLIGHT = 1;              // wgmma groups left in flight
static_assert(STAGES >= INFLIGHT + 2, "a tile to wait for beyond those held");
constexpr int TILE_ELEMS = C1 * C2;      // one tap: 64 x 128 bf16
constexpr int TILE_BYTES = 2 * TILE_ELEMS;  // 16 KB
constexpr int SCHED = TAPS + 5;          // VJP tap order + 5 class starts
constexpr float SLOPE = 0.2f;

// Shared memory, from a 1024-byte aligned base (the swizzle atom).
constexpr int X_BYTES = 4 * NXS;
constexpr int H1_BYTES = 16 * H1_CELLS;
constexpr int DZ2_BYTES = 16 * DZ2_CELLS;
constexpr int P_BYTES = 4 * K0 * SP;
constexpr int SCR_BYTES = P_BYTES > DZ2_BYTES ? P_BYTES : DZ2_BYTES;
constexpr int SAMPLE_BYTES = X_BYTES + H1_BYTES + SCR_BYTES;
constexpr int OFF_RING = 0;
constexpr int OFF_SAMPLE = OFF_RING + STAGES * TILE_BYTES;
constexpr int OFF_W0 = OFF_SAMPLE + SAMPLES * SAMPLE_BYTES;
constexpr int OFF_W0T = OFF_W0 + 2 * K0 * C1;
constexpr int OFF_B0 = OFF_W0T + 2 * C1 * SW0T;
constexpr int OFF_B1 = OFF_B0 + 4 * C1;
constexpr int OFF_ZERO = OFF_B1 + 4 * C2;  // 16 zero bytes
constexpr int OFF_RED = OFF_ZERO + 16;
constexpr int OFF_SCHED = OFF_RED + 4 * SAMPLES * 4;
constexpr int OFF_BAR = OFF_SCHED + 4 * ((SCHED + 1) / 2 * 2);
constexpr int SMEM_BYTES = OFF_BAR + 8 * 2 * STAGES;
constexpr int SMEM_ALLOC = SMEM_BYTES + 1024;  // room to align the base

static_assert(SMEM_ALLOC <= 232448, "fits the 227 KB a block may use");
static_assert(SMEM_BYTES == 214248, "the total the note above states");
static_assert(X_BYTES % 16 == 0 && H1_BYTES % 16 == 0 &&
                  SCR_BYTES % 16 == 0 && OFF_W0T % 16 == 0 &&
                  OFF_ZERO % 16 == 0 && OFF_BAR % 8 == 0,
              "aligned shared buffers");
static_assert(16 * (DZ2_CELLS - DZ2_CHUNK + RUN_END) <= SCR_BYTES,
              "dz2's junk rows read inside the scratch area");
static_assert(TILE_BYTES % 1024 == 0, "tiles keep the swizzle alignment");

// v > 0 ? v : SLOPE v, for 0 < SLOPE < 1 (zeros keep their sign).
__device__ __forceinline__ float lrelu(float v) {
  return fmaxf(v, SLOPE * v);
}

// Two consecutive bf16 values (the lower index in the low half), as one
// 32-bit fragment register.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// bf16(lo) in the low half, bf16(hi) in the high half, rounded to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// The cell of h1 / dz1 (iy, ix) in chunk 0, iy and ix in -1 .. 14: its
// parity plane's region, then (iy >> 1, ix >> 1) in the plane.
__device__ __forceinline__ int h1_cell(int iy, int ix) {
  return ((iy & 1) * 2 + (ix & 1)) * REGION + LEAD + (iy >> 1) * PITCH +
         (ix >> 1);
}

// First cell of the run that conv1's forward reads at `tap`: the h1 cell
// that output (0, 0) reads there. Output row m reads cell fwd_run + m.
__device__ __forceinline__ int fwd_run(int tap) {
  return h1_cell(tap / 5 - 1, tap % 5 - 1);
}

// First cell of the run that the VJP's class (py, px) reads at `tap`: the
// dz2 cell that h1 cell (py, px) reads there. Row m reads cell vjp_run + m.
__device__ __forceinline__ int vjp_run(int py, int px, int tap) {
  return LEAD + (py + 1 - tap / 5) / 2 * PITCH + (px + 1 - tap % 5) / 2;
}

// Whether conv1's output row m (oy * PITCH + ox) is one of the 49 cells.
__device__ __forceinline__ bool real_row(int m) {
  return (m & (PITCH - 1)) < H2 && m < H2 * PITCH;
}

// k-th of a plane's 24 zero cells (0 <= k < 24): the leading cell and the
// zero row above, the zero column of rows 0 .. 6, the zero row below.
__device__ __forceinline__ int border_cell(int k) {
  return k < LEAD          ? k
         : k < LEAD + H2   ? LEAD + (k - LEAD) * PITCH + H2
                           : LEAD + H2 * PITCH + (k - LEAD - H2);
}
constexpr int BORDER = PLANE - H2 * H2;  // 24

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

// Four 8x8 bf16 matrices, lane l giving the address of row l % 8 of matrix
// l / 8; matrix j lands in a[j] in mma.sync's fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// Barrier over one warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// wg_sync after this thread's shared-memory writes that wgmma (the async
// proxy) reads next.
__device__ __forceinline__ void wg_sync_for_wgmma(int wg) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_sync(wg);
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

// Descriptor of a plane run in the no-swizzle K-major layout: row r at
// saddr + 16 r (SBO 128 bytes per 8 rows), the next 8 channels `lbo` bytes
// on. Its address field counts 16-byte cells.
__device__ __forceinline__ uint64_t plane_desc(uint32_t saddr, uint32_t lbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma (their registers are written after the asm returns).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16 bf16) * B (16 x 128), both in shared
// memory. Accumulator layout (warp w of the warpgroup, g = lane / 4,
// t = lane % 4): d[4j + 2h + e] = D[16 w + g + 8h][8j + 2t + e].
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, f32) = A (64 x 16) * B (16 x 64) + (keep ? d : 0), both
// operands in shared memory.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(keep));
}

// ---- the consumer warpgroup's phases ----------------------------------------

using WeightRing = Ring<STAGES, TILE_BYTES>;

// Tiles flow through two views of the ring: `ring` takes them (waits and
// moves on), `used` releases them once the group that read them is done.
// After a tap's group is committed, the group INFLIGHT taps before it is
// waited for and its tile released.
template <int N>
__device__ __forceinline__ void retire(float (&acc)[N], WeightRing& used) {
  wgmma_wait<INFLIGHT>();
  fence_regs(acc);
  used.release();
}

// Waits for every group, and releases the tiles still held.
template <int N>
__device__ __forceinline__ void drain(float (&acc)[N], WeightRing& used) {
  wgmma_wait<0>();
  fence_regs(acc);
  for (int i = 0; i < INFLIGHT; ++i) used.release();
}

// h1[cell][c] = bf16(lrelu(b0[c] + sum_tap bf16(x at (cell, tap)) w0[tap][c]))
// as a GEMM: im2col rows of the 196 cells (13 m-tiles: warp w takes w,
// w + 4 and w + 8, and n-tiles 2w, 2w + 1 of the last, which holds 4 cells)
// x w0 (K = 32, taps 25..31 zero; N = 64, 8 n-tiles), written into h1's
// planes.
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
  // m-tile mt, the n-tiles nt with bit nt of nmask.
  auto tile = [&](int mt, unsigned nmask) {
    int base[2], dst[2];
    bool rok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      rok[h] = r < NC1;
      base[h] = 2 * (r / H1) * XS + 2 * (r % H1);
      dst[h] = 8 * h1_cell(r / H1, r % H1) + 2 * t;
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
      if (!(nmask >> nt & 1)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        mma_bf16(acc[nt], a[ks][0], a[ks][1], a[ks][2], a[ks][3],
                 b[nt][ks][0], b[nt][ks][1]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (!(nmask >> nt & 1)) continue;
      const int c = nt * 8 + 2 * t;
      const float2 bias = *reinterpret_cast<const float2*>(b0 + c);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (rok[h])
          *reinterpret_cast<uint32_t*>(h1 + dst[h] + 8 * nt * H1_CHUNK) =
              pack_bf16(lrelu(acc[nt][2 * h] + bias.x),
                        lrelu(acc[nt][2 * h + 1] + bias.y));
    }
  };
  for (int mt = wl; mt < MT0 - 1; mt += 4) tile(mt, 0xFFu);
  tile(MT0 - 1, 3u << (2 * wl));
}

// acc[m][co] = sum_{tap, ci} h1[in(m, tap)][ci] w1[tap][ci][co] on wgmma,
// one tap per ring tile, A the tap's run of an h1 plane (h1a: its shared
// address).
__device__ void conv1_fwd(uint32_t h1a, WeightRing& ring, WeightRing& used,
                          bool rec, int wg, float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int tap = 0; tap < TAPS; ++tap) {
    const uint64_t a = plane_desc(h1a + 16 * fwd_run(tap), 16 * H1_CHUNK);
    const uint64_t b = sw128_desc(ring.take(rec, wg));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_n128(acc, a + 2 * ks * H1_CHUNK, b + 2 * ks);
    wgmma_commit();
    if (tap >= INFLIGHT) retire(acc, used);
  }
  drain(acc, used);
}

// Class c's dz1 from its accumulators, written over h1's plane c: row m is
// the plane's cell LEAD + m, and each element's lrelu' is read there.
__device__ __forceinline__ void dz1_epilogue(const float (&acc)[32],
                                             __nv_bfloat16* h1, int c) {
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * wl + g + 8 * h;
      if (!real_row(m)) continue;
      uint32_t* p = reinterpret_cast<uint32_t*>(
          h1 + 8 * (c * REGION + LEAD + m + j8 * H1_CHUNK) + 2 * t);
      const float2 hv = unpack_bf16(*p);
      const float v0 = acc[4 * j8 + 2 * h], v1 = acc[4 * j8 + 2 * h + 1];
      *p = pack_bf16(hv.x > 0.0f ? v0 : SLOPE * v0,
                     hv.y > 0.0f ? v1 : SLOPE * v1);
    }
}

// dz1[cell][ci] = bf16(lrelu'(h1) * sum_{tap, co} dz2[out(cell, tap)][co]
//                                                  w1[tap][ci][co]),
// written over h1. h1 cell (iy, ix) = (2 jy + py, 2 jx + px); tap dy reaches
// it only when py + 1 - dy is even, from output row jy + (py + 1 - dy) / 2
// (and so for x). One GEMM per parity class, tap by tap as conv1_fwd, A the
// tap's run of the dz2 plane (dz2a); class c's rows are the cells of h1's
// plane c. The taps of class c are sched[sched[TAPS + c]] ..
// sched[sched[TAPS + c + 1] - 1], in ring order. Classes alternate between
// two sets of accumulators, so that class c's epilogue runs while the
// first group of class c + 1 does; a class's first wgmma overwrites its
// accumulators (no instruction but wgmma writes them while a group is in
// flight, or ptxas serializes the wgmmas).
__device__ void conv1_vjp(uint32_t dz2a, __nv_bfloat16* h1, const int* sched,
                          WeightRing& ring, WeightRing& used, bool rec,
                          int wg) {
  float acc[2][32];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int py = c >> 1, px = c & 1;
    const int j0 = sched[TAPS + c], j1 = sched[TAPS + c + 1];
    for (int j = j0; j < j1; ++j) {
      const uint64_t a =
          plane_desc(dz2a + 16 * vjp_run(py, px, sched[j]), 16 * DZ2_CHUNK);
      const uint64_t b = sw128_desc(ring.take(rec, wg));
      wgmma_fence();
      // K = 128 channels: two 64-wide swizzle atoms of 8 KB in B.
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        wgmma_n64(acc[c & 1], a + 2 * ks * DZ2_CHUNK,
                  b + (ks / 4) * (8192 >> 4) + 2 * (ks % 4), j > j0 || ks);
      wgmma_commit();
      if (j >= INFLIGHT) {
        retire(acc[c & 1], used);
        if (c > 0 && j - INFLIGHT == j0 - 1) {  // class c - 1 is done
          fence_regs(acc[(c - 1) & 1]);
          dz1_epilogue(acc[(c - 1) & 1], h1, c - 1);
        }
      }
    }
  }
  drain(acc[1], used);
  dz1_epilogue(acc[1], h1, 3);
}

// part[tap][cell] = sum_c dz1[cell][c] w0[tap][c] for the 196 cells and 32
// (padded) taps: 13 m-tiles x 4 n-tiles, K = 64 (warp w takes m-tiles w,
// w + 4 and w + 8, and n-tile w of the last); A by ldmatrix from the
// planes (dz1a), the zero cell past the 196 rows.
__device__ void conv0_vjp(uint32_t dz1a, const __nv_bfloat16* w0s,
                          uint32_t zero, float* part) {
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
  // m-tile mt, the n-tiles nt with bit nt of nmask.
  auto tile = [&](int mt, unsigned nmask) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    // This lane's ldmatrix row: matrices 0 .. 3 are rows 0-7 and 8-15 of
    // the tile at channels 16 ks + 0..7, then the same at + 8..15.
    const int r = mt * 16 + (lane & 7) + (lane & 8);
    const uint32_t row =
        r < NC1 ? dz1a + 16 * (h1_cell(r / H1, r % H1) +
                               (lane >> 4) * H1_CHUNK)
                : zero;
    const uint32_t kstep = r < NC1 ? 2 * 16 * H1_CHUNK : 0;
    uint32_t a[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) ldmatrix_x4(a[ks], row + ks * kstep);
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (nmask >> nt & 1)
          mma_bf16(acc[nt], a[ks][0], a[ks][1], a[ks][2], a[ks][3],
                   b[nt][ks][0], b[nt][ks][1]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (!(nmask >> nt & 1)) continue;
      const int tap = nt * 8 + 2 * t;
      if (r0 < NC1) {
        part[tap * SP + r0] = acc[nt][0];
        part[(tap + 1) * SP + r0] = acc[nt][1];
      }
      if (r1 < NC1) {
        part[tap * SP + r1] = acc[nt][2];
        part[(tap + 1) * SP + r1] = acc[nt][3];
      }
    }
  };
  for (int mt = wl; mt < MT0 - 1; mt += 4) tile(mt, 0xFu);
  tile(MT0 - 1, 1u << wl);
}

// x[iy][ix] -= rate * sum of part[tap][cell] over the (cell, tap) pairs that
// read pixel (iy, ix): iy + 1 - dy = 2 oy with 0 <= oy < 14 (and so for x),
// in the order of (dy, dx). Pixels go by parity class (iy % 2, ix % 2),
// whose pixels all take the same taps: a warp's lanes take one path, and
// neighbouring lanes read neighbouring cells.
__device__ void col2im_update(const float* part, float* xs, float rate) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int qy = q >> 1, qx = q & 1;
    for (int j = threadIdx.x & 127; j < NC1; j += 128) {
      const int iy = 2 * (j / H1) + qy, ix = 2 * (j % H1) + qx;
      float acc = 0.0f;
#pragma unroll
      for (int dy = (qy + 1) & 1; dy < 5; dy += 2) {
        const int oy = (iy + 1 - dy) >> 1;
        if (oy < 0 || oy >= H1) continue;
#pragma unroll
        for (int dx = (qx + 1) & 1; dx < 5; dx += 2) {
          const int ox = (ix + 1 - dx) >> 1;
          if (ox < 0 || ox >= H1) continue;
          acc += part[(dy * 5 + dx) * SP + oy * H1 + ox];
        }
      }
      xs[(iy + 1) * XS + ix + 1] -= rate * acc;
    }
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
  float* b0_s = reinterpret_cast<float*>(smem + OFF_B0);
  float* b1_s = reinterpret_cast<float*>(smem + OFF_B1);
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
  for (int i = tid; i < C1; i += THREADS) b0_s[i] = b0[i];
  for (int i = tid; i < C2; i += THREADS) b1_s[i] = b1[i];
  if (tid == 0)
    *reinterpret_cast<uint4*>(smem + OFF_ZERO) = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < SAMPLES * NXS; i += THREADS) {
    const int s = i / NXS, p = i % NXS, r = p / XS - 1, c = p % XS - 1;
    const long long b = 2LL * blockIdx.x + s;
    const bool in = b < batch && r >= 0 && r < H0 && c >= 0 && c < H0;
    reinterpret_cast<float*>(smem + OFF_SAMPLE + s * SAMPLE_BYTES)[p] =
        in ? x0[b * NX + r * H0 + c] : 0.0f;
  }
  // The h1 planes' zero cells (and tail) stay zero: only real cells are
  // ever written.
  for (int i = tid; i < SAMPLES * H1_CELLS; i += THREADS)
    reinterpret_cast<uint4*>(smem + OFF_SAMPLE + X_BYTES +
                             i / H1_CELLS * SAMPLE_BYTES)[i % H1_CELLS] =
        make_uint4(0, 0, 0, 0);
  __syncthreads();

  if (warp >= 4 * SAMPLES) {
    // Producer: the fixed tile schedule, (2K + 1) passes of 25 tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 4 * SAMPLES * 32)
      ring_produce<STAGES, TILE_BYTES, TAPS>(
          tiles, full, reinterpret_cast<const unsigned char*>(w1s),
          2 * steps + 1);
    return;
  }

  // Consumer warpgroup wg: sample 2 * blockIdx.x + wg.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2, lane = tid & 31, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool rec = (tid & 127) == 0;
  unsigned char* mine = smem + OFF_SAMPLE + wg * SAMPLE_BYTES;
  float* xs = reinterpret_cast<float*>(mine);
  __nv_bfloat16* h1 = reinterpret_cast<__nv_bfloat16*>(mine + X_BYTES);
  __nv_bfloat16* dz2 =
      reinterpret_cast<__nv_bfloat16*>(mine + X_BYTES + H1_BYTES);
  float* part = reinterpret_cast<float*>(mine + X_BYTES + H1_BYTES);
  const uint32_t h1a = smem_u32(h1), dz2a = smem_u32(dz2);
  const long long b = 2LL * blockIdx.x + wg;
  const float bias_d = __ldg(bd);
  // This thread's dense-head weights, wdr[i / 2] beside acc[i], acc[i + 1]
  // (zeros on junk rows).
  float2 wdr[32];
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int m = 16 * wl + g + 8 * ((i >> 1) & 1);
    wdr[i >> 1] = real_row(m) ? __ldg(reinterpret_cast<const float2*>(
                                    wd + ((m / PITCH) * H2 + m % PITCH) * C2 +
                                    8 * (i >> 2) + 2 * t))
                              : make_float2(0.0f, 0.0f);
  }
  WeightRing ring{tiles, full, 0}, used{tiles, full, 0};
  CGS_PHASE_BEGIN(rec, wg)

  for (int k = 0;; ++k) {
    conv0_fwd(xs, w0t, b0_s, h1);
    wg_sync_for_wgmma(wg);
    CGS_PHASE(rec, wg, 0)
    float acc[64];
    conv1_fwd(h1a, ring, used, rec, wg, acc);
    CGS_PHASE(rec, wg, 1)

    // Dense head from the accumulators; lrelu'(h2) kept as a sign mask.
    float s = 0.0f;
    uint64_t mask = 0;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int m = 16 * wl + g + 8 * ((i >> 1) & 1);
      const int co = 8 * (i >> 2) + 2 * t;
      if (real_row(m)) {
        const float2 bias = *reinterpret_cast<const float2*>(b1_s + co);
        const float v0 = acc[i] + bias.x, v1 = acc[i + 1] + bias.y;
        if (v0 > 0.0f) mask |= 1ull << i;
        if (v1 > 0.0f) mask |= 1ull << (i + 1);
        s = fmaf(lrelu(v0), wdr[i >> 1].x, s);
        s = fmaf(lrelu(v1), wdr[i >> 1].y, s);
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

    // d softplus(-l) / dl = -sigmoid(-l); dz2 = bf16(lrelu'(h2) gl wd),
    // into its plane, whose zero cells conv0's VJP partials overwrote.
    const float gl = -1.0f / (1.0f + expf(logit));
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int m = 16 * wl + g + 8 * ((i >> 1) & 1);
      if (real_row(m)) {
        const float v0 = gl * wdr[i >> 1].x, v1 = gl * wdr[i >> 1].y;
        *reinterpret_cast<uint32_t*>(
            dz2 + 8 * (LEAD + m + (i >> 2) * DZ2_CHUNK) + 2 * t) =
            pack_bf16((mask >> i) & 1 ? v0 : SLOPE * v0,
                      (mask >> (i + 1)) & 1 ? v1 : SLOPE * v1);
      }
    }
    for (int i = tid & 127; i < 16 * BORDER; i += 128)
      *reinterpret_cast<uint4*>(
          dz2 + 8 * (border_cell(i % BORDER) + i / BORDER * DZ2_CHUNK)) =
          make_uint4(0, 0, 0, 0);
    wg_sync_for_wgmma(wg);
    CGS_PHASE(rec, wg, 2)
    conv1_vjp(dz2a, h1, sched_s, ring, used, rec, wg);
    wg_sync(wg);
    CGS_PHASE(rec, wg, 3)
    conv0_vjp(h1a, w0s, smem_u32(smem + OFF_ZERO), part);
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
