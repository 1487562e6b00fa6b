// Fused K-step refinement under the 28x28x1 / 64-filter DCGAN discriminator
// with bf16 matmul operands and float32 sums, on Hopper's tensor cores
// (sm_90a).
//
// Replaces the bf16 mode of the TPU kernel collaborative_gan_sampling_tpu/
// ops/conv_refine_pallas.py::fused_refine_conv28_v2 (_refine_kernel_v2 with
// mm_dtype bfloat16). It computes what ops/conv_refine_ref.py::
// refine_conv28_plain_bf16 computes, for the D in eval mode with BatchNorm
// folded into conv1 (the wrapper folds and casts):
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
// sigmoid, the update and x itself stay f32.
//
// Both convs use XLA's SAME padding (low 1, high 2): input index
// iy = 2*oy + dy - 1. The input-VJPs read the same taps as gathers,
// oy = (iy + 1 - dy) / 2 where that is an integer in range.
//
// Design: one thread block (8 warps) per sample runs the whole K loop; x,
// conv0's weights, h1 and dz1 (bf16, 14x14x64), h2 (f32, 7x7x128) and dz2
// (bf16) stay in shared memory, about 99 KB, so two blocks fit on an SM and
// no activation touches device memory between steps. conv1's weights
// (2 x 400 KB of bf16: [tap][co][ci] for the forward, [tap][ci][co] for the
// input-VJP) and the dense head are read through L2.
//
// - conv1 forward is an implicit GEMM on the tensor cores
//   (mma.sync.m16n8k16, bf16 x bf16 -> f32): M = 49 output cells padded to
//   64, N = 128 (each warp 16 columns), K = 64 per tap over the 25 taps; a
//   row whose tap falls on the zero border loads zeros.
// - conv1's input-VJP is four such GEMMs, one per parity class (iy % 2,
//   ix % 2) of the 196 h1 cells: M = 49 cells padded to 64, N = 64 (each
//   warp 8 columns), K = 128 per tap over the taps of that parity (4, 6, 6
//   and 9 of them), so no MMA is spent on a tap that cannot reach the cell.
// - conv0 and its input-VJP have one input channel, K = 25 per output: they
//   stay f32 FMAs on the CUDA cores over the bf16-rounded operands, the same
//   function because each product of two bf16 values is exact in f32.
//   Folding them into a sparse 400-wide matmul, as v2 does for the MXU,
//   would spend 16x the FLOPs.
// - h1 is kept as bf16: it is only ever a matmul operand, and its sign (the
//   lrelu' mask) survives the rounding. Rows of h1, dz1 and dz2 are padded
//   (68 and 136 bf16) so that a fragment load's 8 rows fall in distinct
//   shared-memory banks. The rate is a runtime argument.
//
// Bound: operations. (2K + 1) D forwards of 17.36 MFLOP per sample (taps on
// the zero border not counted; the VJP touches the same pairs): 93.35 GFLOP
// at B = 256, K = 10, 0.094 ms at 989 TFLOP/s dense bf16. Not yet done:
// wgmma (the warpgroup MMA that reaches that rate; mma.sync gets a fraction
// of it), TMA staging of conv1's weights in shared memory, several samples
// per block so that each weight load feeds more than one sample's rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H0 = 28, H1 = 14, H2 = 7, C1 = 64, C2 = 128, TAPS = 25;
constexpr int NX = H0 * H0;     // 784 pixels
constexpr int NC1 = H1 * H1;    // 196 h1 cells
constexpr int NC2 = H2 * H2;    // 49 h2 cells
constexpr int NW0 = TAPS * C1;  // 1600
constexpr int S1 = C1 + 4;      // h1 / dz1 row stride (bf16): 34 words
constexpr int S2 = C2 + 8;      // dz2 row stride (bf16): 68 words
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MT = 4;  // m-tiles of 16 rows over the 49 cells
constexpr float SLOPE = 0.2f;

constexpr int SMEM_BYTES = 4 * (NX + NW0 + NC2 * C2 + 32)
                           + 2 * (2 * NC1 * S1 + NC2 * S2);

static_assert(WARPS * 16 == C2, "conv1 forward: each warp takes 16 columns");
static_assert(WARPS * 8 == C1, "conv1 VJP: each warp takes 8 columns");
static_assert(MT * 16 >= NC2, "m-tiles cover the 49 cells");
static_assert((NX + NW0 + NC2 * C2 + 32) % 4 == 0 && (NC1 * S1) % 8 == 0,
              "16-byte aligned shared buffers");

__device__ __forceinline__ float lrelu(float v) {
  return v > 0.0f ? v : SLOPE * v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two consecutive bf16 values (the lower index in the low half), as one
// 32-bit fragment register.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg_pair(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(lane < WARPS ? red[lane] : 0.0f);
    if (lane == 0) red[31] = v;
  }
  __syncthreads();
  const float r = red[31];
  __syncthreads();
  return r;
}

// h1[cell * S1 + c] = bf16(lrelu(b0[c] + sum_taps bf16(x[iy][ix]) * w0[tap][c]))
__device__ void conv0_fwd(const float* xs, const float* w0s,
                          const float* __restrict__ b0, __nv_bfloat16* h1) {
  for (int i = threadIdx.x; i < NC1 * C1; i += THREADS) {
    const int c = i % C1, p = i / C1, oy = p / H1, ox = p % H1;
    float acc = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy) {
      const int iy = 2 * oy + dy - 1;
      if (iy < 0 || iy >= H0) continue;
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) {
        const int ix = 2 * ox + dx - 1;
        if (ix < 0 || ix >= H0) continue;
        acc = fmaf(bf16_round(xs[iy * H0 + ix]), w0s[(dy * 5 + dx) * C1 + c],
                   acc);
      }
    }
    h1[p * S1 + c] = __float2bfloat16_rn(lrelu(acc + __ldg(b0 + c)));
  }
}

// h2[cell * C2 + co] = lrelu(b1[co] + sum_{tap, ci} h1[in(cell, tap)][ci]
//                                      * w1f[tap][co][ci])
// Warp w computes columns 16w .. 16w + 15 for all 49 rows.
__device__ void conv1_fwd(const __nv_bfloat16* h1,
                          const __nv_bfloat16* __restrict__ w1f,
                          const float* __restrict__ b1, float* h2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;

  for (int tap = 0; tap < TAPS; ++tap) {
    const int dy = tap / 5, dx = tap % 5;
    // This thread's A rows (g and g + 8 of each m-tile): where the tap
    // reads h1, or null where it reads the zero border or pads M.
    const __nv_bfloat16* src[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + g + 8 * h;
        const int iy = 2 * (m / H2) + dy - 1, ix = 2 * (m % H2) + dx - 1;
        const bool ok = m < NC2 && iy >= 0 && iy < H1 && ix >= 0 && ix < H1;
        src[mt][h] = ok ? h1 + (iy * H1 + ix) * S1 + 2 * t : nullptr;
      }
    const __nv_bfloat16* wp =
        w1f + (static_cast<size_t>(tap) * C2 + warp * 16 + g) * C1 + 2 * t;
#pragma unroll
    for (int ks = 0; ks < C1 / 16; ++ks) {
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const __nv_bfloat16* w = wp + nt * 8 * C1 + ks * 16;
        b[nt][0] = ldg_pair(w);
        b[nt][1] = ldg_pair(w + 8);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* r0 = src[mt][0];
        const __nv_bfloat16* r1 = src[mt][1];
        const uint32_t a0 = r0 ? ld_pair(r0 + ks * 16) : 0u;
        const uint32_t a1 = r1 ? ld_pair(r1 + ks * 16) : 0u;
        const uint32_t a2 = r0 ? ld_pair(r0 + ks * 16 + 8) : 0u;
        const uint32_t a3 = r1 ? ld_pair(r1 + ks * 16 + 8) : 0u;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma_bf16(acc[mt][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int co = warp * 16 + nt * 8 + 2 * t;
      const float bias0 = __ldg(b1 + co), bias1 = __ldg(b1 + co + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + g + 8 * h;
        if (m < NC2) {
          h2[m * C2 + co] = lrelu(acc[mt][nt][2 * h] + bias0);
          h2[m * C2 + co + 1] = lrelu(acc[mt][nt][2 * h + 1] + bias1);
        }
      }
    }
}

// dz1[cell * S1 + ci] = bf16(lrelu'(h1) * sum_{tap, co} dz2[out(cell, tap)][co]
//                                                      * w1b[tap][ci][co])
// h1 cell (iy, ix) = (2 jy + py, 2 jx + px); a tap dy reaches it only when
// py + 1 - dy is even, from output row oy = jy + (py + 1 - dy) / 2 (and so
// for x). One GEMM per parity class; warp w computes columns 8w .. 8w + 7.
__device__ void conv1_bwd(const __nv_bfloat16* dz2, const __nv_bfloat16* h1,
                          const __nv_bfloat16* __restrict__ w1b,
                          __nv_bfloat16* dz1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int py = 0; py < 2; ++py) {
    for (int px = 0; px < 2; ++px) {
      float acc[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][j] = 0.0f;

      for (int dy = 1 - py; dy < 5; dy += 2) {
        const int sy = (py + 1 - dy) / 2;  // exact: py + 1 - dy is even
        for (int dx = 1 - px; dx < 5; dx += 2) {
          const int sx = (px + 1 - dx) / 2;
          const __nv_bfloat16* src[MT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = mt * 16 + g + 8 * h;
              const int oy = m / H2 + sy, ox = m % H2 + sx;
              const bool ok =
                  m < NC2 && oy >= 0 && oy < H2 && ox >= 0 && ox < H2;
              src[mt][h] = ok ? dz2 + (oy * H2 + ox) * S2 + 2 * t : nullptr;
            }
          const __nv_bfloat16* wp =
              w1b + (static_cast<size_t>(dy * 5 + dx) * C1 + warp * 8 + g) * C2
              + 2 * t;
#pragma unroll
          for (int ks = 0; ks < C2 / 16; ++ks) {
            const uint32_t b0 = ldg_pair(wp + ks * 16);
            const uint32_t b1 = ldg_pair(wp + ks * 16 + 8);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const __nv_bfloat16* r0 = src[mt][0];
              const __nv_bfloat16* r1 = src[mt][1];
              const uint32_t a0 = r0 ? ld_pair(r0 + ks * 16) : 0u;
              const uint32_t a1 = r1 ? ld_pair(r1 + ks * 16) : 0u;
              const uint32_t a2 = r0 ? ld_pair(r0 + ks * 16 + 8) : 0u;
              const uint32_t a3 = r1 ? ld_pair(r1 + ks * 16 + 8) : 0u;
              mma_bf16(acc[mt], a0, a1, a2, a3, b0, b1);
            }
          }
        }
      }
      const int ci = warp * 8 + 2 * t;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + g + 8 * h;
          if (m >= NC2) continue;
          const int cell = (2 * (m / H2) + py) * H1 + 2 * (m % H2) + px;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = cell * S1 + ci + j;
            const float v = acc[mt][2 * h + j];
            dz1[k] = __float2bfloat16_rn(
                __bfloat162float(h1[k]) > 0.0f ? v : SLOPE * v);
          }
        }
    }
  }
}

// x -= rate * (input-VJP of conv0 applied to dz1). One warp per pixel,
// each lane two of the 64 channels.
__device__ void conv0_bwd_update(const __nv_bfloat16* dz1, const float* w0s,
                                 float* xs, float rate) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < NX; p += WARPS) {
    const int iy = p / H0, ix = p % H0;
    float acc = 0.0f;
    for (int dy = 0; dy < 5; ++dy) {
      const int ty = iy + 1 - dy;
      if (ty < 0 || (ty & 1) || (ty >> 1) >= H1) continue;
      for (int dx = 0; dx < 5; ++dx) {
        const int tx = ix + 1 - dx;
        if (tx < 0 || (tx & 1) || (tx >> 1) >= H1) continue;
        const float2 d = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                dz1 + ((ty >> 1) * H1 + (tx >> 1)) * S1 + 2 * lane));
        const float2 w = *reinterpret_cast<const float2*>(
            w0s + (dy * 5 + dx) * C1 + 2 * lane);
        acc = fmaf(d.x, w.x, acc);
        acc = fmaf(d.y, w.y, acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) xs[p] -= rate * acc;
  }
}

__device__ float forward(const float* xs, const float* w0s,
                         const float* __restrict__ b0,
                         const __nv_bfloat16* __restrict__ w1f,
                         const float* __restrict__ b1,
                         const float* __restrict__ wd, float bd,
                         __nv_bfloat16* h1, float* h2, float* red) {
  conv0_fwd(xs, w0s, b0, h1);
  __syncthreads();
  conv1_fwd(h1, w1f, b1, h2);
  __syncthreads();
  float s = 0.0f;
  for (int i = threadIdx.x; i < NC2 * C2; i += THREADS)
    s = fmaf(h2[i], __ldg(wd + i), s);
  return block_sum(s, red) + bd;
}

__global__ void __launch_bounds__(THREADS, 2)
    refine_bf16_kernel(const float* __restrict__ x0, float* __restrict__ x_out,
                       float* __restrict__ logits,
                       const __nv_bfloat16* __restrict__ w0,
                       const float* __restrict__ b0,
                       const __nv_bfloat16* __restrict__ w1f,
                       const __nv_bfloat16* __restrict__ w1b,
                       const float* __restrict__ b1,
                       const float* __restrict__ wd,
                       const float* __restrict__ bd, int steps, float rate) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* w0s = xs + NX;
  float* h2 = w0s + NW0;
  float* red = h2 + NC2 * C2;
  __nv_bfloat16* h1 = reinterpret_cast<__nv_bfloat16*>(red + 32);
  __nv_bfloat16* dz1 = h1 + NC1 * S1;
  __nv_bfloat16* dz2 = dz1 + NC1 * S1;

  const long long base = static_cast<long long>(blockIdx.x) * NX;
  for (int i = threadIdx.x; i < NX; i += THREADS) xs[i] = x0[base + i];
  for (int i = threadIdx.x; i < NW0; i += THREADS)
    w0s[i] = __bfloat162float(w0[i]);
  const float bias_d = __ldg(bd);
  __syncthreads();

  for (int k = 0; k < steps; ++k) {
    const float logit =
        forward(xs, w0s, b0, w1f, b1, wd, bias_d, h1, h2, red);
    // d softplus(-l) / dl = -sigmoid(-l)
    const float gl = -1.0f / (1.0f + expf(logit));
    for (int i = threadIdx.x; i < NC2 * C2; i += THREADS) {
      const float v = gl * __ldg(wd + i);
      dz2[(i / C2) * S2 + i % C2] =
          __float2bfloat16_rn(h2[i] > 0.0f ? v : SLOPE * v);
    }
    __syncthreads();
    conv1_bwd(dz2, h1, w1b, dz1);
    __syncthreads();
    conv0_bwd_update(dz1, w0s, xs, rate);
    __syncthreads();
  }
  const float logit = forward(xs, w0s, b0, w1f, b1, wd, bias_d, h1, h2, red);
  for (int i = threadIdx.x; i < NX; i += THREADS) x_out[base + i] = xs[i];
  if (threadIdx.x == 0) logits[blockIdx.x] = logit;
}

}  // namespace

extern "C" {

const char* cgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x0, x_out: (batch, 28, 28) f32. w0: [25][64] bf16, b0: [64] f32,
// w1f: [25][128][64] bf16 (forward: [tap][co][ci]), w1b: [25][64][128] bf16
// (input-VJP: [tap][ci][co]), b1: [128] f32, wd: [7*7*128] f32 in NHWC
// order, bd: [1] f32.
int conv_refine28_bf16(const float* x0, float* x_out, float* logits,
                       const void* w0, const float* b0, const void* w1f,
                       const void* w1b, const float* b1, const float* wd,
                       const float* bd, int batch, int steps, float rate,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      refine_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  refine_bf16_kernel<<<batch, THREADS, SMEM_BYTES, stream>>>(
      x0, x_out, logits, static_cast<const __nv_bfloat16*>(w0), b0,
      static_cast<const __nv_bfloat16*>(w1f),
      static_cast<const __nv_bfloat16*>(w1b), b1, wd, bd, steps, rate);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
