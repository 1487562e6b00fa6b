// Fused K-step refinement under the 28x28x1 / 64-filter DCGAN discriminator,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels collaborative_gan_sampling_tpu/ops/
// conv_refine_pallas.py: fused_refine_conv28 (_refine_kernel) and, at f32
// operands, fused_refine_conv28_v2 (_refine_kernel_v2). It computes what
// ops/conv_refine_ref.py::refine_s2d_reference computes, for the D in eval
// mode with BatchNorm folded into conv1 (the wrapper folds):
//
//   K times:  x <- x - rate * d softplus(-D(x)) / dx
//   then:     logit = D(x)
//
//   D(x) = wd . lrelu(conv1(lrelu(conv0(x)))) + bd
//   conv0: 5x5 / stride 2, 1 -> 64,   28x28 -> 14x14
//   conv1: 5x5 / stride 2, 64 -> 128, 14x14 -> 7x7 (BN folded)
//
// Both convs use XLA's SAME padding (low 1, high 2): input index
// iy = 2*oy + dy - 1. The input-VJPs are the same taps read as gathers,
// oy = (iy + 1 - dy) / 2 where that is an integer in range.
//
// Design: one thread block per sample runs the whole K loop. x (784 floats),
// conv0's weights, h1 (14x14x64), h2 (7x7x128, overwritten by its gradient)
// and dh1 (14x14x64) stay in shared memory, about 132 KB, so no activation
// touches device memory between steps. conv1's weights (2 x 800 KB: one copy
// laid out for the forward, one transposed for the input-VJP) and the dense
// head are read through L2. Each thread owns one (channel, output row) and
// keeps a row of accumulators in registers, so each weight it loads serves
// 7 (forward) or up to 14 (VJP) outputs; shared-memory activations are read
// as float4 broadcasts. The rate is a runtime argument.
//
// Bound: operations. (2K + 1) D forwards of 17.36 MFLOP per sample, taps
// on the zero border not counted (the VJP touches the same (output, tap)
// pairs as the forward), all f32 on the CUDA cores; the bytes
// (x in and out, 1.6 MB of weights) are negligible. Not yet done: tensor
// cores (wgmma), several samples per block to share each weight load.

#include <cuda_runtime.h>

namespace {

constexpr int H0 = 28, H1 = 14, H2 = 7, C1 = 64, C2 = 128, TAPS = 25;
constexpr int NX = H0 * H0;       // 784
constexpr int N1 = H1 * H1 * C1;  // 12544
constexpr int N2 = H2 * H2 * C2;  // 6272
constexpr int NW0 = TAPS * C1;    // 1600
constexpr int THREADS = 448;      // 14 warps; 896 (channel, row) items
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_FLOATS = NX + NW0 + N1 + N2 + N1 + 32;
constexpr int SMEM_BYTES = SMEM_FLOATS * static_cast<int>(sizeof(float));
constexpr float SLOPE = 0.2f;

static_assert(WARPS < 32, "block_sum keeps one partial per warp in red[0..30]");
static_assert((NX + NW0) % 4 == 0 && N1 % 4 == 0 && N2 % 4 == 0,
              "float4 reads need 16-byte aligned buffers");

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

// h1[(oy*14 + ox)*64 + c] = lrelu(b0[c] + sum_taps x[iy][ix] * w0[tap][c])
__device__ void conv0_fwd(const float* xs, const float* w0s,
                          const float* __restrict__ b0, float* h1) {
  for (int i = threadIdx.x; i < N1; i += THREADS) {
    const int c = i % C1, p = i / C1, oy = p / H1, ox = p % H1;
    float acc = __ldg(b0 + c);
#pragma unroll
    for (int dy = 0; dy < 5; ++dy) {
      const int iy = 2 * oy + dy - 1;
      if (iy < 0 || iy >= H0) continue;
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) {
        const int ix = 2 * ox + dx - 1;
        if (ix < 0 || ix >= H0) continue;
        acc = fmaf(xs[iy * H0 + ix], w0s[(dy * 5 + dx) * C1 + c], acc);
      }
    }
    h1[i] = acc > 0.0f ? acc : SLOPE * acc;
  }
}

// h2[(oy*7 + ox)*128 + co] = lrelu(b1[co] + sum h1[iy][ix][ci] w1[tap][ci][co])
// One thread per (co, oy), seven ox accumulators.
__device__ void conv1_fwd(const float* h1, const float* __restrict__ w1,
                          const float* __restrict__ b1, float* h2) {
  for (int it = threadIdx.x; it < C2 * H2; it += THREADS) {
    const int co = it % C2, oy = it / C2;
    const float bias = __ldg(b1 + co);
    float acc[H2];
#pragma unroll
    for (int ox = 0; ox < H2; ++ox) acc[ox] = bias;
    for (int dy = 0; dy < 5; ++dy) {
      const int iy = 2 * oy + dy - 1;
      if (iy < 0 || iy >= H1) continue;
      const float* hrow = h1 + iy * H1 * C1;
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) {
        const float* wp = w1 + (dy * 5 + dx) * C1 * C2 + co;
        for (int ci = 0; ci < C1; ci += 4) {
          const float wa = __ldg(wp + (ci + 0) * C2);
          const float wb = __ldg(wp + (ci + 1) * C2);
          const float wc = __ldg(wp + (ci + 2) * C2);
          const float we = __ldg(wp + (ci + 3) * C2);
#pragma unroll
          for (int ox = 0; ox < H2; ++ox) {
            const int ix = 2 * ox + dx - 1;
            if (ix < 0 || ix >= H1) continue;
            const float4 h =
                *reinterpret_cast<const float4*>(hrow + ix * C1 + ci);
            acc[ox] = fmaf(h.x, wa, acc[ox]);
            acc[ox] = fmaf(h.y, wb, acc[ox]);
            acc[ox] = fmaf(h.z, wc, acc[ox]);
            acc[ox] = fmaf(h.w, we, acc[ox]);
          }
        }
      }
    }
#pragma unroll
    for (int ox = 0; ox < H2; ++ox) {
      const float v = acc[ox];
      h2[(oy * H2 + ox) * C2 + co] = v > 0.0f ? v : SLOPE * v;
    }
  }
}

// dz1 = lrelu'(h1) * (input-VJP of conv1 applied to dz2).
// One thread per (ci, iy), fourteen ix accumulators; w1t is [tap][co][ci].
__device__ void conv1_bwd(const float* dz2, const float* h1,
                          const float* __restrict__ w1t, float* dz1) {
  for (int it = threadIdx.x; it < C1 * H1; it += THREADS) {
    const int ci = it % C1, iy = it / C1;
    float acc[H1];
#pragma unroll
    for (int ix = 0; ix < H1; ++ix) acc[ix] = 0.0f;
    for (int dy = 0; dy < 5; ++dy) {
      const int t = iy + 1 - dy;
      if (t < 0 || (t & 1) || (t >> 1) >= H2) continue;
      const float* drow = dz2 + (t >> 1) * H2 * C2;
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) {
        const float* wp = w1t + (dy * 5 + dx) * C2 * C1 + ci;
        for (int co = 0; co < C2; co += 4) {
          const float wa = __ldg(wp + (co + 0) * C1);
          const float wb = __ldg(wp + (co + 1) * C1);
          const float wc = __ldg(wp + (co + 2) * C1);
          const float we = __ldg(wp + (co + 3) * C1);
#pragma unroll
          for (int ox = 0; ox < H2; ++ox) {
            const int ix = 2 * ox + dx - 1;
            if (ix < 0 || ix >= H1) continue;
            const float4 d =
                *reinterpret_cast<const float4*>(drow + ox * C2 + co);
            acc[ix] = fmaf(d.x, wa, acc[ix]);
            acc[ix] = fmaf(d.y, wb, acc[ix]);
            acc[ix] = fmaf(d.z, wc, acc[ix]);
            acc[ix] = fmaf(d.w, we, acc[ix]);
          }
        }
      }
    }
#pragma unroll
    for (int ix = 0; ix < H1; ++ix) {
      const int k = (iy * H1 + ix) * C1 + ci;
      dz1[k] = h1[k] > 0.0f ? acc[ix] : SLOPE * acc[ix];
    }
  }
}

// x -= rate * (input-VJP of conv0 applied to dz1). One warp per pixel,
// lanes over the 64 channels.
__device__ void conv0_bwd_update(const float* dz1, const float* w0s,
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
        const float* d = dz1 + ((ty >> 1) * H1 + (tx >> 1)) * C1;
        const float* w = w0s + (dy * 5 + dx) * C1;
        acc = fmaf(d[lane], w[lane], acc);
        acc = fmaf(d[lane + 32], w[lane + 32], acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) xs[p] -= rate * acc;
  }
}

__device__ float forward(const float* xs, const float* w0s,
                         const float* __restrict__ b0,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ wd, float bd, float* h1,
                         float* h2, float* red) {
  conv0_fwd(xs, w0s, b0, h1);
  __syncthreads();
  conv1_fwd(h1, w1, b1, h2);
  __syncthreads();
  float s = 0.0f;
  for (int i = threadIdx.x; i < N2; i += THREADS)
    s = fmaf(h2[i], __ldg(wd + i), s);
  return block_sum(s, red) + bd;
}

__global__ void __launch_bounds__(THREADS, 1)
    refine_kernel(const float* __restrict__ x0, float* __restrict__ x_out,
                  float* __restrict__ logits, const float* __restrict__ w0,
                  const float* __restrict__ b0, const float* __restrict__ w1,
                  const float* __restrict__ w1t,
                  const float* __restrict__ b1, const float* __restrict__ wd,
                  const float* __restrict__ bd, int steps, float rate) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* w0s = xs + NX;
  float* h1 = w0s + NW0;
  float* h2 = h1 + N1;  // h2, then dz2 in place
  float* dz1 = h2 + N2;
  float* red = dz1 + N1;

  const long long base = static_cast<long long>(blockIdx.x) * NX;
  for (int i = threadIdx.x; i < NX; i += THREADS) xs[i] = x0[base + i];
  for (int i = threadIdx.x; i < NW0; i += THREADS) w0s[i] = w0[i];
  const float bias_d = __ldg(bd);
  __syncthreads();

  for (int k = 0; k < steps; ++k) {
    const float logit = forward(xs, w0s, b0, w1, b1, wd, bias_d, h1, h2, red);
    // d softplus(-l) / dl = -sigmoid(-l)
    const float g = -1.0f / (1.0f + expf(logit));
    for (int i = threadIdx.x; i < N2; i += THREADS) {
      const float v = g * __ldg(wd + i);
      h2[i] = h2[i] > 0.0f ? v : SLOPE * v;
    }
    __syncthreads();
    conv1_bwd(h2, h1, w1t, dz1);
    __syncthreads();
    conv0_bwd_update(dz1, w0s, xs, rate);
    __syncthreads();
  }
  const float logit = forward(xs, w0s, b0, w1, b1, wd, bias_d, h1, h2, red);
  for (int i = threadIdx.x; i < NX; i += THREADS) x_out[base + i] = xs[i];
  if (threadIdx.x == 0) logits[blockIdx.x] = logit;
}

}  // namespace

extern "C" {

const char* cgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x0, x_out: (batch, 28, 28) f32. w0: [25][64], b0: [64], w1: [25][64][128],
// w1t: [25][128][64], b1: [128], wd: [7*7*128] in NHWC order, bd: [1].
int conv_refine28(const float* x0, float* x_out, float* logits,
                  const float* w0, const float* b0, const float* w1,
                  const float* w1t, const float* b1, const float* wd,
                  const float* bd, int batch, int steps, float rate,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  refine_kernel<<<batch, THREADS, SMEM_BYTES, stream>>>(
      x0, x_out, logits, w0, b0, w1, w1t, b1, wd, bd, steps, rate);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
