// Fused K-step refinement under an MLP discriminator, for Hopper (sm_90a).
//
// Replaces the TPU kernel collaborative_gan_sampling_tpu/ops/refine_pallas.py
// (fused_refine_mlp, body _refine_kernel). It computes what
// ops/refine_mlp.py::refine_mlp_plain computes, for a D of L relu layers of
// width h over d inputs and a one-unit linear head:
//
//   K times:  logit = head(relu(... relu(x W0 + b0) ...))
//             da    = -sigmoid(-logit) * Wout^T
//             da    = (da * [a_i > 0]) W_i^T      for i = L-1 .. 0
//             x    <- x - rate * da
//   then:     logit = D(x)
//
// Design: one block per tile of T = 4 samples runs the whole K loop. The
// packed weights (ops/refine_mlp.py::pack_mlp_params; 135 KB at the toy2d
// widths, d = 2, h = 128, L = 3) are copied into dynamic shared memory once
// per block; x as (d, T) and the post-relu activations as (L, h, T) stay there
// too, so nothing goes to device memory between steps. The backward pass
// overwrites each activation with its own gradient in place. In a dense
// layer a thread owns one unit and the tile's 4 samples: each weight it
// loads from shared memory serves 4 multiply-adds, and the 4 activations
// arrive as one float4 broadcast. The input-VJP reads a weight row per
// thread; rows are padded to h + 1 floats, so a warp's 32 rows fall in 32
// banks. The TPU's 128-lane padding, padded head and tile of 512 are not
// carried over. The rate is a runtime argument.
//
// Bound: operations. (2K + 1) D forwards of 2 (d h + (L-1) h^2 + h) FLOP per
// sample (66,304 at toy2d widths), all f32 on the CUDA cores; the bytes
// (x in and out, 134 KB of weights read once) are negligible. The weights
// are re-read from L2 by every block, which is what the tile trades against
// the number of blocks in flight.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// Samples per block. At the main path's B = 256, 4 spreads the batch over
// 64 SMs and is the fastest tile measured (PERF.md); larger tiles win only
// at batches no path sends yet. A thread's samples are one float4.
constexpr int T = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// acc += a * w, lane by lane.
__device__ __forceinline__ void fma4(float4& acc, float4 a, float w) {
  acc.x = fmaf(a.x, w, acc.x);
  acc.y = fmaf(a.y, w, acc.y);
  acc.z = fmaf(a.z, w, acc.z);
  acc.w = fmaf(a.w, w, acc.w);
}

// out[j][t] = relu(b[j] + sum_k in[k][t] * W[k][j]) for j < h, t < T.
// in: (n_in, T), W: rows of stride ldw, out: (h, T).
__device__ void dense_relu(const float* in, int n_in, const float* W, int ldw,
                           const float* b, int h, float* out) {
  for (int j = threadIdx.x; j < h; j += THREADS) {
    float4 acc = make_float4(b[j], b[j], b[j], b[j]);
    for (int k = 0; k < n_in; ++k)
      fma4(acc, reinterpret_cast<const float4*>(in)[k], W[k * ldw + j]);
    reinterpret_cast<float4*>(out)[j] =
        make_float4(fmaxf(acc.x, 0.0f), fmaxf(acc.y, 0.0f),
                    fmaxf(acc.z, 0.0f), fmaxf(acc.w, 0.0f));
  }
}

// prev[k][t] <- [prev[k][t] > 0] * sum_j dz[j][t] * W[k][j]: the input-VJP
// of a hidden layer, masked by relu' of the layer below, in place.
__device__ void dense_bwd(const float* dz, const float* W, int ldw, int h,
                          float* prev) {
  for (int k = threadIdx.x; k < h; k += THREADS) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float* wp = W + k * ldw;
    for (int j = 0; j < h; ++j)
      fma4(acc, reinterpret_cast<const float4*>(dz)[j], wp[j]);
    float4& p = reinterpret_cast<float4*>(prev)[k];
    p = make_float4(p.x > 0.0f ? acc.x : 0.0f, p.y > 0.0f ? acc.y : 0.0f,
                    p.z > 0.0f ? acc.z : 0.0f, p.w > 0.0f ? acc.w : 0.0f);
  }
}

// D(x) for the tile: every layer into acts, the logits into lg.
__device__ void forward(const float* xs, const float* w0, const float* b0,
                        const float* hid, const float* wout, float bout,
                        int d, int h, int L, float* acts, float* lg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ldw = h + 1, per_layer = h * ldw + h;
  dense_relu(xs, d, w0, h, b0, h, acts);
  __syncthreads();
  for (int l = 1; l < L; ++l) {
    const float* W = hid + (l - 1) * per_layer;
    dense_relu(acts + (l - 1) * h * T, h, W, ldw, W + h * ldw, h,
               acts + l * h * T);
    __syncthreads();
  }
  const float* top = acts + (L - 1) * h * T;
  for (int t = warp; t < T; t += WARPS) {
    float s = 0.0f;
    for (int j = lane; j < h; j += 32) s = fmaf(top[j * T + t], wout[j], s);
    s = warp_sum(s);
    if (lane == 0) lg[t] = s + bout;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
    refine_kernel(const float* __restrict__ x0, float* __restrict__ x_out,
                  float* __restrict__ logits,
                  const float* __restrict__ params, int n_params, int batch,
                  int d, int h, int L, int steps, float rate) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ldw = h + 1, per_layer = h * ldw + h;
  const float* w0 = smem;  // (d, h)
  const float* b0 = w0 + d * h;
  const float* hid = b0 + h;  // layer l >= 1: W (h, ldw), then b (h)
  const float* wout = hid + (L - 1) * per_layer;
  float* xs = smem + n_params;  // (d, T)
  float* acts = xs + round4(d * T);  // (L, h, T)
  float* lg = acts + L * h * T;  // (T)

  // n_params is a multiple of 4 and both buffers are 16-byte aligned.
  for (int i = threadIdx.x; i < n_params / 4; i += THREADS)
    reinterpret_cast<float4*>(smem)[i] =
        reinterpret_cast<const float4*>(params)[i];
  const long long base = static_cast<long long>(blockIdx.x) * T;
  const int valid = min(T, batch - static_cast<int>(base));
  for (int i = threadIdx.x; i < d * T; i += THREADS) {
    const int c = i / T, t = i % T;
    xs[i] = t < valid ? x0[(base + t) * d + c] : 0.0f;
  }
  __syncthreads();
  const float bout = wout[h];

  for (int k = 0; k < steps; ++k) {
    forward(xs, w0, b0, hid, wout, bout, d, h, L, acts, lg);
    // Top layer: dz = [a > 0] * dlogit * wout, with d softplus(-l) / dl
    // = -sigmoid(-l).
    float* top = acts + (L - 1) * h * T;
    for (int i = threadIdx.x; i < h * T; i += THREADS) {
      const int j = i / T, t = i % T;
      const float g = -1.0f / (1.0f + expf(lg[t]));
      top[i] = top[i] > 0.0f ? g * wout[j] : 0.0f;
    }
    __syncthreads();
    for (int l = L - 1; l >= 1; --l) {
      dense_bwd(acts + l * h * T, hid + (l - 1) * per_layer, ldw, h,
                acts + (l - 1) * h * T);
      __syncthreads();
    }
    // x -= rate * dz0 W0^T: one warp per (input, sample), lanes over units.
    for (int item = warp; item < d * T; item += WARPS) {
      const int c = item / T, t = item % T;
      float s = 0.0f;
      for (int j = lane; j < h; j += 32)
        s = fmaf(acts[j * T + t], w0[c * h + j], s);
      s = warp_sum(s);
      if (lane == 0) xs[item] -= rate * s;
    }
    __syncthreads();
  }
  forward(xs, w0, b0, hid, wout, bout, d, h, L, acts, lg);
  for (int i = threadIdx.x; i < d * T; i += THREADS) {
    const int c = i / T, t = i % T;
    if (t < valid) x_out[(base + t) * d + c] = xs[i];
  }
  if (threadIdx.x < valid) logits[base + threadIdx.x] = lg[threadIdx.x];
}

}  // namespace

extern "C" {

const char* cgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x0, x_out: (batch, d) f32; logits: (batch). params: the packed weights
// (n_params floats, a multiple of 4). smem: the block's dynamic shared
// memory in bytes, as the wrapper computes it (ops/refine_mlp.py::smem_bytes).
int refine_mlp(const float* x0, float* x_out, float* logits,
               const float* params, int n_params, int batch, int d, int h,
               int L, int steps, float rate, int smem, cudaStream_t stream) {
  if (n_params % 4 != 0 || L < 1 || d < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int need = 4 * (n_params + round4(d * T) + L * h * T + T);
  if (smem != need) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (batch + T - 1) / T;
  refine_kernel<<<blocks, THREADS, smem, stream>>>(
      x0, x_out, logits, params, n_params, batch, d, h, L, steps, rate);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
