// Fused K-step refinement under an MLP discriminator, for Hopper (sm_90a).
//
// Replaces the TPU kernel collaborative_gan_sampling_tpu/ops/refine_pallas.py
// (fused_refine_mlp, body _refine_kernel). It computes what
// ops/refine_mlp.py::refine_mlp_plain computes, for a D of L relu layers of
// width h over d inputs and a one-unit linear head, in float32 on the CUDA
// cores (no TF32):
//
//   K times:  logit = head(relu(... relu(x W0^T + b0) ...))
//             da    = -sigmoid(-logit) * wout
//             da    = (da * [a_i > 0]) W_i        for i = L-1 .. 0
//             x    <- x - rate * da
//   then:     logit = D(x)
//
// Bound: operations. (2K + 1) D passes of 2 (d h + (L-1) h^2 + h) FLOP per
// sample (66,304 at toy2d widths, d = 2, h = 128, L = 3); the bytes (x in and
// out, 134 KB of weights) are negligible.
//
// Design.
// * D's weights are read where they lie: the nn.Linear (out, in) matrices
//   and the biases of the module, one pointer each, in stream order at each
//   launch. Nothing is packed on the host or on the card.
// * A block stages them into shared memory once, by bulk async copies
//   (csrc/hopper_async.cuh) that all its threads issue, one mbarrier per
//   layer, so layer 0 (1 KB) computes while the hidden matrices are still
//   arriving. Hidden rows keep a
//   pitch of P = h + 4 floats: a quarter-warp reading a float4 along k from
//   8 consecutive rows (the input-VJP), or 8 consecutive float4s of one row
//   (the forward), touches all 32 banks once.
// * Blocks are persistent: grid = min(tiles, blocks the card holds), and a
//   block walks over tiles of T samples (T = 2 while the batch's tiles fit
//   in one wave of blocks, else 8: ops/refine_mlp.py::launch_plan). The K
//   loop of a tile runs in shared memory; activations are kept unit-major,
//   (h, T), and the backward pass overwrites each with its own gradient in
//   place.
// * A dense layer is a register tile per thread. Forward: 2 units x T
//   samples, the k-sum split over 4 lanes (lane bits 3-4) in 16-float
//   strides; a float4 of weights feeds 4 T multiply-adds. Input-VJP: 4 input
//   units (a float4 of row j) x T samples, the j-sum split over 8 lanes (lane
//   bits 0-2); each row's float4 feeds 4 T multiply-adds. The split sums meet
//   by a shuffle reduce-scatter: every lane ends holding whole sums, which
//   it writes. Head and top gradient are one warp per sample, the x update
//   one warp per (input, sample).
//
// Built with -DCGS_PHASE_CLOCKS, thread 0 of each block counts clock64()
// cycles per phase (hopper_async.cuh): 0 layer 0's forward, 1 the hidden
// forwards, 2 head and top gradient, 3 the hidden input-VJPs, 4 the x
// update, 5 the weights' copies issued and a tile's x in and out, 6
// waiting for the weights to land.

#include <cuda_runtime.h>

#include "hopper_async.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LAYERS = 64;  // relu layers; the head is one more
constexpr int MAX_DEVICES = 16;

struct Layers {
  const float* w[MAX_LAYERS + 1];  // (out, in), row-major; the head last
  const float* b[MAX_LAYERS + 1];
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Offsets, in floats, of the block's dynamic shared memory: W0 (h, d), b0,
// per hidden layer l = 1 .. L-1 its rows at pitch P then its bias, the head's
// weights, the activations (L, h, T), x (T, d), the logits (T), then one
// mbarrier per layer and one for the head. Every offset is a multiple of 4
// floats (h is). ops/refine_mlp.py::smem_bytes mirrors bytes().
struct Plan {
  int d, h, L, T, P;
  __host__ __device__ int b0() const { return h * d; }
  __host__ __device__ int hid(int l) const {
    return h * d + h + (l - 1) * (h * P + h);
  }
  __host__ __device__ int wout() const { return hid(L); }
  __host__ __device__ int acts() const { return wout() + h; }
  __host__ __device__ int xs() const { return acts() + L * h * T; }
  __host__ __device__ int lg() const { return xs() + round4(T * d); }
  __host__ __device__ int bars() const { return lg() + round4(T); }
  __host__ __device__ int bytes() const { return 4 * bars() + 8 * (L + 1); }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One step of a shuffle reduce-scatter over N values: the lane whose `bit`
// is clear keeps the first half, summed with its partner's (lane ^ mask);
// the other lane keeps the second half. out[i] = own + partner's.
template <int N>
__device__ __forceinline__ void scatter_step(const float* v, float* out,
                                             bool bit, int mask) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float keep = bit ? v[N / 2 + i] : v[i];
    const float send = bit ? v[i] : v[N / 2 + i];
    out[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// T floats from shared memory (16-byte aligned where T >= 4).
template <int T>
__device__ __forceinline__ void load_t(const float* p, float* v) {
  if constexpr (T == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x, v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < T / 4; ++i) {
      const float4 a = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = a.x, v[4 * i + 1] = a.y, v[4 * i + 2] = a.z,
      v[4 * i + 3] = a.w;
    }
  }
}

// out[j][t] = relu(b[j] + sum_k W[j][k] in[k][t]) for a hidden layer.
// in, out: (h, T). Thread: units j = jb + ug and jb + ug + 64, ug = (lane &
// 7) + 8 warp; its k are 4 kq .. 4 kq + 3 (mod 16), kq = lane >> 3.
template <int T>
__device__ __forceinline__ void dense_fwd(const float* __restrict__ in,
                                          const float* __restrict__ W, int P,
                                          const float* __restrict__ bias,
                                          int h, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, kq = lane >> 3;
  const int ug = (lane & 7) + 8 * (threadIdx.x >> 5);
  for (int jb = 0; jb < h; jb += 128) {
    const int j0 = jb + ug, j1 = j0 + 64;
    const float* w0 = W + (j0 < h ? j0 : 0) * P;
    const float* w1 = W + (j1 < h ? j1 : 0) * P;
    float acc[2 * T];
#pragma unroll
    for (int i = 0; i < 2 * T; ++i) acc[i] = 0.0f;
#pragma unroll 2
    for (int k0 = 4 * kq; k0 < h; k0 += 16) {
      const float4 wa = *reinterpret_cast<const float4*>(w0 + k0);
      const float4 wb = *reinterpret_cast<const float4*>(w1 + k0);
      float a[4 * T];  // a[r T + t] = in[k0 + r][t]
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const float4 v = reinterpret_cast<const float4*>(in + k0 * T)[i];
        a[4 * i] = v.x, a[4 * i + 1] = v.y, a[4 * i + 2] = v.z,
        a[4 * i + 3] = v.w;
      }
      const float ra[4] = {wa.x, wa.y, wa.z, wa.w};
      const float rb[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int t = 0; t < T; ++t) {
          acc[t] = fmaf(ra[r], a[r * T + t], acc[t]);
          acc[T + t] = fmaf(rb[r], a[r * T + t], acc[T + t]);
        }
      }
    }
    // The four kq lanes' partial sums: lane bit 4 picks the unit, bit 3
    // the half of the samples.
    float s1[T], s0[T / 2];
    scatter_step<2 * T>(acc, s1, kq & 2, 16);
    scatter_step<T>(s1, s0, kq & 1, 8);
    const int j = (kq & 2) ? j1 : j0;
    if (j < h) {
      const int t0 = (kq & 1) * (T / 2);
#pragma unroll
      for (int i = 0; i < T / 2; ++i)
        out[j * T + t0 + i] = fmaxf(s0[i] + bias[j], 0.0f);
    }
  }
}

// prev[k][t] <- [prev[k][t] > 0] * sum_j dz[j][t] W[j][k]: the input-VJP of
// a hidden layer, masked by relu' of the layer below, in place. Thread:
// inputs k = 4 kg .. 4 kg + 3, kg = kb + (threadIdx.x >> 3); rows j = js
// mod 8, js = lane & 7. A warp's four groups run each round together (the
// shuffles span the warp); a group past h / 4 reads group 0's rows and
// drops its sums.
template <int T>
__device__ __forceinline__ void dense_bwd(const float* __restrict__ dz,
                                          const float* __restrict__ W, int P,
                                          int h, float* __restrict__ prev) {
  const int lane = threadIdx.x & 31, js = lane & 7;
  for (int kb = 0; kb + 4 * (threadIdx.x >> 5) < h / 4; kb += THREADS / 8) {
    const int kg = kb + (threadIdx.x >> 3);
    const bool live = kg < h / 4;
    const int k0 = live ? 4 * kg : 0;
    float acc[4 * T];  // acc[r T + t] for input k0 + r
#pragma unroll
    for (int i = 0; i < 4 * T; ++i) acc[i] = 0.0f;
#pragma unroll 4
    for (int j = js; j < h; j += 8) {
      const float4 w = *reinterpret_cast<const float4*>(W + j * P + k0);
      const float rw[4] = {w.x, w.y, w.z, w.w};
      float g[T];
      load_t<T>(dz + j * T, g);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int t = 0; t < T; ++t)
          acc[r * T + t] = fmaf(rw[r], g[t], acc[r * T + t]);
      }
    }
    // Lane bits 2, 1 pick the input (2 bits of r), bit 0 the half of the
    // samples.
    float s2[2 * T], s1[T], s0[T / 2];
    scatter_step<4 * T>(acc, s2, js & 4, 4);
    scatter_step<2 * T>(s2, s1, js & 2, 2);
    scatter_step<T>(s1, s0, js & 1, 1);
    const int k = k0 + ((js >> 2) & 1) * 2 + ((js >> 1) & 1);
    const int t0 = (js & 1) * (T / 2);
    if (live) {
#pragma unroll
      for (int i = 0; i < T / 2; ++i) {
        float& p = prev[k * T + t0 + i];
        p = p > 0.0f ? s0[i] : 0.0f;
      }
    }
  }
}

// D(x) for the tile: every layer's activations into acts, the logits into
// lg. With `top`, each head warp then turns its sample's top activations
// into dz = [a > 0] * dlogit * wout, dlogit = d softplus(-l) / dl =
// -sigmoid(-l). `wait`: the first pass of the block, which waits for each
// layer's weights to land.
template <int T>
__device__ void forward(const Plan& p, float* smem, float* acts,
                        const float* xs, float* lg, float bout, uint32_t bars,
                        bool wait, bool top) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = p.d, h = p.h;
  const float* w0 = smem;
  const float* b0 = smem + p.b0();
  const bool rec = threadIdx.x == 0;
  (void)rec;
  if (wait) cgs::mbar_wait(bars, 0);
  CGS_PHASE(rec, 0, 6);
  for (int i = threadIdx.x; i < h * T; i += THREADS) {
    const int j = i / T, t = i % T;
    float s = 0.0f;
    for (int c = 0; c < d; ++c) s = fmaf(w0[j * d + c], xs[t * d + c], s);
    acts[i] = fmaxf(s + b0[j], 0.0f);
  }
  __syncthreads();
  CGS_PHASE(rec, 0, 0);
  for (int l = 1; l < p.L; ++l) {
    if (wait) cgs::mbar_wait(bars + 8 * l, 0);
    CGS_PHASE(rec, 0, 6);
    const float* W = smem + p.hid(l);
    dense_fwd<T>(acts + (l - 1) * h * T, W, p.P, W + h * p.P, h,
                 acts + l * h * T);
    __syncthreads();
    CGS_PHASE(rec, 0, 1);
  }
  if (wait) cgs::mbar_wait(bars + 8 * p.L, 0);
  CGS_PHASE(rec, 0, 6);
  const float* wout = smem + p.wout();
  float* a = acts + (p.L - 1) * h * T;
  for (int t = warp; t < T; t += WARPS) {
    float s = 0.0f;
    for (int j = lane; j < h; j += 32) s = fmaf(a[j * T + t], wout[j], s);
    const float logit = warp_sum(s) + bout;
    if (lane == 0) lg[t] = logit;
    if (top) {
      const float g = -1.0f / (1.0f + expf(logit));
      for (int j = lane; j < h; j += 32) {
        float& v = a[j * T + t];
        v = v > 0.0f ? g * wout[j] : 0.0f;
      }
    }
  }
  __syncthreads();
  CGS_PHASE(rec, 0, 2);
}

// x -= rate * dz0 W0 for the tile, dz0 (h, T) in acts.
template <int T>
__device__ void x_update(const Plan& p, float* smem, const float* acts,
                         float* xs, float rate) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = p.d, h = p.h;
  const float* w0 = smem;
  // One warp per (input, sample), lanes over units.
  for (int item = warp; item < d * T; item += WARPS) {
    const int c = item / T, t = item % T;
    float s = 0.0f;
    for (int j = lane; j < h; j += 32)
      s = fmaf(acts[j * T + t], w0[j * d + c], s);
    s = warp_sum(s);
    if (lane == 0) xs[t * d + c] -= rate * s;
  }
}

// The bytes each layer's mbarrier expects: W0 and b0; a hidden layer's
// rows and bias; the head's weights.
__device__ __forceinline__ uint32_t layer_bytes(const Plan& p, int l) {
  return l == 0 ? 4 * (p.h * p.d + p.h) : l < p.L ? 4 * (p.h * p.h + p.h)
                                                  : 4 * p.h;
}

// Every thread issues some of the block's bulk copies, one per hidden row
// or per array, each completing on its layer's mbarrier (whose bytes
// thread 0 announced before the block's barrier).
__device__ void stage_weights(const Layers& ly, const Plan& p, float* smem,
                              uint32_t bars) {
  const int h = p.h, per = h + 1;
  const int items = 2 + (p.L - 1) * per + 1;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    if (it == 0) {
      cgs::bulk_copy(cgs::smem_u32(smem), ly.w[0], 4 * h * p.d, bars);
    } else if (it == 1) {
      cgs::bulk_copy(cgs::smem_u32(smem + p.b0()), ly.b[0], 4 * h, bars);
    } else if (it == items - 1) {
      cgs::bulk_copy(cgs::smem_u32(smem + p.wout()), ly.w[p.L], 4 * h,
                     bars + 8 * p.L);
    } else {
      const int l = 1 + (it - 2) / per, j = (it - 2) % per;
      float* W = smem + p.hid(l);
      cgs::bulk_copy(cgs::smem_u32(W + j * p.P),
                     j < h ? ly.w[l] + j * h : ly.b[l], 4 * h,
                     bars + 8 * l);
    }
  }
}

template <int T>
__global__ void __launch_bounds__(THREADS, 1)
    refine_kernel(const float* __restrict__ x0, float* __restrict__ x_out,
                  float* __restrict__ logits, const Layers ly, int batch,
                  int d, int h, int L, int steps, float rate) {
  extern __shared__ __align__(16) float smem[];
  const Plan p{d, h, L, T, h + 4};
  const bool rec = threadIdx.x == 0;
  (void)rec;
  const uint32_t bars = cgs::smem_u32(smem + p.bars());
  CGS_PHASE_BEGIN(rec, 0);
  if (threadIdx.x == 0) {
    for (int l = 0; l <= L; ++l) cgs::mbar_init(bars + 8 * l, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int l = 0; l <= L; ++l)
      cgs::mbar_expect_tx(bars + 8 * l, layer_bytes(p, l));
  }
  __syncthreads();
  stage_weights(ly, p, smem, bars);
  const float bout = ly.b[L][0];
  float* acts = smem + p.acts();
  float* xs = smem + p.xs();
  float* lg = smem + p.lg();

  // grid <= tiles: every block has a tile, so it waits for its copies.
  bool first = true;
  const int tiles = (batch + T - 1) / T;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = static_cast<long long>(tile) * T;
    const int valid = min(T, batch - static_cast<int>(base));
    for (int i = threadIdx.x; i < T * d; i += THREADS) {
      const int t = i / d;
      xs[i] = t < valid ? x0[base * d + i] : 0.0f;
    }
    __syncthreads();
    CGS_PHASE(rec, 0, 5);
    for (int k = 0; k < steps; ++k) {
      forward<T>(p, smem, acts, xs, lg, bout, bars, first, true);
      first = false;
      for (int l = L - 1; l >= 1; --l) {
        dense_bwd<T>(acts + l * h * T, smem + p.hid(l), p.P, h,
                     acts + (l - 1) * h * T);
        __syncthreads();
      }
      CGS_PHASE(rec, 0, 3);
      x_update<T>(p, smem, acts, xs, rate);
      __syncthreads();
      CGS_PHASE(rec, 0, 4);
    }
    forward<T>(p, smem, acts, xs, lg, bout, bars, first, false);
    first = false;
    for (int i = threadIdx.x; i < valid * d; i += THREADS)
      x_out[base * d + i] = xs[i];
    if (threadIdx.x < valid) logits[base + threadIdx.x] = lg[threadIdx.x];
    __syncthreads();
    CGS_PHASE(rec, 0, 5);
  }
  CGS_PHASE_END(rec, 0);
}

// Opts kernel T into `smem` bytes of dynamic shared memory on the current
// device, once per larger size.
template <int T>
int launch(const float* x0, float* x_out, float* logits, const Layers& ly,
           int batch, int d, int h, int L, int steps, float rate, int grid,
           int smem, cudaStream_t stream) {
  static int opted[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > opted[dev]) {
    err = cudaFuncSetAttribute(refine_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = smem;
  }
  refine_kernel<T><<<grid, THREADS, smem, stream>>>(
      x0, x_out, logits, ly, batch, d, h, L, steps, rate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x0, x_out: (batch, d) f32; logits: (batch). w, b: host arrays of L + 1
// device pointers, each layer's (out, in) weight and bias as the module
// holds them, the head last; every weight and every bias but the head's
// 16-byte aligned. tile, grid, smem: ops/refine_mlp.py::launch_plan.
int refine_mlp(const float* x0, float* x_out, float* logits,
               const float* const* w, const float* const* b, int batch, int d,
               int h, int L, int steps, float rate, int tile, int grid,
               int smem, cudaStream_t stream) {
  if (L < 1 || L > MAX_LAYERS || d < 1 || h < 4 || h % 4 != 0 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{d, h, L, tile, h + 4};
  if (smem != p.bytes()) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  if (grid > (batch + tile - 1) / tile)
    return static_cast<int>(cudaErrorInvalidValue);
  Layers ly;
  for (int l = 0; l <= L; ++l) ly.w[l] = w[l], ly.b[l] = b[l];
  switch (tile) {
    case 2:
      return launch<2>(x0, x_out, logits, ly, batch, d, h, L, steps, rate,
                       grid, smem, stream);
    case 8:
      return launch<8>(x0, x_out, logits, ly, batch, d, h, L, steps, rate,
                       grid, smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
