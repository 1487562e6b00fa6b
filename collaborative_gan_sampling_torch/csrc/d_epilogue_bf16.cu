// D's per-layer epilogue in eval mode, forward and VJP, for Hopper (sm_90a):
// BatchNorm on its running statistics, leaky ReLU (slope 0.2) and the next
// conv's SAME pad in one pass, on bf16 activations that are channels-last
// NCHW tensors (dense NHWC memory).
//
// Replaces no TPU kernel: XLA fuses this chain into its neighbours. Eager
// PyTorch runs it as a chain of elementwise kernels (the float32 upcast, the
// subtract, the multiply, the add, the bf16 cast, leaky ReLU, the pad's fill
// and copy; the VJP the mirror image), most of them broadcasting kernels
// that do not vectorize, each a pass over the activation. The autograd
// refinement of a DCGAN D runs the chain 21 times a candidate at K = 10
// (ops/d_epilogue.py).
//
// Forward, per element x of conv_i's output (bf16) in channel c:
//
//     y = round_bf16(((x - mean[c]) * mul[c]) + bias[c])   (BN, float32)
//     y = round_bf16(y > 0 ? y : y * 0.2f)                 (leaky ReLU)
//
// written into a (B, C, H + lo + hi, W + lo + hi) channels-last buffer, the
// zeros of its border included, as the next SameConv2d reads its input. The
// conv0 form (no BN) is the template flag AFFINE = false: y = leaky(x), so
// that a -0 stays -0. VJP, per element g of the padded gradient's interior
// and o of the saved output at the same place (o > 0 exactly where the
// pre-activation is, since the slope is > 0):
//
//     t  = round_bf16(o > 0 ? g : g * 0.2f)
//     dx = round_bf16(t * mul[c])                          (dx = t without BN)
//
// Every rounding point is the eager chain's: PyTorch computes each
// elementwise op in float and rounds its output to the op's dtype. Each
// float operation is a round-to-nearest intrinsic, so nvcc contracts none
// into an FMA and the kernel's bits are the chain's.
//
// Bound: HBM bytes. The forward reads 2 bytes per interior element and
// writes 2 per padded element; the VJP reads 4 and writes 2 per interior
// element. A thread owns one 16-byte chunk of 8 channels, keeps its
// channels' parameters in registers from one read, and walks pixels with a
// grid stride, two pixels an iteration with both loads issued first.
// Neighbouring threads take neighbouring chunks of a pixel, then of the
// next pixel, so each warp's accesses are whole 16-byte vectors over
// contiguous memory. No shared memory, no tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;  // resident at <= 64 registers a thread
constexpr int CHUNK = 8;          // bf16 channels in 16 bytes
constexpr float SLOPE = 0.2f;     // ops/d_epilogue.py SLOPE

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float leaky(float v) {
  return v > 0.0f ? v : __fmul_rn(v, SLOPE);
}

__device__ __forceinline__ void unpack(uint4 u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < CHUNK / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < CHUNK / 2; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// One thread's channel chunk, its parameters, and the walk over pixels.
struct Walk {
  int c;          // the chunk, < c8
  int c8;         // chunks a pixel
  unsigned p;     // the first pixel
  unsigned step;  // pixels between a thread's consecutive pixels
};

__device__ __forceinline__ Walk walk(int c8) {
  return Walk{static_cast<int>(blockIdx.y * blockDim.x + threadIdx.x), c8,
              blockIdx.x * blockDim.y + threadIdx.y, gridDim.x * blockDim.y};
}

__device__ __forceinline__ void load_params(const float* __restrict__ src,
                                            int c, float* dst) {
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) dst[i] = src[CHUNK * c + i];
}

// The input chunk of padded pixel p, or -1 on the border.
__device__ __forceinline__ int interior(unsigned p, int h, int w, int lo,
                                        int hp, int wp, const Walk& t) {
  const int xp = static_cast<int>(p % wp);
  const unsigned r = p / wp;
  const int yp = static_cast<int>(r % hp), n = static_cast<int>(r / hp);
  const int y = yp - lo, x = xp - lo;
  if (y < 0 || y >= h || x < 0 || x >= w) return -1;
  return ((n * h + y) * w + x) * t.c8 + t.c;
}

template <bool AFFINE>
__device__ __forceinline__ uint4 forward_chunk(uint4 v, const float* m,
                                               const float* s,
                                               const float* b) {
  float f[CHUNK];
  unpack(v, f);
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    float y = f[i];
    if (AFFINE)
      y = round_bf16(__fadd_rn(__fmul_rn(__fsub_rn(y, m[i]), s[i]), b[i]));
    f[i] = leaky(y);
  }
  return pack(f);
}

template <bool AFFINE>
__device__ __forceinline__ void forward(const uint4* __restrict__ x,
                                        const float* __restrict__ mean,
                                        const float* __restrict__ mul,
                                        const float* __restrict__ bias,
                                        uint4* __restrict__ out, int c8,
                                        int h, int w, int lo, int hi,
                                        unsigned pixels) {
  const Walk t = walk(c8);
  if (t.c >= c8) return;
  float m[CHUNK], s[CHUNK], b[CHUNK];
  if (AFFINE) {
    load_params(mean, t.c, m);
    load_params(mul, t.c, s);
    load_params(bias, t.c, b);
  }
  const int hp = h + lo + hi, wp = w + lo + hi;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (unsigned p = t.p; p < pixels; p += 2 * t.step) {
    const unsigned q = p + t.step;
    const bool has_q = q < pixels;
    const int ip = interior(p, h, w, lo, hp, wp, t);
    const int iq = has_q ? interior(q, h, w, lo, hp, wp, t) : -1;
    const uint4 vp = ip >= 0 ? __ldg(x + ip) : zero;
    const uint4 vq = iq >= 0 ? __ldg(x + iq) : zero;
    out[p * c8 + t.c] = ip >= 0 ? forward_chunk<AFFINE>(vp, m, s, b) : zero;
    if (has_q)
      out[q * c8 + t.c] = iq >= 0 ? forward_chunk<AFFINE>(vq, m, s, b) : zero;
  }
}

template <bool AFFINE>
__device__ __forceinline__ uint4 backward_chunk(uint4 gv, uint4 ov,
                                                const float* s) {
  float g[CHUNK], o[CHUNK];
  unpack(gv, g);
  unpack(ov, o);
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    float d = o[i] > 0.0f ? g[i] : __fmul_rn(g[i], SLOPE);
    if (AFFINE) d = __fmul_rn(round_bf16(d), s[i]);
    g[i] = d;
  }
  return pack(g);
}

// The padded chunk of interior pixel p.
__device__ __forceinline__ int padded(unsigned p, int h, int w, int lo,
                                      int hp, int wp, const Walk& t) {
  const int x = static_cast<int>(p % w);
  const unsigned r = p / w;
  const int y = static_cast<int>(r % h), n = static_cast<int>(r / h);
  return ((n * hp + y + lo) * wp + x + lo) * t.c8 + t.c;
}

template <bool AFFINE>
__device__ __forceinline__ void backward(const uint4* __restrict__ grad,
                                         const uint4* __restrict__ out,
                                         const float* __restrict__ mul,
                                         uint4* __restrict__ dx, int c8,
                                         int h, int w, int lo, int hi,
                                         unsigned pixels) {
  const Walk t = walk(c8);
  if (t.c >= c8) return;
  float s[CHUNK];
  if (AFFINE) load_params(mul, t.c, s);
  const int hp = h + lo + hi, wp = w + lo + hi;
  for (unsigned p = t.p; p < pixels; p += 2 * t.step) {
    const unsigned q = p + t.step;
    const bool has_q = q < pixels;
    const int ip = padded(p, h, w, lo, hp, wp, t);
    const int iq = has_q ? padded(q, h, w, lo, hp, wp, t) : ip;
    const uint4 gp = __ldg(grad + ip), op = __ldg(out + ip);
    const uint4 gq = __ldg(grad + iq), oq = __ldg(out + iq);
    dx[p * c8 + t.c] = backward_chunk<AFFINE>(gp, op, s);
    if (has_q) dx[q * c8 + t.c] = backward_chunk<AFFINE>(gq, oq, s);
  }
}

// Four entry points with plain names (the benchmark's trace finds a kernel
// by its name): the BN and the conv0 form, forward and VJP.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    d_epilogue_bn_fwd(const uint4* x, const float* mean, const float* mul,
                      const float* bias, uint4* out, int c8, int h, int w,
                      int lo, int hi, unsigned pixels) {
  forward<true>(x, mean, mul, bias, out, c8, h, w, lo, hi, pixels);
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    d_epilogue_lrelu_fwd(const uint4* x, uint4* out, int c8, int h, int w,
                         int lo, int hi, unsigned pixels) {
  forward<false>(x, nullptr, nullptr, nullptr, out, c8, h, w, lo, hi,
                 pixels);
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    d_epilogue_bn_bwd(const uint4* grad, const uint4* out, const float* mul,
                      uint4* dx, int c8, int h, int w, int lo, int hi,
                      unsigned pixels) {
  backward<true>(grad, out, mul, dx, c8, h, w, lo, hi, pixels);
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    d_epilogue_lrelu_bwd(const uint4* grad, const uint4* out, uint4* dx,
                         int c8, int h, int w, int lo, int hi,
                         unsigned pixels) {
  backward<false>(grad, out, nullptr, dx, c8, h, w, lo, hi, pixels);
}

// Threads: x = chunks of a pixel (up to THREADS), y = pixels; grid: y over
// the chunks beyond THREADS, x enough blocks for BLOCKS_PER_SM an SM, each
// thread taking at least two pixels.
struct Launch {
  dim3 grid, block;
  cudaError_t err;
};

Launch plan(int c8, unsigned pixels) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tx = c8 < THREADS ? c8 : THREADS, ty = THREADS / tx;
  const int gy = (c8 + tx - 1) / tx;
  const unsigned need = (pixels + 2u * ty - 1) / (2u * ty);
  unsigned gx = static_cast<unsigned>(sms * BLOCKS_PER_SM / gy);
  if (gx < 1) gx = 1;
  if (gx > need) gx = need;
  return Launch{dim3(gx, gy), dim3(tx, ty), err};
}

// The shapes both entries check: C a multiple of CHUNK, pads >= 0, and every
// chunk index of the padded tensor within 31 bits.
bool valid(int batch, int channels, int h, int w, int lo, int hi) {
  if (batch < 0 || channels <= 0 || channels % CHUNK != 0 || h < 0 ||
      w < 0 || lo < 0 || hi < 0)
    return false;
  const long long chunks = static_cast<long long>(batch) * (h + lo + hi) *
                           (w + lo + hi) * (channels / CHUNK);
  return chunks < (1ll << 31);
}

}  // namespace

extern "C" {

const char* cgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (batch, channels, h, w) bf16, channels-last, 16-byte aligned; mean,
// mul, bias: (channels,) float32, all three or none (nullptr: the conv0
// form); out: (batch, channels, h + lo + hi, w + lo + hi) bf16,
// channels-last, 16-byte aligned, written whole.
int d_epilogue_bf16(const void* x, const float* mean, const float* mul,
                    const float* bias, void* out, int batch, int channels,
                    int h, int w, int lo, int hi, cudaStream_t stream) {
  const bool affine = mul != nullptr;
  if (!valid(batch, channels, h, w, lo, hi) || (mean != nullptr) != affine ||
      (bias != nullptr) != affine)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c8 = channels / CHUNK;
  const unsigned pixels =
      static_cast<unsigned>(batch) * (h + lo + hi) * (w + lo + hi);
  if (pixels == 0) return 0;
  const Launch l = plan(c8, pixels);
  if (l.err != cudaSuccess) return static_cast<int>(l.err);
  const uint4* xv = static_cast<const uint4*>(x);
  uint4* ov = static_cast<uint4*>(out);
  if (affine)
    d_epilogue_bn_fwd<<<l.grid, l.block, 0, stream>>>(
        xv, mean, mul, bias, ov, c8, h, w, lo, hi, pixels);
  else
    d_epilogue_lrelu_fwd<<<l.grid, l.block, 0, stream>>>(xv, ov, c8, h, w,
                                                         lo, hi, pixels);
  return static_cast<int>(cudaGetLastError());
}

// grad, out: (batch, channels, h + lo + hi, w + lo + hi) bf16, the padded
// output's gradient and the forward's output; mul: (channels,) float32 or
// nullptr (the conv0 form); dx: (batch, channels, h, w) bf16. All
// channels-last, the bf16 tensors 16-byte aligned.
int d_epilogue_bf16_backward(const void* grad, const void* out,
                             const float* mul, void* dx, int batch,
                             int channels, int h, int w, int lo, int hi,
                             cudaStream_t stream) {
  if (!valid(batch, channels, h, w, lo, hi))
    return static_cast<int>(cudaErrorInvalidValue);
  const int c8 = channels / CHUNK;
  const unsigned pixels = static_cast<unsigned>(batch) * h * w;
  if (pixels == 0) return 0;
  const Launch l = plan(c8, pixels);
  if (l.err != cudaSuccess) return static_cast<int>(l.err);
  const uint4* gv = static_cast<const uint4*>(grad);
  const uint4* ov = static_cast<const uint4*>(out);
  uint4* dv = static_cast<uint4*>(dx);
  if (mul != nullptr)
    d_epilogue_bn_bwd<<<l.grid, l.block, 0, stream>>>(gv, ov, mul, dv, c8, h,
                                                      w, lo, hi, pixels);
  else
    d_epilogue_lrelu_bwd<<<l.grid, l.block, 0, stream>>>(gv, ov, dv, c8, h,
                                                         w, lo, hi, pixels);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
