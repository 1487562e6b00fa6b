// DRS accept step for Hopper (sm_90a).
//
// Replaces the TPU kernel collaborative_gan_sampling_tpu/ops/accept_pallas.py
// (drs_accept_mask_pallas -> _accept_kernel_hw -> _accept_math, and the
// parity entry drs_accept_mask_pallas_from_uniform -> _accept_kernel_from_u).
// Per logit F, with the burn-in max M and gamma_total:
//
//     f     = min(F - M, -eps)
//     F_hat = f - log(1 - exp(f - eps)) - gamma_total
//     accept = u < sigmoid(F_hat)
//
// u comes either from Philox4x32-10 written into the kernel (key = the 64-bit
// seed the wrapper draws from its torch.Generator, counter = element index,
// u = (first word >> 8) * 2^-24, as the TPU kernel converted its bits), or
// from a caller's tensor. M, the seed and any tensor gamma are read from
// device scalars, so the caller never waits for the device.
//
// Two routes, by batch (ops/accept.py dispatches):
//
// * drs_step, n <= STEP_CAP: the whole DRS step in one block. With a
//   percentile q > 0 it also forms gamma_total = gamma + the q-quantile of
//   the batch's shift F - M - log(-expm1(F - M - eps)) (f clamped as above),
//   as sampling/rejection.py composes it with torch.quantile: the shifts are
//   sorted in shared memory (bitonic, padded with +inf to a power of two),
//   then read at rank q (n - 1) with torch's linear interpolation (the same
//   float32 rank, the same lerp rule; a NaN shift makes it NaN, as torch's
//   does). The TPU kernel left the percentile to its caller, where XLA fused
//   it into one program; here each of the caller's ops was a launch. The
//   gamma_total used is written to a one-float output.
// * drs_accept_philox / drs_accept_from_uniform, any n: one thread per
//   element, gamma_total from the caller (who takes the percentile with
//   tensor ops above the cap).
//
// Bound: bytes. Each element reads 4 bytes (8 with u) and writes 1; the
// arithmetic is ~150 integer and float operations, and the sort
// n log2(n)^2 / 4 compare-exchanges in shared memory. The TPU's 128-lane
// padding is not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int STEP_CAP = 4096;  // ops/accept.py STEP_CAP

__device__ __forceinline__ uint32_t philox_first_word(uint64_t counter,
                                                      uint64_t key) {
  uint32_t c0 = static_cast<uint32_t>(counter);
  uint32_t c1 = static_cast<uint32_t>(counter >> 32);
  uint32_t c2 = 0u, c3 = 0u;
  uint32_t k0 = static_cast<uint32_t>(key);
  uint32_t k1 = static_cast<uint32_t>(key >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

__device__ __forceinline__ uint8_t accept(float logit, float m, float gamma,
                                          float eps, float u) {
  const float f = fminf(logit - m, -eps);
  const float f_hat = f - logf(1.0f - expf(f - eps)) - gamma;
  const float p = 1.0f / (1.0f + expf(-f_hat));
  return u < p ? 1 : 0;
}

__global__ void accept_philox_kernel(const float* __restrict__ logits,
                                     const float* __restrict__ m,
                                     const float* __restrict__ gamma,
                                     const int64_t* __restrict__ seed,
                                     float eps, uint8_t* __restrict__ out,
                                     int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t bits =
      philox_first_word(static_cast<uint64_t>(i),
                        static_cast<uint64_t>(seed[0]));
  const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
  out[i] = accept(logits[i], m[0], gamma[0], eps, u);
}

__global__ void accept_from_uniform_kernel(const float* __restrict__ logits,
                                           const float* __restrict__ m,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ u,
                                           float eps,
                                           uint8_t* __restrict__ out, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  out[i] = accept(logits[i], m[0], gamma[0], eps, u[i]);
}

// The q-quantile of s[0 .. n), sorted, as torch.quantile interpolates.
__device__ float quantile_sorted(const float* s, int n, float q) {
  const float rank = q * static_cast<float>(n - 1);
  const int lo = static_cast<int>(rank);
  const int hi = static_cast<int>(ceilf(rank));
  const float w = rank - static_cast<float>(lo);
  const float a = s[lo], b = s[hi];
  return fabsf(w) < 0.5f ? __fmaf_rn(w, b - a, a)
                         : __fmaf_rn(w - 1.0f, b - a, b);
}

// Ascending bitonic sort of s[0 .. n2), n2 a power of two, by the block.
__device__ void bitonic_sort(float* s, int n2) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n2 / 2; i += blockDim.x) {
        const int a = 2 * i - (i & (j - 1)), b = a + j;
        const float x = s[a], y = s[b];
        if ((x > y) == ((a & k) == 0)) s[a] = y, s[b] = x;
      }
      __syncthreads();
    }
  }
}

// The whole DRS step for n <= STEP_CAP logits, one block. gamma_total =
// (gamma_ptr ? *gamma_ptr : gamma) [+ the q-quantile of the shifts if q >
// 0]; u from `u` if given, else Philox under *seed. Dynamic shared memory:
// n2 floats when q > 0.
__global__ void drs_step_kernel(const float* __restrict__ logits,
                                const float* __restrict__ m,
                                const float* __restrict__ gamma_ptr,
                                float gamma, float q,
                                const int64_t* __restrict__ seed,
                                const float* __restrict__ u, float eps,
                                uint8_t* __restrict__ out,
                                float* __restrict__ gamma_out, int n,
                                int n2) {
  extern __shared__ float s[];
  __shared__ float pct;
  const float mv = m[0];
  float g = gamma_ptr ? gamma_ptr[0] : gamma;
  if (q > 0.0f) {
    int any_nan = 0;
    for (int i = threadIdx.x; i < n2; i += blockDim.x) {
      float v = INFINITY;
      if (i < n) {
        const float diff = logits[i] - mv;  // clamp_max keeps a NaN
        const float f = isnan(diff) ? diff : fminf(diff, -eps);
        v = f - logf(-expm1f(f - eps));
        any_nan |= isnan(v);
      }
      s[i] = v;
    }
    any_nan = __syncthreads_or(any_nan);
    bitonic_sort(s, n2);
    if (threadIdx.x == 0) pct = any_nan ? NAN : quantile_sorted(s, n, q);
    __syncthreads();
    g = g + pct;
  }
  if (gamma_out != nullptr && threadIdx.x == 0) gamma_out[0] = g;
  const uint64_t key = u == nullptr ? static_cast<uint64_t>(seed[0]) : 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float ui;
    if (u != nullptr) {
      ui = u[i];
    } else {
      const uint32_t bits = philox_first_word(static_cast<uint64_t>(i), key);
      ui = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
    }
    out[i] = accept(logits[i], mv, g, eps, ui);
  }
}

}  // namespace

extern "C" {

const char* cgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int drs_accept_philox(const float* logits, const float* m, const float* gamma,
                      const int64_t* seed, float eps, uint8_t* out, int n,
                      cudaStream_t stream) {
  if (n <= 0) return 0;
  accept_philox_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      logits, m, gamma, seed, eps, out, n);
  return static_cast<int>(cudaGetLastError());
}

int drs_accept_from_uniform(const float* logits, const float* m,
                            const float* gamma, const float* u, float eps,
                            uint8_t* out, int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  accept_from_uniform_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                               stream>>>(logits, m, gamma, u, eps, out, n);
  return static_cast<int>(cudaGetLastError());
}

// The DRS step in one launch for 0 < n <= STEP_CAP. gamma_ptr (nullable)
// overrides gamma; q = percentile / 100 (0: none); exactly one of seed and u
// is given; gamma_out (nullable) receives the gamma_total used.
int drs_step(const float* logits, const float* m, const float* gamma_ptr,
             float gamma, float q, const int64_t* seed, const float* u,
             float eps, uint8_t* out, float* gamma_out, int n,
             cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n > STEP_CAP || (seed == nullptr) == (u == nullptr) || !(q >= 0.0f) ||
      q > 1.0f)
    return static_cast<int>(cudaErrorInvalidValue);
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  const int want = q > 0.0f ? n2 / 2 : n;
  const int threads = std::min(1024, std::max(32, (want + 31) / 32 * 32));
  const size_t smem = q > 0.0f ? sizeof(float) * n2 : 0;
  drs_step_kernel<<<1, threads, smem, stream>>>(
      logits, m, gamma_ptr, gamma, q, seed, u, eps, out, gamma_out, n, n2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
