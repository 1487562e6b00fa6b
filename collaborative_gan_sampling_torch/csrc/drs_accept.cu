// DRS accept step for Hopper (sm_90a): one elementwise pass per batch.
//
// Replaces the TPU kernel collaborative_gan_sampling_tpu/ops/accept_pallas.py
// (drs_accept_mask_pallas -> _accept_kernel_hw -> _accept_math, and the
// parity entry drs_accept_mask_pallas_from_uniform -> _accept_kernel_from_u).
// Per logit F, with the burn-in max M and the caller's gamma_total:
//
//     f     = min(F - M, -eps)
//     F_hat = f - log(1 - exp(f - eps)) - gamma_total
//     accept = u < sigmoid(F_hat)
//
// u comes either from Philox4x32-10 written into the kernel (key = the 64-bit
// seed the wrapper draws from its torch.Generator, counter = element index,
// u = (first word >> 8) * 2^-24, as the TPU kernel converted its bits), or
// from a caller's tensor. M, gamma_total and the seed are read from device
// scalars, so the caller never waits for the device.
//
// Bound: bytes. Each element reads 4 bytes (8 with u) and writes 1; the
// arithmetic is ~150 integer and float operations. One thread per element,
// ragged edge masked; the TPU's 128-lane padding is not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

}  // extern "C"
