"""DRS accept step: the CUDA kernel's wrappers and its plain version.

The kernel (``csrc/drs_accept.cu``) replaces the TPU kernel
``collaborative_gan_sampling_tpu/ops/accept_pallas.py``, with its two entries:

* ``drs_accept_mask_philox`` (for ``drs_accept_mask_pallas``) draws u inside
  the kernel from Philox4x32-10, keyed by a 64-bit seed that ``draw_seed``
  takes from the caller's ``torch.Generator``, counter = element index;
* ``drs_accept_mask_from_uniform`` (for
  ``drs_accept_mask_pallas_from_uniform``) takes u from the caller.

Both compute ``_accept_math``: f = min(F - M, -eps), F_hat = f - log(1 -
exp(f - eps)) - gamma_total, accept = u < sigmoid(F_hat). gamma_total,
including any percentile term, is the caller's. The plain versions
(``*_plain``) reproduce the Philox bits exactly with int64 tensor arithmetic,
so the card's masks can be held against them element by element. A wrapper
takes the plain version for tensors on the CPU and launches the kernel for
tensors on the card.
"""

from __future__ import annotations

import ctypes

import torch

from collaborative_gan_sampling_torch.ops import _build

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * b for a 32-bit constant a and an int64
    tensor b of 32-bit values, without overflowing int64."""
    p_lo = b * (a & 0xFFFF)  # < 2^48
    p_hi = b * (a >> 16)  # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (mid >> 32)) & _MASK32, mid & _MASK32


def philox4x32_plain(counter, key):
    """Philox4x32-10 on int64 tensors holding 32-bit words: counter is
    (c0, c1, c2, c3), key is (k0, k1); returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def philox_bits_plain(seed: torch.Tensor, n: int) -> torch.Tensor:
    """First 32-bit word of Philox4x32-10 at counters 0..n-1 under the
    64-bit key ``seed`` (an int64 tensor of one element), as int64."""
    seed = seed.reshape(()).to(torch.int64)
    idx = torch.arange(n, dtype=torch.int64, device=seed.device)
    zero = torch.zeros_like(idx)
    counter = (idx & _MASK32, idx >> 32, zero, zero)
    return philox4x32_plain(counter, (seed & _MASK32,
                                      (seed >> 32) & _MASK32))[0]


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Top 24 of 32 bits -> float32 in [0, 1), as the kernels convert."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def drs_accept_mask_from_uniform_plain(uniforms, logits, logit_max,
                                       gamma_total, eps=1e-6):
    """``_accept_math`` of the TPU kernel, in the log(1 - exp) form."""
    f = torch.clamp_max(logits.float() - _scalar(logit_max, logits), -eps)
    f_hat = (f - torch.log(1.0 - torch.exp(f - eps))
             - _scalar(gamma_total, logits))
    return uniforms < torch.sigmoid(f_hat)


def drs_accept_mask_philox_plain(seed, logits, logit_max, gamma_total,
                                 eps=1e-6):
    u = bits_to_uniform(philox_bits_plain(seed, logits.shape[0]))
    return drs_accept_mask_from_uniform_plain(u, logits, logit_max,
                                              gamma_total, eps)


def draw_seed(generator: torch.Generator | None,
              device: torch.device) -> torch.Tensor:
    """A 62-bit Philox key drawn from ``generator``, as int64 (1,) on
    ``device``."""
    gdev = generator.device if generator is not None else device
    seed = torch.randint(0, 1 << 62, (1,), generator=generator, device=gdev,
                         dtype=torch.int64)
    return seed.to(device)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32,
                           device=like.device).reshape(1)


def _check(logits: torch.Tensor) -> None:
    if logits.ndim != 1 or logits.dtype != torch.float32:
        raise ValueError("DRS accept kernel takes (B,) float32 logits, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    if logits.device.type != "cuda":
        raise ValueError(f"no DRS accept kernel for device {logits.device}")


def _lib():
    lib = _build.load("drs_accept")
    lib.drs_accept_philox.restype = ctypes.c_int
    lib.drs_accept_philox.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.drs_accept_from_uniform.restype = ctypes.c_int
    lib.drs_accept_from_uniform.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return lib


def drs_accept_mask_philox(seed: torch.Tensor, logits: torch.Tensor,
                           logit_max, gamma_total,
                           eps: float = 1e-6) -> torch.Tensor:
    """Boolean accept mask for (B,) logits, u drawn inside the kernel under
    the Philox key ``seed`` (see ``draw_seed``)."""
    if logits.device.type == "cpu":
        return drs_accept_mask_philox_plain(seed, logits, logit_max,
                                            gamma_total, eps)
    _check(logits)
    logits = logits.contiguous()
    m, g = _scalar(logit_max, logits), _scalar(gamma_total, logits)
    seed = seed.to(logits.device, torch.int64).reshape(1).contiguous()
    out = torch.empty(logits.shape[0], dtype=torch.bool, device=logits.device)
    lib = _lib()
    err = lib.drs_accept_philox(_build.ptr(logits), _build.ptr(m),
                                _build.ptr(g), _build.ptr(seed), float(eps),
                                _build.ptr(out), logits.shape[0],
                                _build.stream_of(logits))
    _build.check(lib, err, "drs_accept_philox")
    drs_accept_mask_philox.launches += 1
    return out


def drs_accept_mask_from_uniform(uniforms: torch.Tensor, logits: torch.Tensor,
                                 logit_max, gamma_total,
                                 eps: float = 1e-6) -> torch.Tensor:
    """Accept mask from caller-supplied uniforms (the parity entry)."""
    if logits.device.type == "cpu":
        return drs_accept_mask_from_uniform_plain(uniforms, logits,
                                                  logit_max, gamma_total, eps)
    _check(logits)
    if uniforms.shape != logits.shape or uniforms.dtype != torch.float32:
        raise ValueError("uniforms must be float32 of the logits' shape")
    logits, u = logits.contiguous(), uniforms.to(logits.device).contiguous()
    m, g = _scalar(logit_max, logits), _scalar(gamma_total, logits)
    out = torch.empty(logits.shape[0], dtype=torch.bool, device=logits.device)
    lib = _lib()
    err = lib.drs_accept_from_uniform(_build.ptr(logits), _build.ptr(m),
                                      _build.ptr(g), _build.ptr(u),
                                      float(eps), _build.ptr(out),
                                      logits.shape[0],
                                      _build.stream_of(logits))
    _build.check(lib, err, "drs_accept_from_uniform")
    drs_accept_mask_from_uniform.launches += 1
    return out


drs_accept_mask_philox.launches = 0
drs_accept_mask_from_uniform.launches = 0
