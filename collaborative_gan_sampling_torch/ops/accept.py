"""DRS accept step: the CUDA kernel's wrappers and their plain versions.

The kernel (``csrc/drs_accept.cu``) replaces the TPU kernel
``collaborative_gan_sampling_tpu/ops/accept_pallas.py``, with its two entries:

* ``drs_accept_mask_philox`` (for ``drs_accept_mask_pallas``) draws u inside
  the kernel from Philox4x32-10, keyed by a 64-bit seed that ``draw_seed``
  takes from the caller's ``torch.Generator``, counter = element index;
* ``drs_accept_mask_from_uniform`` (for
  ``drs_accept_mask_pallas_from_uniform``) takes u from the caller.

Both compute ``_accept_math``: f = min(F - M, -eps), F_hat = f - log(1 -
exp(f - eps)) - gamma_total, accept = u < sigmoid(F_hat), with gamma_total =
gamma plus, where ``gamma_percentile`` > 0, that percentile of the batch's
expm1-form shift (``drs_logit_shift``), composed as ``gamma_total_plain``
composes it. Up to ``STEP_CAP`` logits the whole step, percentile included,
is one launch (one block sorts the batch in shared memory); above it the
percentile is taken with tensor ops and the kernel gets gamma_total. The
plain versions (``*_plain``) reproduce the Philox bits exactly with int64
tensor arithmetic, so the card's masks can be held against them element by
element.

Each entry is a ``torch.library`` custom op, ``cgs::drs_accept_philox`` and
``cgs::drs_accept_from_uniform`` (``ops/registry.py``): its CUDA
implementation launches the kernel and counts on the wrapper's ``launches``
(so a launch from a reloaded ``torch.export`` artifact counts too), its CPU
implementation is the plain version, and its fake implementation gives the
shapes to ``torch.export``. Each returns (mask, gamma_total) and writes no
input; the wrapper copies gamma_total to ``gamma_out``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from collaborative_gan_sampling_torch.ops import _build

STEP_CAP = 4096  # largest batch of the one-launch step (csrc/drs_accept.cu)
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


def drs_logit_shift(logits: torch.Tensor, logit_max, gamma: float = 0.0,
                    eps: float = 1e-6) -> torch.Tensor:
    """F_hat in the expm1 form; a logit above M is clamped to M - eps."""
    f = torch.clamp_max(logits - logit_max, -eps)
    return f - torch.log(-torch.expm1(f - eps)) - gamma


def gamma_total(shifted: torch.Tensor, gamma,
                gamma_percentile: float) -> torch.Tensor:
    """Static gamma (a float or a device scalar) plus, with
    ``gamma_percentile`` > 0, the batch percentile of F_hat (linear
    interpolation, as ``jnp.percentile``). A float gamma is filled on the
    device: a copy from the host would make the host wait for the card."""
    if isinstance(gamma, torch.Tensor):
        g = gamma.to(shifted.device, torch.float32)
    else:
        g = torch.full((), gamma, dtype=torch.float32, device=shifted.device)
    if gamma_percentile > 0:
        g = g + torch.quantile(shifted, gamma_percentile / 100.0)
    return g


def gamma_total_plain(logits: torch.Tensor, logit_max, gamma,
                      gamma_percentile: float, eps: float) -> torch.Tensor:
    """gamma_total of the accept step as a (1,) float32 tensor: the
    percentile term taken over the expm1-form shift, as
    ``sampling/rejection.py`` composes it."""
    shifted = (drs_logit_shift(logits, logit_max, 0.0, eps)
               if gamma_percentile > 0 else logits)
    return gamma_total(shifted, gamma, gamma_percentile).reshape(1)


def _accept_plain(uniforms, logits, logit_max, gamma_total, eps):
    f = torch.clamp_max(logits.float() - _scalar(logit_max, logits), -eps)
    f_hat = f - torch.log(1.0 - torch.exp(f - eps)) - gamma_total
    return uniforms < torch.sigmoid(f_hat)


def drs_accept_mask_from_uniform_plain(uniforms, logits, logit_max, gamma,
                                       eps=1e-6, gamma_percentile=0.0,
                                       gamma_out=None):
    """``_accept_math`` of the TPU kernel, in the log(1 - exp) form, with
    gamma_total from ``gamma_total_plain`` (written to ``gamma_out``, a (1,)
    float32 tensor, where given)."""
    g = gamma_total_plain(logits, logit_max, gamma, gamma_percentile, eps)
    if gamma_out is not None:
        gamma_out.copy_(g)
    return _accept_plain(uniforms, logits, logit_max, g, eps)


def drs_accept_mask_philox_plain(seed, logits, logit_max, gamma, eps=1e-6,
                                 gamma_percentile=0.0, gamma_out=None):
    u = bits_to_uniform(philox_bits_plain(seed, logits.shape[0]))
    return drs_accept_mask_from_uniform_plain(u, logits, logit_max, gamma,
                                              eps, gamma_percentile,
                                              gamma_out)


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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("drs_accept")
    for entry in (lib.drs_accept_philox, lib.drs_accept_from_uniform):
        entry.restype = ctypes.c_int
        entry.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.drs_step.restype = ctypes.c_int
    lib.drs_step.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p] * 2 + [ctypes.c_float] + [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_void_p]
    return lib


def _accept(logits, logit_max, gamma, eps, gamma_percentile, gamma_out,
            seed=None, uniforms=None) -> torch.Tensor:
    """Launches the step (n <= STEP_CAP) or the elementwise kernel after
    the tensor-op percentile (above), u from ``seed`` or ``uniforms``."""
    logits = logits.contiguous()
    n = logits.shape[0]
    m = _scalar(logit_max, logits)
    out = torch.empty(n, dtype=torch.bool, device=logits.device)
    lib = _lib()
    if n <= STEP_CAP:
        g = (_scalar(gamma, logits) if isinstance(gamma, torch.Tensor)
             else None)
        err = lib.drs_step(
            _build.ptr(logits), _build.ptr(m),
            None if g is None else _build.ptr(g),
            0.0 if g is not None else float(gamma), gamma_percentile / 100.0,
            None if seed is None else _build.ptr(seed),
            None if uniforms is None else _build.ptr(uniforms), float(eps),
            _build.ptr(out),
            None if gamma_out is None else _build.ptr(gamma_out), n,
            _build.stream_of(logits))
        _build.check(lib, err, "drs_step")
        return out
    g = gamma_total_plain(logits, m, gamma, gamma_percentile, eps)
    if gamma_out is not None:
        gamma_out.copy_(g)
    entry, arg = ((lib.drs_accept_philox, seed) if seed is not None
                  else (lib.drs_accept_from_uniform, uniforms))
    err = entry(_build.ptr(logits), _build.ptr(m), _build.ptr(g),
                _build.ptr(arg), float(eps), _build.ptr(out), n,
                _build.stream_of(logits))
    _build.check(lib, err, "drs_accept")
    return out


def _launch_op(logits, m, gamma_t, gamma, eps, gamma_percentile, seed=None,
               uniforms=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The ops' CUDA implementation: (mask, gamma_total), both allocated
    here."""
    _check(logits)
    g_out = torch.empty(1, dtype=torch.float32, device=logits.device)
    out = _accept(logits, m, gamma if gamma_t is None else gamma_t, eps,
                  gamma_percentile, g_out, seed=seed, uniforms=uniforms)
    return out, g_out


def _cpu_impl(plain):
    """An op's CPU implementation: the plain version ``plain``, returning
    (mask, gamma_total) as new tensors."""
    def cpu(draw, logits, m, gamma_t, gamma, eps, gamma_percentile):
        g = torch.empty(1, dtype=torch.float32, device=logits.device)
        mask = plain(draw, logits, m, gamma if gamma_t is None else gamma_t,
                     eps, gamma_percentile, gamma_out=g)
        return mask, g

    return cpu


def _philox_cuda(seed, logits, m, gamma_t, gamma, eps, gamma_percentile):
    out = _launch_op(logits, m, gamma_t, gamma, eps, gamma_percentile,
                     seed=seed.contiguous())
    drs_accept_mask_philox.launches += 1
    return out


def _from_uniform_cuda(uniforms, logits, m, gamma_t, gamma, eps,
                       gamma_percentile):
    if uniforms.shape != logits.shape or uniforms.dtype != torch.float32:
        raise ValueError("uniforms must be float32 of the logits' shape")
    out = _launch_op(logits, m, gamma_t, gamma, eps, gamma_percentile,
                     uniforms=uniforms.contiguous())
    drs_accept_mask_from_uniform.launches += 1
    return out


def _accept_fake(draw, logits, m, gamma_t, gamma, eps, gamma_percentile):
    return (logits.new_empty(logits.shape, dtype=torch.bool),
            logits.new_empty((1,), dtype=torch.float32))


_ACCEPT_ARGS = ("Tensor logits, Tensor m, Tensor? gamma_t, float gamma, "
                "float eps, float gamma_percentile) -> (Tensor, Tensor)")
_build.define_op("drs_accept_philox(Tensor seed, " + _ACCEPT_ARGS,
                 _cpu_impl(drs_accept_mask_philox_plain), _philox_cuda,
                 _accept_fake)
_build.define_op("drs_accept_from_uniform(Tensor uniforms, " + _ACCEPT_ARGS,
                 _cpu_impl(drs_accept_mask_from_uniform_plain),
                 _from_uniform_cuda, _accept_fake)


def _check_gamma_out(gamma_out, logits) -> None:
    if gamma_out is not None and (
            gamma_out.shape != (1,) or gamma_out.dtype != torch.float32
            or gamma_out.device != logits.device):
        raise ValueError("gamma_out must be a (1,) float32 tensor on "
                         f"{logits.device}")


def _call(op, draw, logits, logit_max, gamma, eps, gamma_percentile,
          gamma_out) -> torch.Tensor:
    """One call of ``op``: M and a device gamma as (1,) float32 on the
    logits' device, a float gamma as a float; gamma_total copied to
    ``gamma_out`` where given."""
    _build.check_device(logits, "DRS accept")
    _check_gamma_out(gamma_out, logits)
    gamma_t = (_scalar(gamma, logits) if isinstance(gamma, torch.Tensor)
               else None)
    mask, g = op(draw.to(logits.device), logits, _scalar(logit_max, logits),
                 gamma_t, 0.0 if gamma_t is not None else float(gamma),
                 float(eps), float(gamma_percentile))
    if gamma_out is not None:
        gamma_out.copy_(g)
    return mask


def drs_accept_mask_philox(seed: torch.Tensor, logits: torch.Tensor,
                           logit_max, gamma, eps: float = 1e-6,
                           gamma_percentile: float = 0.0,
                           gamma_out: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Boolean accept mask for (B,) logits, u drawn inside the kernel under
    the Philox key ``seed`` (see ``draw_seed``); gamma_total = gamma (a
    float or a device scalar) plus the ``gamma_percentile`` term, written to
    ``gamma_out`` where given."""
    return _call(torch.ops.cgs.drs_accept_philox,
                 seed.to(torch.int64).reshape(1), logits, logit_max, gamma,
                 eps, gamma_percentile, gamma_out)


def drs_accept_mask_from_uniform(uniforms: torch.Tensor, logits: torch.Tensor,
                                 logit_max, gamma, eps: float = 1e-6,
                                 gamma_percentile: float = 0.0,
                                 gamma_out: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Accept mask from caller-supplied uniforms (the parity entry), with
    the same gamma_total as ``drs_accept_mask_philox``."""
    return _call(torch.ops.cgs.drs_accept_from_uniform, uniforms, logits,
                 logit_max, gamma, eps, gamma_percentile, gamma_out)


drs_accept_mask_philox.launches = 0
drs_accept_mask_from_uniform.launches = 0
