"""The DRS step of ``ops/accept.py`` with its percentile term: the plain
versions against the JAX package, the one-launch kernel's sort and
interpolation emulated on the CPU, and the dispatch on ``STEP_CAP``.

* The plain route (the expm1 shift, ``torch.quantile``, then the log(1 -
  exp) accept math) against the JAX package's composition: ``jnp.percentile``
  of ``drs_logit_shift``, then ``drs_accept_mask_pallas_from_uniform`` in
  interpret mode, the same uniforms from numpy on both sides. Masks agree
  wherever u is 1e-6 or more from the acceptance probability; gamma_total
  to 1e-6 (both interpolate linearly between the same float32 order
  statistics; the shifts may differ in the last bit of log/expm1).
* ``emulate_step_quantile`` sorts as the kernel does (bitonic, padded with
  +inf to a power of two, the same compare-exchange network) and
  interpolates at the kernel's float32 rank with its fused multiply-add
  lerp: equal to ``torch.quantile`` bit for bit, ties included.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.ops import _build
from collaborative_gan_sampling_torch.ops import accept as A
from collaborative_gan_sampling_torch.sampling import rejection as t_rej
from collaborative_gan_sampling_tpu.ops.accept_pallas import (
    drs_accept_mask_pallas_from_uniform,
)
from collaborative_gan_sampling_tpu.sampling import rejection as j_rej

BAND = 1e-6
EPS = 1e-6


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(n) * 3.0).astype(np.float32)
    u = rng.uniform(size=n).astype(np.float32)
    return logits, u


@pytest.mark.parametrize("pct", [0.0, 80.0])
@pytest.mark.parametrize("n", [1, 37, 256, 1000])
def test_plain_step_matches_jax_percentile_and_pallas(n, pct):
    logits, u = _inputs(n, seed=n + int(pct))
    m, gamma = np.float32(logits.max() - 0.3), 0.25
    shifted = j_rej.drs_logit_shift(jnp.asarray(logits), m, 0.0, EPS)
    g_want = np.float32(gamma) + (np.float32(jnp.percentile(shifted, pct))
                                  if pct > 0 else np.float32(0.0))
    want = drs_accept_mask_pallas_from_uniform(
        jnp.asarray(u), jnp.asarray(logits), jnp.float32(m),
        jnp.float32(g_want), interpret=True)
    p = np.asarray(j_rej.drs_acceptance_prob(jnp.asarray(logits), m, gamma,
                                             EPS, pct))
    g_out = torch.empty(1)
    got = A.drs_accept_mask_from_uniform(torch.from_numpy(u),
                                         torch.from_numpy(logits), float(m),
                                         gamma, EPS, pct, gamma_out=g_out)
    assert got.dtype == torch.bool and got.shape == (n,)
    assert abs(float(g_out) - float(g_want)) <= 1e-6 * max(1.0, abs(g_want))
    differ = got.numpy() != np.asarray(want)
    assert not np.any(differ & (np.abs(u - p) >= BAND))


@pytest.mark.parametrize("pct", [0.0, 80.0])
def test_plain_philox_step_is_the_old_composition(pct):
    """The percentile term moved into the plain version unchanged: the
    same mask, bit for bit, as gamma_total taken first and passed in."""
    logits, _ = _inputs(300, seed=5)
    lg, m = torch.from_numpy(logits), float(logits.max())
    seed = A.draw_seed(torch.Generator().manual_seed(3), lg.device)
    g = t_rej.gamma_total(A.drs_logit_shift(lg, m, 0.0, EPS), -0.5, pct)
    want = A.drs_accept_mask_philox_plain(seed, lg, m, g, EPS)
    got = A.drs_accept_mask_philox(seed, lg, m, -0.5, EPS, pct)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _bitonic(s):
    """The kernel's ascending bitonic network on a power-of-two array."""
    s = s.copy()
    n2 = s.shape[0]
    i = np.arange(n2 // 2)
    k = 2
    while k <= n2:
        j = k >> 1
        while j > 0:
            a = 2 * i - (i & (j - 1))
            b = a + j
            x, y = s[a], s[b]
            swap = (x > y) == ((a & k) == 0)
            s[a], s[b] = np.where(swap, y, x), np.where(swap, x, y)
            j >>= 1
        k <<= 1
    return s


def _fma32(a, b, c):
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def emulate_step_quantile(shifted, q):
    """``quantile_sorted`` of csrc/drs_accept.cu after its sort."""
    n = shifted.shape[0]
    n2 = 1 << max(0, (n - 1).bit_length())
    s = _bitonic(np.concatenate([shifted, np.full(n2 - n, np.inf,
                                                  np.float32)]))
    rank = np.float32(np.float32(q) * np.float32(n - 1))
    lo, hi = int(rank), int(np.ceil(rank))
    w = np.float32(rank - np.float32(lo))
    a, b = s[lo], s[hi]
    d = np.float32(b - a)
    if abs(w) < 0.5:
        return _fma32(w, d, a)
    return _fma32(np.float32(w - np.float32(1.0)), d, b)


@pytest.mark.parametrize("n", [1, 2, 37, 256, 4096])
def test_emulated_sort_and_lerp_equal_torch_quantile(n):
    rng = np.random.default_rng(n)
    logits = (rng.standard_normal(n) * 3.0).astype(np.float32)
    logits[: n // 3] = np.round(logits[: n // 3])  # ties
    shifted = A.drs_logit_shift(torch.from_numpy(logits),
                                float(logits.max()), 0.0, EPS)
    assert torch.isfinite(shifted).all()
    for pct in (80.0, 50.0, 95.0, 37.0, 100.0, 0.1):
        q = pct / 100.0
        want = np.float32(torch.quantile(shifted, q))
        got = emulate_step_quantile(shifted.numpy(), q)
        assert got.tobytes() == want.tobytes(), (n, pct, got, want)


class _FakeLib:
    """Stands in for the loaded library: records each entry's arguments,
    and the float its third argument (gamma) points to at the call."""

    def __init__(self):
        self.calls, self.gamma = [], None

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            if args[2] is not None:
                self.gamma = ctypes.c_float.from_address(args[2].value).value
            return 0
        return entry


@pytest.mark.parametrize("n,route", [(A.STEP_CAP, "drs_step"),
                                     (A.STEP_CAP + 1, "drs_accept_philox")])
def test_dispatch_on_the_cap(n, route, monkeypatch):
    """Up to STEP_CAP the percentile goes to the kernel (one launch); above
    it gamma_total is taken with tensor ops and handed to the elementwise
    kernel."""
    lib = _FakeLib()
    monkeypatch.setattr(A, "_lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    logits, _ = _inputs(n, seed=7)
    lg = torch.from_numpy(logits)
    m = float(logits.max())
    seed = torch.tensor([12345])
    A._accept(lg, m, 0.25, EPS, 80.0, None, seed=seed)
    [(name, args)] = lib.calls
    assert name == route
    if route == "drs_step":
        assert args[2] is None and args[3] == 0.25
        assert args[4] == pytest.approx(0.8) and args[6] is None
    else:
        want = A.gamma_total_plain(lg, m, 0.25, 80.0, EPS)
        assert np.float32(lib.gamma) == np.float32(want[0])


def test_dispatch_passes_a_tensor_gamma_by_pointer(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(A, "_lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    gamma = torch.tensor([-0.75])
    A._accept(torch.zeros(8), 0.0, gamma, EPS, 0.0, None,
              uniforms=torch.zeros(8))
    [(_, args)] = lib.calls
    assert args[2].value == gamma.data_ptr() and args[5] is None
    assert lib.gamma == -0.75


def test_rejection_hands_the_percentile_to_the_kernel(monkeypatch):
    seen = []
    monkeypatch.setattr(t_rej, "drs_accept_mask_philox",
                        lambda *a: seen.append(a) or torch.zeros(4, dtype=bool))
    monkeypatch.setattr(torch, "quantile", None)  # not taken by the caller
    t_rej.drs_accept_mask(torch.Generator().manual_seed(1), torch.zeros(4),
                          1.0, 0.3, EPS, 80.0, use_pallas=True)
    [(_, _, m, gamma, eps, pct)] = seen
    assert (m, gamma, eps, pct) == (1.0, 0.3, EPS, 80.0)


def test_gamma_out_on_the_plain_route():
    logits, u = _inputs(64, seed=9)
    lg = torch.from_numpy(logits)
    out = torch.empty(1)
    A.drs_accept_mask_from_uniform(torch.from_numpy(u), lg, 0.5, 0.1, EPS,
                                   80.0, gamma_out=out)
    want = 0.1 + torch.quantile(A.drs_logit_shift(lg, 0.5, 0.0, EPS), 0.8)
    assert float(out) == pytest.approx(float(want), abs=0.0)


def test_step_cap_matches_the_source():
    src = (_build.CSRC / "drs_accept.cu").read_text()
    cap = re.search(r"constexpr int STEP_CAP = (\d+);", src).group(1)
    assert int(cap) == A.STEP_CAP == 4096
