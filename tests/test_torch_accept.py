"""Parity of the port's DRS accept step (``ops/accept.py``) with the JAX
package's Pallas accept kernel (interpret mode) and its jnp oracle.

Both sides get the same uniforms. The port's plain version computes the
kernel's ``log(1 - exp(.))`` form and the oracle the ``expm1`` form, so the
masks must agree wherever u is further than 1e-6 from the acceptance
probability; within that band a float32 rounding may decide either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.ops.accept import (
    bits_to_uniform,
    drs_accept_mask_from_uniform,
    drs_accept_mask_philox,
    drs_accept_mask_philox_plain,
    draw_seed,
    philox4x32_plain,
    philox_bits_plain,
)
from collaborative_gan_sampling_tpu.ops.accept_pallas import (
    drs_accept_mask_pallas_from_uniform,
)
from collaborative_gan_sampling_tpu.sampling.rejection import (
    drs_acceptance_prob,
)

BAND = 1e-6


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(n) * 3.0).astype(np.float32)
    u = rng.uniform(size=n).astype(np.float32)
    return logits, u


def _assert_masks_agree(got, want, u, p):
    differ = np.asarray(got) != np.asarray(want)
    assert not np.any(differ & (np.abs(u - p) >= BAND))


@pytest.mark.parametrize("n", [7, 256, 1000])
@pytest.mark.parametrize("gamma", [-2.0, 0.0, 1.5])
def test_from_uniform_matches_pallas_and_oracle(n, gamma):
    logits, u = _inputs(n, seed=n + int(gamma * 10) + 17)
    m = logits.max()
    p = np.asarray(drs_acceptance_prob(jnp.asarray(logits), m, gamma=gamma))
    pallas = drs_accept_mask_pallas_from_uniform(
        jnp.asarray(u), jnp.asarray(logits), jnp.float32(m),
        jnp.float32(gamma), interpret=True)
    got = drs_accept_mask_from_uniform(torch.from_numpy(u),
                                       torch.from_numpy(logits), float(m),
                                       gamma)
    assert got.dtype == torch.bool and got.shape == (n,)
    _assert_masks_agree(got.numpy(), np.asarray(pallas), u, p)
    _assert_masks_agree(got.numpy(), u < p, u, p)


def test_logit_above_max_is_clamped():
    logits = np.array([-1.0, 0.0, 2.0, 5.0], np.float32)
    u = np.full(4, 0.3, np.float32)
    m = np.float32(1.0)  # two logits exceed M
    p = np.asarray(drs_acceptance_prob(jnp.asarray(logits), m, gamma=0.0))
    pallas = drs_accept_mask_pallas_from_uniform(
        jnp.asarray(u), jnp.asarray(logits), jnp.float32(m), jnp.float32(0.0),
        interpret=True)
    got = drs_accept_mask_from_uniform(torch.from_numpy(u),
                                       torch.from_numpy(logits), 1.0, 0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(got.numpy(), u < p)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_plain_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    t = [torch.tensor([v], dtype=torch.int64) for v in ctr]
    k = [torch.tensor([v], dtype=torch.int64) for v in key]
    got = tuple(int(w) for w in philox4x32_plain(t, k))
    assert got == want


def test_plain_philox_bits_to_uniform():
    """Counter = element index under the seed key; the top 24 bits map into
    [0, 1) exactly as the TPU kernel's conversion does."""
    bits = philox_bits_plain(torch.tensor([0]), 1)
    assert int(bits[0]) == 0x6627E8D5
    words = torch.tensor([0, 1, 255, 256, (1 << 32) - 1, 0x80000000],
                         dtype=torch.int64)
    u = bits_to_uniform(words)
    assert u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert float(u[4]) == (2 ** 24 - 1) / 2 ** 24
    assert float(u[5]) == 0.5
    big = bits_to_uniform(philox_bits_plain(torch.tensor([12345]), 1 << 14))
    assert abs(float(big.mean()) - 0.5) < 0.02


def test_philox_wrapper_on_cpu_takes_plain_version():
    logits, _ = _inputs(300, seed=1)
    lg = torch.from_numpy(logits)
    before = drs_accept_mask_philox.launches
    seed = draw_seed(torch.Generator().manual_seed(4), lg.device)
    got = drs_accept_mask_philox(seed, lg, float(logits.max()), -1.0)
    want = drs_accept_mask_philox_plain(seed, lg, float(logits.max()), -1.0)
    assert drs_accept_mask_philox.launches == before
    torch.testing.assert_close(got, want)


def test_philox_accept_rate_matches_probability():
    n = 1 << 15
    logits, _ = _inputs(n, seed=2)
    m = logits.max()
    p = np.asarray(drs_acceptance_prob(jnp.asarray(logits), m, gamma=0.0))
    seed = draw_seed(torch.Generator().manual_seed(1), torch.device("cpu"))
    mask = drs_accept_mask_philox(seed, torch.from_numpy(logits), float(m),
                                  0.0)
    sigma = np.sqrt(np.sum(p * (1 - p))) / n
    assert abs(float(mask.float().mean()) - float(p.mean())) < 4 * sigma
