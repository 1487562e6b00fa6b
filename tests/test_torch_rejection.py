"""Parity of the port's DRS helpers (``sampling/rejection.py``) with the JAX
package's: the expm1 shift, the dynamic-percentile gamma, the acceptance
probability and mask (same uniforms), and the burn-in logit max.

float32 on both sides; the shift and probability agree to rtol 1e-6 (same
formula, same rounding up to the last bit of log/expm1), the percentile to
atol 1e-6 (both interpolate linearly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.sampling import rejection as t_rej
from collaborative_gan_sampling_tpu.sampling import rejection as j_rej
from tests.test_torch_models import TINY, make_pair


def _logits(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 2.0
            ).astype(np.float32)


@pytest.mark.parametrize("gamma", [0.0, -1.0, 0.7])
def test_logit_shift(gamma):
    lg = _logits(64, 1)
    m = np.float32(lg.max() - 0.5)  # some logits above M hit the clamp
    want = j_rej.drs_logit_shift(jnp.asarray(lg), m, gamma)
    got = t_rej.drs_logit_shift(torch.from_numpy(lg), float(m), gamma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("percentile", [0.0, 50.0, 80.0, 95.0])
def test_acceptance_prob_with_percentile(percentile):
    lg = _logits(101, 2)
    m = lg.max()
    want = j_rej.drs_acceptance_prob(jnp.asarray(lg), m, gamma=0.3,
                                     gamma_percentile=percentile)
    got = t_rej.drs_acceptance_prob(torch.from_numpy(lg), float(m), 0.3,
                                    gamma_percentile=percentile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    shifted = j_rej.drs_logit_shift(jnp.asarray(lg), m)
    g = t_rej.gamma_total(torch.from_numpy(np.array(shifted)), 0.3,
                          percentile)
    want_g = 0.3 + (float(jnp.percentile(shifted, percentile))
                    if percentile > 0 else 0.0)
    assert float(g) == pytest.approx(want_g, abs=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_accept_mask_same_uniforms(use_pallas):
    lg = _logits(256, 3)
    m = lg.max()
    key = jax.random.PRNGKey(4)
    want = j_rej.drs_accept_mask(key, jnp.asarray(lg), m, 0.0, 1e-6, 80.0)
    u = np.array(jax.random.uniform(key, lg.shape))
    got = t_rej.drs_accept_mask(None, torch.from_numpy(lg), float(m), 0.0,
                                1e-6, 80.0, use_pallas=use_pallas,
                                uniforms=torch.from_numpy(u))
    p = np.asarray(j_rej.drs_acceptance_prob(jnp.asarray(lg), m, 0.0, 1e-6,
                                             80.0))
    differ = got.numpy() != np.asarray(want)
    # The kernel's log(1 - exp) form may round the other way only within
    # 1e-6 of the acceptance probability.
    assert not np.any(differ & (np.abs(u - p) >= 1e-6))
    assert 0.1 < got.float().mean() < 0.9


def test_estimate_logit_max():
    jb, tb, _, d_vars, _, d = make_pair(TINY, seed=41)
    key = jax.random.PRNGKey(5)

    def j_sample(k, n):
        return jax.random.uniform(k, (n, *jb.data_shape), minval=-1.0,
                                  maxval=1.0), None

    for burn_in, n_batches in ((12, 3), (1, 1)):
        want = j_rej.estimate_logit_max(jb, d_vars, j_sample, key, burn_in, 4)
        batches = iter([np.array(j_sample(jax.random.fold_in(key, i), 4)[0])
                        for i in range(n_batches)])
        got = t_rej.estimate_logit_max(
            tb, d, lambda gen, n: (torch.from_numpy(next(batches)), None),
            None, burn_in=burn_in, batch_size=4)
        assert float(got) == pytest.approx(float(want), abs=1e-6)
        assert next(batches, None) is None  # as many batches as JAX drew
