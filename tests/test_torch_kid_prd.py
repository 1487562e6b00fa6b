"""KID and improved precision/recall against the JAX package's.

KID: ``jax.random.choice(..., replace=False)`` cannot be reproduced, so the
JAX subsets' indices are drawn here (as ``evals/kid.py::kid`` draws them)
and given to the port's ``kid_from_indices``; mean and population std at
rtol 1e-5 (float32 Gram sums in another order). The port's own ``kid``
(torch.randperm subsets) is held to the JAX value over all rows at 5%.
Precision/recall: the same counts of k-NN memberships on float32
distances (no point of these draws lies within rounding of a radius), so
the shares agree to float32 rounding of the mean.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.evals import prd as tprd
from collaborative_gan_sampling_tpu.evals import prd as jprd

# The packages' evals/__init__ export the function kid over its module.
tkid = importlib.import_module("collaborative_gan_sampling_torch.evals.kid")
jkid = importlib.import_module("collaborative_gan_sampling_tpu.evals.kid")


def _feats(n, f, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, f)) + shift).astype(np.float32)


def _jax_subsets(key, nr, nf, s, n_subsets):
    """The indices evals/kid.py::kid draws for each subset."""
    ri, fi = [], []
    for k in jax.random.split(key, n_subsets):
        kr, kf = jax.random.split(k)
        ri.append(np.asarray(jax.random.choice(kr, nr, (s,), replace=False)))
        fi.append(np.asarray(jax.random.choice(kf, nf, (s,), replace=False)))
    return np.stack(ri), np.stack(fi)


@pytest.mark.parametrize("subset_size", [50, 1000], ids=["subsets", "all"])
def test_kid_with_injected_subsets_matches_jax(subset_size):
    fr, ff = _feats(300, 16, 1), _feats(240, 16, 2, 0.2)
    key = jax.random.PRNGKey(3)
    want_mean, want_std = jkid.kid(jnp.asarray(fr), jnp.asarray(ff), key,
                                   n_subsets=6, subset_size=subset_size)
    s = min(subset_size, 300, 240)
    ri, fi = _jax_subsets(key, 300, 240, s, 6)
    mean, std = tkid.kid_from_indices(torch.from_numpy(fr),
                                      torch.from_numpy(ff),
                                      torch.from_numpy(ri),
                                      torch.from_numpy(fi))
    assert float(mean) == pytest.approx(float(want_mean), rel=1e-5)
    assert float(std) == pytest.approx(float(want_std), rel=1e-4, abs=1e-9)


def test_kid_draws_its_own_subsets():
    fr, ff = _feats(400, 8, 4), _feats(400, 8, 5, 0.3)
    exact = float(jkid.mmd2_unbiased(jnp.asarray(fr), jnp.asarray(ff)))
    gen = torch.Generator().manual_seed(0)
    mean, std = tkid.kid(torch.from_numpy(fr), torch.from_numpy(ff), gen,
                         n_subsets=8, subset_size=300)
    assert float(mean) == pytest.approx(exact, rel=0.05)
    assert float(std) > 0
    again = tkid.kid(torch.from_numpy(fr), torch.from_numpy(ff), gen,
                     n_subsets=8, subset_size=300)
    assert float(again[0]) == float(mean)  # the same subsets from gen


def test_mmd2_and_kernel_match_jax():
    x, y = _feats(30, 5, 6), _feats(20, 5, 7, 0.5)
    np.testing.assert_allclose(
        tkid.polynomial_kernel(torch.from_numpy(x), torch.from_numpy(y)),
        np.asarray(jkid.polynomial_kernel(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-6)
    assert float(tkid.mmd2_unbiased(torch.from_numpy(x),
                                    torch.from_numpy(y))) == pytest.approx(
        float(jkid.mmd2_unbiased(jnp.asarray(x), jnp.asarray(y))), rel=1e-5)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_precision_recall_matches_jax(k):
    real, fake = _feats(200, 10, 8), _feats(150, 10, 9, 0.4) * 1.3
    got = tprd.precision_recall(torch.from_numpy(real),
                                torch.from_numpy(fake), k=k)
    want = jprd.precision_recall(jnp.asarray(real), jnp.asarray(fake), k=k)
    for name in ("precision", "recall"):
        assert float(got[name]) == pytest.approx(float(want[name]),
                                                 rel=1e-6)
        assert 0.0 < float(got[name]) < 1.0
    np.testing.assert_allclose(
        tprd.knn_radii(torch.from_numpy(real), k).numpy(),
        np.asarray(jprd.knn_radii(jnp.asarray(real), k)), rtol=1e-5)


def test_precision_recall_refuses_tiny_pools():
    with pytest.raises(ValueError, match="needs > k=3 points"):
        tprd.precision_recall(torch.zeros(3, 4), torch.zeros(10, 4))
    d = tprd._sq_dists(torch.ones(2, 3), torch.ones(4, 3))
    assert d.shape == (2, 4) and float(d.min()) == 0.0  # clamped at 0
