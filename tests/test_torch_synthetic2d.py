"""Parity of the port's 2D mixtures (``data/synthetic2d.py``) and 2D metrics
(``evals/metrics2d.py``) with the JAX package's.

Means and weights are built the same way in float64 and cast, so they must
be equal. log-density and the metrics are held at atol 1e-6 on the same
samples and weights (float32, sums in another order). The two packages draw
from different generators, so ``sample_mixture`` is held to the mixture
itself: mode frequencies by a chi-square bound, the noise by its std.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.data.synthetic2d import (
    log_density,
    make_mixture,
    sample_mixture,
)
from collaborative_gan_sampling_torch.evals.metrics2d import (
    metrics_2d,
    mode_assignments,
)
from collaborative_gan_sampling_tpu.data.synthetic2d import (
    log_density as jax_log_density,
    make_mixture as jax_make_mixture,
)
from collaborative_gan_sampling_tpu.evals.metrics2d import (
    metrics_2d as jax_metrics_2d,
    mode_assignments as jax_mode_assignments,
)

NAMES = ("ring8", "ring8_imbalanced", "grid25")
ATOL = 1e-6


def _specs(name, radius=2.0, std=0.1):
    return (make_mixture(name, radius, std, device="cpu"),
            jax_make_mixture(name, radius, std))


def _near_modes(spec, n, seed, spread=2.0):
    """Points around the modes (a few stds out), where log-densities and
    distances are O(1)."""
    rng = np.random.default_rng(seed)
    means = spec.means.numpy()
    idx = rng.integers(0, means.shape[0], n)
    return (means[idx] + spread * spec.std * rng.standard_normal((n, 2))
            ).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_means_and_weights_exact(name):
    spec, jspec = _specs(name, radius=1.5, std=0.05)
    np.testing.assert_array_equal(spec.means.numpy(), np.asarray(jspec.means))
    np.testing.assert_array_equal(spec.weights.numpy(),
                                  np.asarray(jspec.weights))
    assert spec.std == jspec.std
    assert spec.weights.dtype == torch.float32
    assert abs(float(spec.weights.sum()) - 1.0) < 1e-6


def test_imbalanced_weights_are_geometric():
    spec, _ = _specs("ring8_imbalanced")
    w = 0.6 ** np.arange(8)
    np.testing.assert_allclose(spec.weights.numpy(), w / w.sum(), rtol=1e-6)


def test_unknown_mixture_raises():
    with pytest.raises(ValueError, match="unknown 2D mixture"):
        make_mixture("ring9", device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_log_density_matches_jax(name):
    spec, jspec = _specs(name)
    x = _near_modes(spec, 500, seed=1)
    got = log_density(spec, torch.from_numpy(x))
    want = jax_log_density(jspec, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_mode_assignments_match_jax(name):
    spec, jspec = _specs(name)
    x = _near_modes(spec, 500, seed=2)
    idx, dist = mode_assignments(torch.from_numpy(x), spec)
    jidx, jdist = jax_mode_assignments(jnp.asarray(x), jspec)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("weighted", [False, True], ids=["all", "mask"])
def test_metrics_match_jax(name, weighted):
    spec, jspec = _specs(name)
    rng = np.random.default_rng(3)
    # Most points near the modes, some far off (not HQ), modes unevenly hit.
    x = np.concatenate([_near_modes(spec, 400, seed=4, spread=3.0),
                        rng.uniform(-3, 3, (100, 2)).astype(np.float32)])
    w = (rng.uniform(size=500) < 0.6).astype(np.float32) if weighted else None
    got = metrics_2d(torch.from_numpy(x), spec, hq_std=4.0,
                     weights=None if w is None else torch.from_numpy(w))
    want = jax_metrics_2d(jnp.asarray(x), jspec, hq_std=4.0,
                          weights=None if w is None else jnp.asarray(w))
    assert set(got) == set(want) == {"pct_hq", "kl", "modes_covered"}
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=ATOL,
                                   err_msg=k)


def test_metrics_constructed_cases():
    spec, _ = _specs("ring8")
    means = spec.means
    # 3 points at modes (HQ), 1 at the origin (20 stds out): 75% HQ.
    m = metrics_2d(torch.cat([means[:3], torch.zeros(1, 2)]), spec)
    assert float(m["pct_hq"]) == pytest.approx(0.75)
    # One mode only: KL(delta || uniform 8) = log 8, one mode covered.
    m = metrics_2d(means[:1].repeat(1000, 1), spec)
    assert float(m["kl"]) == pytest.approx(np.log(8), rel=0.01)
    assert float(m["modes_covered"]) == 1.0
    # Weight-matched samples: KL ~ 0, all modes covered.
    m = metrics_2d(means.repeat_interleave(125, dim=0), spec)
    assert float(m["kl"]) < 1e-3 and float(m["modes_covered"]) == 8.0
    # No HQ sample at all: the 1e-9 floor keeps KL finite.
    m = metrics_2d(torch.full((10, 2), 50.0), spec)
    assert float(m["pct_hq"]) == 0.0 and np.isfinite(float(m["kl"]))


@pytest.mark.parametrize("name", ["ring8_imbalanced", "grid25"])
def test_sample_mixture_frequencies(name):
    """Mode frequencies of 200,000 draws against the weights: Pearson's
    chi-square below its 1e-4 upper tail (29.9 for 7 degrees of freedom,
    52.6 for 24), and each mode within 5 binomial sigmas; the offsets from
    the nearest mode have the mixture's std within 1%."""
    spec, _ = _specs(name)
    n = 200_000
    x = sample_mixture(torch.Generator().manual_seed(0), spec, n)
    assert x.shape == (n, 2) and x.dtype == torch.float32
    idx, _ = mode_assignments(x, spec)  # std 0.1 vs spacing >= 1: exact
    counts = torch.bincount(idx, minlength=spec.means.shape[0]).double()
    p = spec.weights.double()
    expected = n * p
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < {8: 29.9, 25: 52.6}[p.numel()], chi2
    sigma = torch.sqrt(n * p * (1 - p))
    assert bool(((counts - expected).abs() < 5 * sigma).all())
    offsets = x - spec.means[idx]
    assert abs(float(offsets.std()) - spec.std) < 0.01 * spec.std
    assert abs(float(offsets.mean())) < 5 * spec.std / np.sqrt(n)


def test_sample_mixture_draws_from_the_generator():
    spec, _ = _specs("ring8")
    a = sample_mixture(torch.Generator().manual_seed(1), spec, 64)
    b = sample_mixture(torch.Generator().manual_seed(1), spec, 64)
    c = sample_mixture(torch.Generator().manual_seed(2), spec, 64)
    assert torch.equal(a, b) and not torch.equal(a, c)
