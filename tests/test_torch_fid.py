"""The port's FID linear algebra against the JAX package's and scipy's:
matrix square roots, moments (exact and streamed over the same batches),
both Frechet paths, the float64 host distance, the stats files across the
two packages, and intra-FID.

Tolerances: float32 square roots and traces against float64 scipy at
rtol 1e-3 (Newton-Schulz at 30 iterations and eigh both leave ~1e-4 of the
trace); port against JAX in float32 at rtol 1e-5 on moments (the same sums
in another order) and 1e-4 on the distances (an eigh in another library);
the float64 host distance at rtol 1e-9 (both are numpy on the same
float32 stats).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from collaborative_gan_sampling_torch.evals import fid as tfid
from collaborative_gan_sampling_torch.ops import sqrtm as tsq
from collaborative_gan_sampling_torch.utils.prng import fold_generator
from collaborative_gan_sampling_tpu.evals import fid as jfid
from collaborative_gan_sampling_tpu.ops import sqrtm as jsq


def _psd(n, rank, seed):
    a = np.random.default_rng(seed).standard_normal((n, rank))
    return (a @ a.T / rank).astype(np.float32)


def _feats(n, f, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((f, f)) / np.sqrt(f)
    return (rng.standard_normal((n, f)) @ mix + shift).astype(np.float32)


def _j_stats(s: tfid.FIDStats) -> jfid.FIDStats:
    return jfid.FIDStats(*(jnp.asarray(t.numpy()) for t in s))


def _t_stats(s: jfid.FIDStats) -> tfid.FIDStats:
    return tfid.FIDStats(*(torch.from_numpy(np.array(t)) for t in s))


@pytest.mark.parametrize("rank", [32, 12], ids=["full", "rank12"])
def test_trace_sqrtm_product_against_scipy_and_jax(rank):
    s1, s2 = _psd(32, rank, 1), _psd(32, rank, 2)
    want = float(np.trace(scipy.linalg.sqrtm(
        s1.astype(np.float64) @ s2.astype(np.float64))).real)
    t1, t2 = torch.from_numpy(s1), torch.from_numpy(s2)
    eig = float(tsq.trace_sqrtm_product_eigh(t1, t2))
    assert eig == pytest.approx(want, rel=1e-3)
    # Rank-deficient: the clipped noise eigenvalues' square roots differ
    # between the two eigh implementations (~6e-5 of the trace).
    assert eig == pytest.approx(float(jsq.trace_sqrtm_product_eigh(
        jnp.asarray(s1), jnp.asarray(s2))), rel=1e-5 if rank == 32 else 1e-4)
    # A rank-deficient product needs FID-backprop's jitter (eps 1e-3) to
    # stay in Newton-Schulz's region, which biases the trace (here by 4%:
    # each of the 20 null directions gains the root of the jitter).
    eps, rel = (1e-6, 1e-3) if rank == 32 else (1e-3, 0.1)
    ns = float(tsq.trace_sqrtm_product(t1, t2, eps=eps))
    assert ns == pytest.approx(want, rel=rel)
    assert ns == pytest.approx(float(jsq.trace_sqrtm_product(
        jnp.asarray(s1), jnp.asarray(s2), eps=eps)), rel=1e-4)


@pytest.mark.parametrize("rank", [24, 6], ids=["full", "rank6"])
def test_matrix_square_roots(rank):
    s = _psd(24, rank, 3)
    want = scipy.linalg.sqrtm(s.astype(np.float64)).real
    got = tsq.psd_sqrt_eigh(torch.from_numpy(s)).numpy()
    # The clipped noise eigenvalues (~1e-7 of the largest) of a rank-
    # deficient float32 matrix leave square roots of ~3e-4 of its scale.
    atol = (1e-5 if rank == 24 else 2e-3) * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=max(atol, 2e-4))
    np.testing.assert_allclose(
        got, np.asarray(jsq.psd_sqrt_eigh(jnp.asarray(s))), atol=atol)
    if rank == 24:  # Newton-Schulz's domain: well-conditioned PSD
        ns = tsq.sqrtm_newton_schulz(torch.from_numpy(s), 30).numpy()
        np.testing.assert_allclose(ns, want, atol=1e-3 * np.abs(want).max())
        np.testing.assert_allclose(ns, np.asarray(jsq.sqrtm_newton_schulz(
            jnp.asarray(s), 30)), atol=1e-5)


def test_stats_from_features_matches_jax():
    f = _feats(300, 16, 4, shift=5.0)
    got = tfid.stats_from_features(torch.from_numpy(f))
    want = jfid.stats_from_features(jnp.asarray(f))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(got.sigma.numpy(),
                               np.cov(f.astype(np.float64), rowvar=False),
                               rtol=1e-4, atol=1e-5)


def test_streaming_stats_matches_jax_on_the_same_batches():
    """The same feature function and the same batches on both sides: the
    JAX batch i is drawn from fold_in(key, i), the port's from
    fold_generator(generator, i), each mapped to the same numpy batch."""
    nb, bs, f = 5, 40, 12
    batches = [_feats(bs, f, 10 + i, shift=30.0) for i in range(nb)]
    key = jax.random.PRNGKey(0)
    keys = [np.asarray(jax.random.key_data(jax.random.fold_in(key, i)))
            .tobytes() for i in range(nb)]

    def j_batch(k, n):  # the key picks its batch among the nb of them
        kd = jax.random.key_data(k)
        sel = jnp.stack([jnp.all(kd == jnp.frombuffer(b, jnp.uint32))
                         for b in keys])
        return jnp.asarray(np.stack(batches))[jnp.argmax(sel)]

    want = jfid.streaming_stats(lambda x: x, j_batch, nb, bs, key)
    gen = torch.Generator().manual_seed(7)
    seeds = [fold_generator(gen, i).initial_seed() for i in range(nb)]
    got = tfid.streaming_stats(
        lambda x: x, lambda g, n: torch.from_numpy(
            batches[seeds.index(g.initial_seed())]), nb, bs, gen)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    exact = tfid.stats_from_features(torch.from_numpy(np.concatenate(
        batches)))
    np.testing.assert_allclose(got.sigma.numpy(), exact.sigma.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("ns_iters", [0, 30], ids=["eigh", "newton_schulz"])
def test_frechet_distance_matches_jax_and_host(ns_iters):
    a = tfid.stats_from_features(torch.from_numpy(_feats(400, 16, 5)))
    b = tfid.stats_from_features(torch.from_numpy(_feats(400, 16, 6, 0.3)))
    got = float(tfid.frechet_distance(a, b, ns_iters))
    want = float(jfid.frechet_distance(_j_stats(a), _j_stats(b), ns_iters))
    host = tfid.frechet_distance_host(a, b)
    assert got == pytest.approx(want, rel=1e-4)
    assert got == pytest.approx(host, rel=1e-3)
    assert host == pytest.approx(
        jfid.frechet_distance_host(_j_stats(a), _j_stats(b)), rel=1e-9)


def test_frechet_distance_host_inf_on_non_finite_moments():
    a = tfid.stats_from_features(torch.from_numpy(_feats(50, 4, 7)))
    bad = tfid.FIDStats(a.mu.clone().fill_(float("nan")), a.sigma, a.n)
    assert tfid.frechet_distance_host(bad, a) == float("inf")
    assert tfid.frechet_distance_host(a, a) == pytest.approx(0.0, abs=1e-9)


def test_stats_files_cross_both_ways(tmp_path):
    a = tfid.stats_from_features(torch.from_numpy(_feats(60, 8, 8)))
    port_file, jax_file = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    tfid.save_stats(port_file, a, feature_net="torch/trained_classifier")
    got, label = jfid.load_stats(port_file)
    assert label == "torch/trained_classifier"
    for g, w in zip(got, a):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
    jfid.save_stats(jax_file, _j_stats(a), feature_net="trained_classifier")
    back, label = tfid.load_stats(jax_file)
    assert label == "trained_classifier"
    for g, w in zip(back, a):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    # pytorch-fid's keys; no label.
    other = str(tmp_path / "o.npz")
    np.savez(other, mean=a.mu.numpy(), cov=a.sigma.numpy())
    st, label = tfid.load_stats(other)
    assert label == "" and float(st.n) == 0.0
    np.savez(other, mu=a.mu.numpy())
    with pytest.raises(ValueError, match="not a FID-stats npz"):
        tfid.load_stats(other)
    np.savez(other, mu=a.mu.numpy(), sigma=a.sigma.numpy()[:3])
    with pytest.raises(ValueError, match="inconsistent stats shapes"):
        tfid.load_stats(other)


@pytest.mark.parametrize("kw", [{}, {"max_classes": 2},
                                {"classes": [0, 2]}, {"min_count": 200}],
                         ids=["all", "top2", "given", "too_few"])
def test_per_class_fid_matches_jax(kw):
    rng = np.random.default_rng(9)
    fr, ff = _feats(600, 6, 10), _feats(500, 6, 11, 0.2)
    lr = rng.integers(0, 4, 600)
    lf = rng.choice(4, 500, p=[0.4, 0.3, 0.2, 0.1])
    got = tfid.per_class_fid(torch.from_numpy(fr), torch.from_numpy(lr),
                             torch.from_numpy(ff), torch.from_numpy(lf), **kw)
    want = jfid.per_class_fid(fr, lr, ff, lf, **kw)
    assert got["intra_fid_classes"] == want["intra_fid_classes"]
    assert set(got["per_class"]) == set(want["per_class"])
    for c, v in want["per_class"].items():
        assert got["per_class"][c] == pytest.approx(v, rel=1e-9)
    assert got["intra_fid"] == pytest.approx(want["intra_fid"], rel=1e-9)


def test_intersection_intra_fid_matches_jax():
    tables = {"standard": {"0": 1.0, "1": 2.0, "2": 3.0},
              "collab": {0: 0.5, 2: 1.5}}
    assert tfid.intersection_intra_fid(tables) == \
        jfid.intersection_intra_fid(tables)
    assert tfid.intersection_intra_fid({"a": {0: 1.0}, "b": {1: 2.0}}) == \
        jfid.intersection_intra_fid({"a": {0: 1.0}, "b": {1: 2.0}})


def test_fid_between_orders_samplers():
    """Two samplers from one distribution score near 0, a shifted one far
    from it, on the device path (Newton-Schulz)."""
    def sampler(shift):
        return lambda g, n: torch.randn(n, 8, generator=g) + shift

    gen = torch.Generator().manual_seed(3)
    same = float(tfid.fid_between(lambda x: x, sampler(0.0), sampler(0.0),
                                  2000, 500, gen))
    far = float(tfid.fid_between(lambda x: x, sampler(0.0), sampler(1.0),
                                 2000, 500, gen))
    assert 0.0 <= same < 0.1 and far == pytest.approx(8.0, rel=0.1)
