"""Parity of the port's MH-GAN (``sampling/mh.py`` and
``sample(..., method="mhgan")``) with the JAX package's, at the tiny DCGAN
of ``tests/test_torch_collab.py`` (16x16x1, 8 filters, z = 8), float32.

The port is fed the JAX side's draws by replaying its key splits: the chain
step i of ``mh(..., key, ...)`` splits ``fold_in(key, i)`` into (k_z, k_u)
and draws z from ``normal(k_z)``, then u from ``uniform(k_u)``; ``sample``
splits its key into (k_cal, k_init, k_chain), draws the calibration's real
batch from ``split(k_cal)[0]`` and its G batch from ``split(k_cal)[1]``,
and round i's chain init and chain key from ``split(fold_in(k_chain, i))``.

Tolerances: Platt's (a, b) atol 1e-5 (200 float32 descent steps on the same
logits); samples, scores and logits atol 1e-4, as the collab test. The
accept decisions and counts must be equal: no u here lies within float32
rounding of its acceptance probability.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.config import RefineConfig as TRefineConfig
from collaborative_gan_sampling_torch.sampling import mh as t_mh
from collaborative_gan_sampling_torch.sampling.collab import sample as t_sample
from collaborative_gan_sampling_torch.sampling.mh import (
    calibrated_score as t_calibrated_score,
    fit_platt as t_fit_platt,
    make_mh_sampler as t_make_mh_sampler,
)
from collaborative_gan_sampling_torch.utils.weights import load_jax_variables
from collaborative_gan_sampling_tpu.config import RefineConfig
from collaborative_gan_sampling_tpu.sampling import sample
from collaborative_gan_sampling_tpu.sampling.mh import (
    calibrated_score,
    fit_platt,
    make_mh_sampler,
)
from tests.test_torch_collab import _data_fn
from tests.test_torch_models import TINY, make_pair

B, CHAIN = 8, 4


@pytest.fixture(scope="module")
def tiny_pair():
    """The tiny pair with G's kernels scaled up (at the DCGAN init its
    samples are nearly constant) and D's head scaled up and recentred on
    G's samples, so that D's scores spread around 0.5 without saturating
    and the chains both take and refuse proposals."""
    jb, tb, g_vars, d_vars, g, d = make_pair(TINY, seed=71)
    for p in g_vars["params"].values():
        if "kernel" in p:
            p["kernel"] = p["kernel"] * 30
    out = d_vars["params"]["out"]
    out["kernel"] = out["kernel"] * 100
    z = jax.random.normal(jax.random.PRNGKey(0), (256, jb.z_dim))
    logits = jb.discriminate(d_vars, jb.generate(g_vars, z, None), None)
    out["bias"] = out["bias"] - np.float32(np.mean(np.asarray(logits)))
    load_jax_variables(g, g_vars)
    load_jax_variables(d, d_vars)
    return jb, tb, g_vars, d_vars, g, d


def _inject(monkeypatch, tb, zs, us):
    monkeypatch.setattr(type(tb), "sample_z",
                        lambda self, gen, n: torch.from_numpy(zs.pop(0)))
    monkeypatch.setattr(t_mh, "_uniform",
                        lambda gen, n, device: torch.from_numpy(us.pop(0)))


def _chain_draws(key, z_dim, steps=CHAIN):
    zs, us = [], []
    for i in range(steps):
        k_z, k_u = jax.random.split(jax.random.fold_in(key, i))
        zs.append(np.array(jax.random.normal(k_z, (B, z_dim),
                                             dtype=jnp.float32)))
        us.append(np.array(jax.random.uniform(k_u, (B,))))
    return zs, us


@pytest.mark.parametrize("spread", [1.0, 30.0])
def test_fit_platt_matches_jax(spread):
    rng = np.random.default_rng(int(spread))
    real = (spread * (rng.standard_normal(64) + 0.8)).astype(np.float32)
    fake = (spread * (rng.standard_normal(48) - 0.5)).astype(np.float32)
    a_want, b_want = fit_platt(jnp.asarray(real), jnp.asarray(fake))
    a_got, b_got = t_fit_platt(torch.from_numpy(real), torch.from_numpy(fake))
    np.testing.assert_allclose(float(a_got), float(a_want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(b_got), float(b_want), atol=1e-5)
    assert float(a_got) > 0  # real scores above fake ones
    lg = rng.standard_normal(5).astype(np.float32) * spread
    np.testing.assert_allclose(
        t_calibrated_score(torch.from_numpy(lg), a_got, b_got).numpy(),
        np.asarray(calibrated_score(jnp.asarray(lg), a_want, b_want)),
        atol=1e-5)


def test_chain_matches_jax(tiny_pair, monkeypatch):
    jb, tb, g_vars, d_vars, g, d = tiny_pair
    x_init = np.random.default_rng(2).uniform(-1, 1, (B, 16, 16, 1)).astype(
        np.float32)
    a, b = 5.0, -0.2
    key = jax.random.PRNGKey(3)
    x_want, aux_want = make_mh_sampler(jb, CHAIN)(
        d_vars, g_vars, key, jnp.asarray(x_init), None, jnp.float32(a),
        jnp.float32(b))
    zs, us = _chain_draws(key, jb.z_dim)
    _inject(monkeypatch, tb, zs, us)
    x_got, aux = t_make_mh_sampler(tb, CHAIN)(
        d, g, None, torch.from_numpy(x_init), None, torch.tensor(a),
        torch.tensor(b))
    assert not zs and not us  # every draw was consumed
    n_acc = aux["n_accepts"].numpy()
    np.testing.assert_array_equal(n_acc, np.asarray(aux_want["n_accepts"]))
    assert 0 < n_acc.sum() < B * CHAIN  # chains took and refused proposals
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want), atol=1e-4)
    np.testing.assert_allclose(aux["score"].numpy(),
                               np.asarray(aux_want["score"]), atol=1e-4)
    assert float(aux["accept_rate"]) == pytest.approx(
        float(aux_want["accept_rate"]))


def _sample_draws(key, cfg, z_dim):
    """The z, u and real batches JAX's mhgan run draws, in call order."""
    k_cal, _, k_chain = jax.random.split(key, 3)
    k_r, k_f = jax.random.split(k_cal)
    reals = [np.array(_data_fn(k_r, B)[0])]
    zs = [np.array(jax.random.normal(jax.random.split(k_f)[0], (B, z_dim),
                                     dtype=jnp.float32))]
    us = []
    for i in range(cfg.num_batches):
        k_i, k_c = jax.random.split(jax.random.fold_in(k_chain, i))
        reals.append(np.array(_data_fn(k_i, B)[0]))
        z, u = _chain_draws(k_c, z_dim, cfg.mh_chain_len)
        zs += z
        us += u
    return zs, us, reals


def test_sample_mhgan_matches_jax(tiny_pair, monkeypatch):
    jb, tb, g_vars, d_vars, g, d = tiny_pair
    kw = dict(num_batches=2, batch_size=B, mh_chain_len=2)
    key = jax.random.PRNGKey(1)
    jcfg = RefineConfig(**kw)
    want = sample(jb, g_vars, d_vars, jcfg, key, method="mhgan",
                  data_fn=_data_fn)
    zs, us, reals = _sample_draws(key, jcfg, jb.z_dim)
    _inject(monkeypatch, tb, zs, us)
    got = t_sample(tb, g, d, TRefineConfig(**kw), None, method="mhgan",
                   data_fn=lambda gen, n: (torch.from_numpy(reals.pop(0)),
                                           None))
    assert not zs and not us and not reals
    assert got.samples.shape == (2 * B, 16, 16, 1) and got.labels is None
    np.testing.assert_array_equal(got.accepted.numpy(),
                                  np.asarray(want.accepted))
    np.testing.assert_allclose(got.samples.numpy(), np.asarray(want.samples),
                               atol=1e-4)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=1e-4)
    for k in ("platt_a", "platt_b"):
        np.testing.assert_allclose(float(got.aux[k]), float(want.aux[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ("mh_accept_rate", "mh_never_accepted"):
        assert float(got.aux[k]) == pytest.approx(float(want.aux[k])), k
    assert 0 < float(got.aux["mh_accept_rate"]) < 1
    assert 0 < float(got.aux["mh_never_accepted"]) < 1  # the guard acted


@pytest.mark.parametrize("with_data", [True, False],
                         ids=["real_init", "g_init"])
def test_leak_guard(tiny_pair, monkeypatch, with_data):
    """Chains that never accept keep their initializer: with real-data init
    they are rejected (no training image leaks out), with G init they are
    generator samples and stay accepted. Here u = 1 refuses every proposal
    of the even chains and u = 0 takes every proposal of the odd ones."""
    _, tb, _, _, g, d = tiny_pair
    u = np.where(np.arange(B) % 2 == 0, 1.0, 0.0).astype(np.float32)
    monkeypatch.setattr(t_mh, "_uniform",
                        lambda gen, n, device: torch.from_numpy(u))
    real = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (B, 16, 16, 1)).astype(np.float32))
    cfg = TRefineConfig(num_batches=1, batch_size=B, mh_chain_len=3)
    gen = torch.Generator().manual_seed(0)
    res = t_sample(tb, g, d, cfg, gen, method="mhgan",
                   data_fn=(lambda gen, n: (real, None)) if with_data
                   else None)
    refused = np.arange(B) % 2 == 0
    assert float(res.aux["mh_never_accepted"]) == pytest.approx(0.5)
    assert float(res.aux["mh_accept_rate"]) == pytest.approx(0.5)
    if with_data:
        np.testing.assert_array_equal(res.accepted.numpy(), ~refused)
        # The refused chains still hold the real images; none is emitted.
        torch.testing.assert_close(res.samples[refused], real[refused],
                                   rtol=0, atol=0)
        assert not bool((res.accepted_samples()[:, None]
                         == real[None]).flatten(2).all(-1).any())
    else:
        assert bool(res.accepted.all())
        assert float(res.aux["platt_a"]) == 1.0
        assert float(res.aux["platt_b"]) == 0.0
