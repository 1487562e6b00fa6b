"""The port's serving sampler (``sampling/serve.py``): the unconditional
cases of tests/test_serve.py, plus ``calibrate`` and ``round`` against the
JAX ``ServingSampler`` with its z and uniforms injected.

Tolerances: samples, logits and M at atol 1e-5 (float32 refinement of a
small MLP, sums in another order); accept masks equal (no u lies within
float32 rounding of its acceptance probability here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.config import RefineConfig as TRefineConfig
from collaborative_gan_sampling_torch.data.images import denormalize_images
from collaborative_gan_sampling_torch.sampling import serve as t_serve
from collaborative_gan_sampling_torch.sampling.serve import (
    SERVING_METHODS as T_METHODS,
    ServingSampler as TServingSampler,
)
from collaborative_gan_sampling_tpu.config import RefineConfig
from collaborative_gan_sampling_tpu.data.images import (
    denormalize_images as jax_denormalize_images,
)
from collaborative_gan_sampling_tpu.sampling.serve import (
    SERVING_METHODS,
    ServingSampler,
)
from tests.test_torch_mlp import SMALL
from tests.test_torch_models import TINY, make_pair

ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    return make_pair(SMALL, seed=40)


def _cfg(**kw):
    base = dict(steps=2, rate=0.05, num_batches=3, batch_size=32, burn_in=64,
                use_pallas=False)
    base.update(kw)
    return TRefineConfig(**base)


def test_methods_are_the_jax_methods():
    assert T_METHODS == SERVING_METHODS


@pytest.mark.parametrize("method", T_METHODS)
def test_round_shapes_and_accept_semantics(pair, method):
    _, tb, _, _, g, d = pair
    srv = TServingSampler(tb, _cfg(), method=method)
    gen = torch.Generator().manual_seed(1)
    m = srv.calibrate(g, d, gen)
    x, labels, acc, logits = srv.round(g, d, m, gen)
    assert x.shape == (96, 2) and acc.shape == (96,) and logits.shape == (96,)
    assert labels is None and acc.dtype == torch.bool
    if method in ("standard", "refinement"):
        assert bool(acc.all())  # accept-all methods
        assert float(m) == 0.0
    else:
        assert 0 < int(acc.sum()) < 96  # DRS actually selects


def test_generate_returns_exactly_n_deterministically(pair):
    _, tb, _, _, g, d = pair
    srv = TServingSampler(tb, _cfg(num_batches=2), method="reject")
    s1, lab1, stats = srv.generate(g, d, torch.Generator().manual_seed(3),
                                   n=150)
    s2, _, _ = srv.generate(g, d, torch.Generator().manual_seed(3), n=150)
    assert s1.shape == (150, 2) and s1.dtype == torch.float32
    assert lab1 is None and s1.device.type == "cpu"
    assert torch.equal(s1, s2)
    assert stats["rounds"] >= 2  # needed several rounds
    assert 0 < stats["accept_rate"] < 1
    assert stats["samples_per_sec"] > 0
    assert stats["warmup_samples"] > 0  # the first round's samples are kept
    assert stats["candidates"] == stats["rounds"] * 64
    assert stats["dtype"] == "float32" and stats["method"] == "reject"
    assert set(stats) == {"n", "rounds", "candidates", "accept_rate",
                          "overflow_dropped", "seconds", "samples_per_sec",
                          "warmup_samples", "dtype", "method"}


def test_generate_images_quantized():
    """An image model serves uint8 samples, exactly n of them."""
    _, tb, _, _, g, d = make_pair(TINY, seed=41)
    srv = TServingSampler(tb, _cfg(num_batches=1, batch_size=16, burn_in=16),
                          method="collab")
    samples, labels, stats = srv.generate(
        g, d, torch.Generator().manual_seed(4), n=40)
    assert samples.shape == (40, 16, 16, 1) and labels is None
    assert samples.dtype == torch.uint8 and stats["dtype"] == "uint8"
    raw, _, _ = srv.generate(g, d, torch.Generator().manual_seed(4), n=40,
                             quantize_images=False)
    assert raw.dtype == torch.float32
    assert torch.equal(denormalize_images(raw), samples)


def test_compact_quantization_rounds_like_denormalize():
    """Served uint8 pixels match the canonical transform (round, not a
    truncating cast): x = 0.0 is 128, not 127."""
    x = torch.stack([torch.full((2, 2, 1), v) for v in
                     (0.0, -1.0, 1.0, 0.5, -0.25, 0.999)])
    acc = torch.tensor([True, True, True, True, False, False])
    x_sel, lab, count = TServingSampler.compact(x, None, acc, cap=4,
                                                quantize=True)
    assert count == 4 and x_sel.shape == (4, 2, 2, 1) and lab is None
    np.testing.assert_array_equal(
        x_sel.numpy(), np.asarray(jax_denormalize_images(jnp.asarray(
            x[:4].numpy()))))
    assert int(x_sel[0, 0, 0, 0]) == 128  # round, not truncate
    # cap below the accepted count keeps the first `cap` accepted rows,
    # and their labels
    x_sel, lab, count = TServingSampler.compact(
        x, torch.arange(6) * 10, acc, cap=2, quantize=False)
    assert count == 2 and torch.equal(x_sel, x[:2])
    assert lab.tolist() == [0, 10]


def test_denormalize_matches_jax():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-1.2, 1.2, 997),
                        (np.arange(-3, 260) + 0.5) / 127.5 - 1.0]
                       ).astype(np.float32)
    got = denormalize_images(torch.from_numpy(x))
    want = jax_denormalize_images(jnp.asarray(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_raises_when_acceptance_starves(pair):
    _, tb, _, _, g, d = pair
    # gamma so large nothing is ever accepted: a clear, fast error.
    cfg = _cfg(steps=0, rate=0.0, num_batches=1, batch_size=16, burn_in=16,
               gamma=1e6, gamma_percentile=0.0)
    srv = TServingSampler(tb, cfg, method="reject")
    with pytest.raises(RuntimeError, match="accept rate too low"):
        srv.generate(g, d, torch.Generator().manual_seed(0), n=32,
                     max_rounds=3)


def test_serving_rejects_unknown_method(pair):
    with pytest.raises(ValueError, match="serving supports"):
        TServingSampler(pair[1], TRefineConfig(), method="mhgan")


def test_class_conditional_serving_not_ported(pair):
    """Class-conditional serving, ported: a conditional pair served with
    class_id gives samples of that class only, with their labels; class_id
    on the unconditional pair is refused."""
    from tests.test_torch_conditional import make_cond_pair

    _, tb, _, _, g, d = make_cond_pair(seed=42)
    srv = TServingSampler(tb, _cfg(num_batches=1, batch_size=16, burn_in=16),
                          method="reject", class_id=0)
    x, labels, _ = srv.generate(g, d, torch.Generator().manual_seed(2), n=24)
    assert x.shape == (24, 16, 16, 3) and labels.tolist() == [0] * 24
    with pytest.raises(ValueError, match="needs a conditional model"):
        TServingSampler(pair[1], TRefineConfig(), class_id=0)


def _replay(key, cfg, z_dim, calibrate):
    """The z and u draws of JAX's calibrate (burn round i: z from
    split(fold_in(key, i))[0]) or round (batch i: k_draw, k_acc =
    split(fold_in(key, i)); z from split(k_draw)[0], u from
    uniform(k_acc))."""
    zs, us = [], []

    def z_of(k):
        return np.array(jax.random.normal(jax.random.split(k)[0],
                                          (cfg.batch_size, z_dim)))

    if calibrate:
        for i in range(max(1, cfg.burn_in // cfg.batch_size)):
            zs.append(z_of(jax.random.fold_in(key, i)))
        return zs, us
    for i in range(cfg.num_batches):
        k_draw, k_acc = jax.random.split(jax.random.fold_in(key, i))
        zs.append(z_of(k_draw))
        us.append(np.array(jax.random.uniform(k_acc, (cfg.batch_size,))))
    return zs, us


@pytest.mark.parametrize("method,use_pallas", [
    ("standard", False), ("refinement", False), ("refinement", True),
    ("reject", False), ("reject", True), ("collab", False), ("collab", True),
])
def test_calibrate_and_round_match_jax(pair, method, use_pallas,
                                       monkeypatch):
    jb, tb, g_vars, d_vars, g, d = pair
    kw = dict(steps=2, rate=0.05, num_batches=3, batch_size=32, burn_in=64,
              use_pallas=use_pallas)
    jsrv = ServingSampler(jb, RefineConfig(**kw), method=method)
    k_cal, k_round = jax.random.PRNGKey(6), jax.random.PRNGKey(7)
    m_want = jsrv.calibrate(g_vars, d_vars, k_cal)
    x_want, _, acc_want, lg_want = jsrv.round(g_vars, d_vars, m_want,
                                              k_round)

    cfg = RefineConfig(**kw)
    zs, _ = _replay(k_cal, cfg, jb.z_dim, calibrate=True)
    zs2, us = _replay(k_round, cfg, jb.z_dim, calibrate=False)
    if method in ("standard", "refinement"):
        zs = []  # accept-all methods skip the burn-in
    zs += zs2
    monkeypatch.setattr(type(tb), "sample_z",
                        lambda self, gen, n: torch.from_numpy(zs.pop(0)))
    real_accept = t_serve.drs_accept_mask

    def accept_with_u(gen, logits, *args, **kw):
        return real_accept(gen, logits, *args,
                           uniforms=torch.from_numpy(us.pop(0)), **kw)

    monkeypatch.setattr(t_serve, "drs_accept_mask", accept_with_u)
    tsrv = TServingSampler(tb, TRefineConfig(**kw), method=method)
    m_got = tsrv.calibrate(g, d, None)
    x_got, labels, acc_got, lg_got = tsrv.round(g, d, m_got, None)
    assert not zs and (not us or method in ("standard", "refinement"))
    assert labels is None
    np.testing.assert_allclose(float(m_got), float(m_want), atol=ATOL)
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want), atol=ATOL)
    np.testing.assert_allclose(lg_got.numpy(), np.asarray(lg_want),
                               atol=ATOL)
    np.testing.assert_array_equal(acc_got.numpy(), np.asarray(acc_want))
