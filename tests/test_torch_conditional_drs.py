"""Parity of the port's per-class DRS and class-balanced real draws with the
JAX package's: ``estimate_logit_max_per_class`` (a scatter-max with the
global max for classes never drawn), the per-class fold ``logits -
M[labels]`` with M = 0 against the unfolded shift, per-class ``reject``
sampling end to end on injected draws, and ``ImageDataset.batch_by_labels``
on JAX's own ``r``.

Tolerances: M exact up to float32 rounding of the logits (atol 1e-5, the
forward's); the shift rtol 1e-6 (test_torch_rejection.py's); images to one
float32 ulp (the same uint8 gathered; JAX's jitted normalisation multiplies
by 1 / 127.5 where the port divides); accept masks equal (no u here lies
within 1e-6 of its acceptance probability).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.config import RefineConfig as TRefineConfig
from collaborative_gan_sampling_torch.data.images import (
    ImageDataset as TImageDataset,
)
from collaborative_gan_sampling_torch.sampling import collab as t_collab
from collaborative_gan_sampling_torch.sampling import rejection as t_rej
from collaborative_gan_sampling_torch.sampling.collab import sample as t_sample
from collaborative_gan_sampling_tpu.config import RefineConfig
from collaborative_gan_sampling_tpu.data.images import ImageDataset
from collaborative_gan_sampling_tpu.sampling import rejection as j_rej
from collaborative_gan_sampling_tpu.sampling import sample
from tests.test_torch_conditional import (  # noqa: F401 (a fixture)
    _t,
    make_cond_pair,
    one_torch_thread,
)

B = 4


def _uniform_x(key, n, shape):
    return jax.random.uniform(key, (n, *shape), minval=-1.0, maxval=1.0)


@pytest.mark.parametrize("burn_in", [8, 4, 1], ids=["2_batches", "1_batch",
                                                    "below_a_batch"])
def test_estimate_logit_max_per_class(burn_in):
    """At most 8 of the 10 classes are drawn: the rest take the global
    max."""
    jb, tb, _, d_vars, _, d = make_cond_pair(seed=21)
    key = jax.random.PRNGKey(3)

    def j_sample(k, n):
        k_x, k_l = jax.random.split(k)
        return _uniform_x(k_x, n, jb.data_shape), jb.sample_labels(k_l, n)

    want = np.asarray(j_rej.estimate_logit_max_per_class(
        jb, d_vars, j_sample, key, burn_in, B, 10))
    batches = [tuple(np.array(a) for a in j_sample(jax.random.fold_in(key, i),
                                                   B))
               for i in range(max(1, burn_in // B))]
    drawn = {int(c) for _, lab in batches for c in lab}
    it = iter(batches)
    got = t_rej.estimate_logit_max_per_class(
        tb, d, lambda gen, n: tuple(_t(a) for a in next(it)), None, burn_in,
        B).numpy()
    assert next(it, None) is None  # as many batches as JAX drew
    np.testing.assert_allclose(got, want, atol=1e-5)
    never = [c for c in range(10) if c not in drawn]
    assert never and np.all(got[never] == got.max())
    assert len(set(got[sorted(drawn)].tolist())) > 1


def test_class_max_marks_absent_classes():
    lg = torch.tensor([0.5, -1.0, 2.0, 0.25])
    labels = torch.tensor([3, 3, 0, 1])
    got = t_rej.class_max(lg, labels, 5)
    want = jnp.full((5,), -jnp.inf).at[jnp.asarray(labels.numpy())].max(
        jnp.asarray(lg.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gamma,percentile", [(0.0, 0.0), (0.3, 80.0)])
def test_fold_is_the_per_sample_shift(gamma, percentile):
    """drs_logit_shift depends on F - M only: the folded logits with M = 0
    give the shift of each logit under its own class's M, and the same
    acceptance probability as JAX's per-sample M."""
    rng = np.random.default_rng(5)
    lg = (2 * rng.standard_normal(64)).astype(np.float32)
    labels = rng.integers(0, 10, 64)
    m = (lg.max() - rng.uniform(0, 2, 10)).astype(np.float32)
    eff, zero = t_rej.fold_per_class(_t(lg), _t(m), _t(labels))
    assert float(zero) == 0.0 and zero.shape == ()
    want = j_rej.drs_logit_shift(jnp.asarray(lg), jnp.asarray(m[labels]),
                                 gamma)
    got = t_rej.drs_logit_shift(eff, zero, gamma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    p_want = j_rej.drs_acceptance_prob(
        jnp.asarray(lg) - jnp.asarray(m)[jnp.asarray(labels)], 0.0, gamma,
        gamma_percentile=percentile)
    p_got = t_rej.drs_acceptance_prob(eff, zero, gamma,
                                      gamma_percentile=percentile)
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_want), rtol=1e-6,
                               atol=1e-6)


def _replay_reject(jb, key, cfg):
    """The z, labels and u that JAX's reject run draws, in call order:
    burn batch i from split(fold_in(k_burn, i)); main batch i splits
    fold_in(k_main, i) into (k_draw, k_acc), draws from split(k_draw) and
    u from k_acc."""
    k_burn, k_main = jax.random.split(key)
    zs, labels, us = [], [], []

    def draw(k):
        k_z, k_l = jax.random.split(k)
        zs.append(np.array(jb.sample_z(k_z, cfg.batch_size)))
        labels.append(np.array(jb.sample_labels(k_l, cfg.batch_size)))

    for i in range(max(1, cfg.burn_in // cfg.batch_size)):
        draw(jax.random.fold_in(k_burn, i))
    for i in range(cfg.num_batches):
        k_draw, k_acc = jax.random.split(jax.random.fold_in(k_main, i))
        draw(k_draw)
        us.append(np.array(jax.random.uniform(k_acc, (cfg.batch_size,))))
    return zs, labels, us


def inject(monkeypatch, tb, module, zs, labels, us):
    """The port's z, label and uniform draws replaced by JAX's, in order."""
    monkeypatch.setattr(type(tb), "sample_z",
                        lambda self, gen, n: _t(zs.pop(0)))
    monkeypatch.setattr(type(tb), "sample_labels",
                        lambda self, gen, n: _t(labels.pop(0)))
    real = module.drs_accept_mask

    def accept_with_u(gen, logits, *args, **kw):
        return real(gen, logits, *args, uniforms=_t(us.pop(0)), **kw)

    monkeypatch.setattr(module, "drs_accept_mask", accept_with_u)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["torch_draw", "kernel_entry"])
def test_per_class_reject_matches_jax(use_pallas, monkeypatch):
    jb, tb, g_vars, d_vars, g, d = make_cond_pair(seed=23)
    kw = dict(num_batches=3, batch_size=8, burn_in=16, per_class_drs=True,
              use_pallas=use_pallas)
    key = jax.random.PRNGKey(9)
    want = sample(jb, g_vars, d_vars, RefineConfig(**kw), key,
                  method="reject")
    zs, labels, us = _replay_reject(jb, key, RefineConfig(**kw))
    inject(monkeypatch, tb, t_collab, zs, labels, us)
    got = t_sample(tb, g, d, TRefineConfig(**kw), None, method="reject")
    assert not zs and not labels and not us
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.samples.numpy(), np.asarray(want.samples),
                               atol=1e-5)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=1e-5)
    np.testing.assert_allclose(got.aux["logit_max"].numpy(),
                               np.asarray(want.aux["logit_max"]), atol=1e-5)
    assert got.aux["logit_max"].shape == (10,)
    np.testing.assert_array_equal(got.accepted.numpy(),
                                  np.asarray(want.accepted))
    assert 0 < got.accept_rate < 1


def test_standard_and_refinement_keep_labels(monkeypatch):
    jb, tb, g_vars, d_vars, g, d = make_cond_pair(seed=24)
    kw = dict(num_batches=2, batch_size=8, steps=2, rate=0.05)
    key = jax.random.PRNGKey(2)
    for method in ("standard", "refinement"):
        want = sample(jb, g_vars, d_vars, RefineConfig(**kw), key,
                      method=method)
        zs, labels = [], []
        for i in range(2):
            k_z, k_l = jax.random.split(jax.random.fold_in(key, i))
            zs.append(np.array(jb.sample_z(k_z, 8)))
            labels.append(np.array(jb.sample_labels(k_l, 8)))
        inject(monkeypatch, tb, t_collab, zs, labels, [])
        got = t_sample(tb, g, d, TRefineConfig(**kw), None, method=method)
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(want.labels))
        np.testing.assert_allclose(got.samples.numpy(),
                                   np.asarray(want.samples), atol=1e-5)
        np.testing.assert_allclose(got.logits.numpy(),
                                   np.asarray(want.logits), atol=1e-5)


# -- class-balanced real draws ------------------------------------------------

def _datasets():
    """The same 30 uint8 images in both packages, 5 classes, class 3 with
    no image (a degenerate class)."""
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (30, 4, 4, 3), dtype=np.uint8)
    labels = rng.choice([0, 1, 2, 4], 30).astype(np.int32)
    labels[0] = 4  # the largest label sets the class count
    j = ImageDataset(images=jnp.asarray(images), labels=jnp.asarray(labels))
    t = TImageDataset(images=_t(images), labels=_t(labels))
    return j, t, labels


def test_batch_by_labels_matches_jax():
    j, t, labels = _datasets()
    assert t.num_classes == j.num_classes == 5
    want_labels = np.array([0, 1, 2, 3, 4, 4, 0, 3])
    key = jax.random.PRNGKey(11)
    x_want, lab_want = j.batch_by_labels(key, jnp.asarray(want_labels))
    r = np.array(jax.random.randint(key, want_labels.shape, 0, 1 << 30))
    x_got, lab_got = t.batch_by_labels_from(_t(r), _t(want_labels))
    # One float32 ulp: jitted, XLA multiplies by 1 / 127.5 where the port
    # divides; two different images differ by 1 / 127.5 at least.
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want),
                               atol=1.2e-7, rtol=0)
    np.testing.assert_array_equal(lab_got.numpy(), np.asarray(lab_want))
    table, counts = t.class_table()
    assert table.shape == (5, int(np.bincount(labels).max()))
    assert counts.tolist() == [max(int((labels == c).sum()), 1)
                               for c in range(5)]
    assert table[3].tolist() == [0] * table.shape[1]  # degenerate: index 0
    # Every other row lists its class only, tiled cyclically.
    for c in (0, 1, 2, 4):
        assert set(labels[table[c].numpy()]) == {c}


def test_batch_by_labels_draws_the_asked_classes():
    _, t, labels = _datasets()
    want = torch.tensor([4, 0, 1, 2] * 8)
    x, lab = t.batch_by_labels(torch.Generator().manual_seed(0), want)
    assert torch.equal(lab, want) and x.shape == (32, 4, 4, 3)
    assert float(x.min()) >= -1.0 and float(x.max()) <= 1.0
    # Each row is an image of its class (the store holds no duplicates).
    imgs = t.images.float() / 127.5 - 1.0
    for row, c in zip(x, want.tolist()):
        match = [i for i in range(t.n) if torch.equal(imgs[i], row)]
        assert match and all(labels[i] == c for i in match)


def test_unlabelled_dataset_has_no_classes():
    _, t, _ = _datasets()
    t = TImageDataset(images=t.images, labels=None)
    assert t.num_classes == 0
    with pytest.raises(ValueError, match="no labels"):
        t.batch_by_labels(None, torch.zeros(2, dtype=torch.int64))
