"""Parity of the port's conditional collab sampling with the JAX package's,
on the tiny conditional DCGAN of tests/test_torch_conditional.py (10
classes), float32: collab rounds with per-class M, with shaping on (the
per-class EMA of M) and off, and with a global M, against
``sample(..., method="collab")`` on the JAX side's draws (z, labels, u,
real batches); class-balanced shaping through
``ImageDataset.batch_by_labels`` on both sides (the port's parity entry fed
JAX's r), which must be asked for the refined batch's labels. One shaping
step and targeted serving are in tests/test_torch_conditional_serve.py.

Tolerances: as tests/test_torch_collab.py, samples, logits and M atol
1e-4; shaped params atol 1e-6 (each moves ~3e-5 over the run) but for
conv1's bias, which feeds a train-mode BatchNorm: its gradient is exactly
zero, each framework computes rounding noise there and Adam turns that
into steps of up to its bound, lr (1 - b1) / sqrt(1 - b2), either way. The
projection multiplies that noise into the next rounds' logits by the
table's scale, so the runs shape at lr 1e-5 with D's table at std 0.05
(still 2.5 times the init's): measured 3e-5 at most on the logits, where
lr 1e-4 and std 0.3 give 7e-4. Accept masks equal (no u lies within 1e-6
of its probability).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from collaborative_gan_sampling_torch.config import RefineConfig as TRefineConfig
from collaborative_gan_sampling_torch.data.images import (
    ImageDataset as TImageDataset,
)
from collaborative_gan_sampling_torch.sampling import collab as t_collab
from collaborative_gan_sampling_torch.sampling.collab import sample as t_sample
from collaborative_gan_sampling_torch.utils.weights import to_jax_variables
from collaborative_gan_sampling_tpu.config import RefineConfig
from collaborative_gan_sampling_tpu.data.images import ImageDataset
from collaborative_gan_sampling_tpu.sampling import sample
from tests.test_torch_conditional import (  # noqa: F401 (a fixture)
    _t,
    make_cond_pair,
    one_torch_thread,
)
from tests.test_torch_conditional_drs import inject
from tests.test_torch_models import to_numpy_tree

B, ROUNDS = 8, 3
COLLAB_LR = 1e-5
SHAPE = (16, 16, 3)


def _data_fn(key, n):
    k_x, k_l = jax.random.split(key)
    return (jax.random.uniform(k_x, (n, *SHAPE), minval=-1.0, maxval=1.0),
            jax.random.randint(k_l, (n,), 0, 10))


def _datasets():
    """The same 200 uint8 images of 10 classes in both packages: the
    class-balanced real draws of JAX's ``batch_by_labels`` and the port's
    (its parity entry ``batch_by_labels_from``, on JAX's r)."""
    rng = np.random.default_rng(9)
    images = rng.integers(0, 256, (200, *SHAPE), dtype=np.uint8)
    labels = np.arange(200, dtype=np.int32) % 10
    return (ImageDataset(images=jnp.asarray(images),
                         labels=jnp.asarray(labels)),
            TImageDataset(images=_t(images), labels=_t(labels)))


J_DATA, T_DATA = _datasets()


def _replay_collab(jb, key, cfg, balanced):
    """JAX collab's draws in call order: burn batch i from
    split(fold_in(k_burn, i)); round i splits fold_in(k_main, i) into
    (k_draw, k_acc, k_real, k_shape), draws z and labels from
    split(k_draw), u from k_acc and real batch j from fold_in(k_real, j)
    (with the round's labels when balanced)."""
    k_burn, k_main = jax.random.split(key)
    zs, labels, us, reals = [], [], [], []

    def draw(k):
        k_z, k_l = jax.random.split(k)
        zs.append(np.array(jb.sample_z(k_z, B)))
        labels.append(np.array(jb.sample_labels(k_l, B)))

    for i in range(max(1, cfg.burn_in // B)):
        draw(jax.random.fold_in(k_burn, i))
    for i in range(cfg.num_batches):
        k_draw, k_acc, k_real, _ = jax.random.split(
            jax.random.fold_in(k_main, i), 4)
        draw(k_draw)
        us.append(np.array(jax.random.uniform(k_acc, (B,))))
        if cfg.shape_every and i % cfg.shape_every == 0:
            for j in range(cfg.shaping_steps):
                kj = jax.random.fold_in(k_real, j)
                if balanced:  # batch_by_labels' r
                    reals.append(np.array(jax.random.randint(
                        kj, (B,), 0, 1 << 30)))
                else:
                    reals.append(tuple(np.array(a) for a in _data_fn(kj,
                                                                     B)))
    return zs, labels, us, reals


CASES = {
    "per_class_shaped": (dict(per_class_drs=True, shape_every=1), True),
    "per_class_unshaped": (dict(per_class_drs=True, shape_every=0), True),
    "global_weighted_frozen": (dict(shape_every=1, shaping_class_weight=True,
                                    shaping_freeze_embed=True), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_collab_matches_jax(case, monkeypatch):
    kw, balanced = CASES[case]
    kw = dict(steps=2, rate=0.05, num_batches=ROUNDS, batch_size=B,
              burn_in=2 * B, shaping_lr=COLLAB_LR, **kw)
    jb, tb, g_vars, d_vars, g, d = make_cond_pair(seed=31, proj_std=0.05)
    key = jax.random.PRNGKey(4)
    jcfg = RefineConfig(**kw)
    want = sample(jb, g_vars, d_vars, jcfg, key, method="collab",
                  data_fn=_data_fn,
                  cond_data_fn=J_DATA.batch_by_labels if balanced else None)

    zs, labels, us, reals = _replay_collab(jb, key, jcfg, balanced)
    asked = []
    fakes = [lab for lab in labels[-ROUNDS:]]  # the rounds' labels

    def cond_data_fn(gen, lab):
        asked.append(np.array_equal(lab.numpy(), fakes.pop(0)))
        return T_DATA.batch_by_labels_from(_t(reals.pop(0)), lab)

    def data_fn(gen, n):
        x, lab = reals.pop(0)
        return _t(x), _t(lab).long()

    inject(monkeypatch, tb, t_collab, zs, labels, us)
    got = t_sample(tb, g, d, TRefineConfig(**kw), None, method="collab",
                   data_fn=data_fn,
                   cond_data_fn=cond_data_fn if balanced else None)
    assert not zs and not labels and not us and not reals
    assert all(asked) and len(asked) == (ROUNDS if balanced
                                         and kw["shape_every"] else 0)

    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.samples.numpy(), np.asarray(want.samples),
                               atol=1e-4)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=1e-4)
    np.testing.assert_array_equal(got.accepted.numpy(),
                                  np.asarray(want.accepted))
    m_got, m_want = got.aux["logit_max"], np.asarray(want.aux["logit_max"])
    assert tuple(m_got.shape) == m_want.shape
    np.testing.assert_allclose(m_got.numpy(), m_want, atol=1e-4)
    done = int(want.aux["shaping_steps_done"])
    assert got.aux["shaping_steps_done"] == done == (
        ROUNDS if kw["shape_every"] else 0)

    shaped = to_jax_variables(got.aux["shaped_d"])
    ref = to_numpy_tree(want.aux["shaped_d_vars"])
    noise = np.abs(shaped["params"]["conv1"].pop("bias")
                   - ref["params"]["conv1"].pop("bias")).max()
    assert noise <= 2 * COLLAB_LR * 0.5 / 0.001 ** 0.5 * max(done, 1)
    for name in ref["params"]:
        for leaf in ref["params"][name]:
            np.testing.assert_allclose(shaped["params"][name][leaf],
                                       ref["params"][name][leaf], atol=1e-6,
                                       err_msg=f"{name}/{leaf}")
    table = shaped["params"]["proj_embed"]["embedding"]
    start = to_jax_variables(d)["params"]["proj_embed"]["embedding"]
    if kw.get("shaping_freeze_embed"):
        np.testing.assert_array_equal(table, start)
    elif done:
        assert np.abs(table - start).max() > 1e-5  # ~COLLAB_LR a step
