"""Parity of the port's conditional D shaping step and targeted serving with
the JAX package's, on the tiny conditional DCGAN of
tests/test_torch_conditional.py (10 classes), float32:

* one shaping step with ``freeze_embed`` and with ``class_weight`` against
  ``make_shaping_step``: params, Adam's moments and the loss;
* ``ServingSampler(class_id=3)``: calibrate, round and generate against
  JAX's, every label 3; the range errors.

Tolerances: one shaping step as tests/test_torch_shaping.py, at lr 1e-4
and D's table at std 0.3: params atol 1e-6 but for conv1's bias (it feeds
a train-mode BatchNorm, so its gradient is rounding noise in both
frameworks), Adam's moments within 5e-4 of their largest entry
(tests/test_torch_train.py). Serving atol 1e-5. Accept masks equal (no u
lies within 1e-6 of its probability).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.config import ModelConfig as TModelConfig
from collaborative_gan_sampling_torch.config import RefineConfig as TRefineConfig
from collaborative_gan_sampling_torch.models import make_bundle as t_make_bundle
from collaborative_gan_sampling_torch.sampling import serve as t_serve
from collaborative_gan_sampling_torch.sampling.serve import (
    ServingSampler as TServingSampler,
)
from collaborative_gan_sampling_torch.training.shaping import (
    ShapingStep,
    class_weights,
)
from collaborative_gan_sampling_torch.utils.weights import (
    adam_to_optax,
    to_jax_variables,
)
from collaborative_gan_sampling_tpu.config import RefineConfig
from collaborative_gan_sampling_tpu.sampling.serve import ServingSampler
from collaborative_gan_sampling_tpu.training.shaping import (
    _class_weights,
    make_shaping_step,
)
from tests.test_torch_conditional import (  # noqa: F401 (a fixture)
    COND,
    _t,
    make_cond_pair,
    one_torch_thread,
)
from tests.test_torch_conditional_drs import inject
from tests.test_torch_models import to_numpy_tree
from tests.test_torch_train import scaled_err

B = 8
SHAPE = (16, 16, 3)


# -- one shaping step ---------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(freeze_embed=True),
                                dict(class_weight=True),
                                dict(class_weight=True, freeze_embed=True,
                                     r1_gamma=1.0)],
                         ids=["freeze_embed", "class_weight", "both_r1"])
def test_shaping_step_matches_jax(kw):
    jb, tb, _, d_vars, _, d = make_cond_pair(seed=32)
    rng = np.random.default_rng(3)
    x_real, x_fake = (rng.uniform(-1, 1, (B, *SHAPE)).astype(np.float32)
                      for _ in range(2))
    # Skewed label sets, so that the class weights are not all ones.
    lab_r = np.array([0, 0, 0, 1, 2, 2, 5, 9])
    lab_f = np.array([3, 3, 3, 3, 3, 4, 4, 7])
    j_step = make_shaping_step(jb, 1e-4, **kw)
    j_state, j_loss = j_step(j_step.init(d_vars), jnp.asarray(x_real),
                             jnp.asarray(x_fake), jnp.asarray(lab_r),
                             jnp.asarray(lab_f))
    t_step = ShapingStep(tb, 1e-4, **kw)
    t_state, t_loss = t_step(t_step.init(d), _t(x_real), _t(x_fake),
                             _t(lab_r), _t(lab_f))
    assert float(t_loss) == pytest.approx(float(j_loss), abs=1e-5)
    assert t_state.step == int(j_state.step) == 1
    got, want = to_jax_variables(t_state.d), to_numpy_tree(j_state.d_vars)
    got["params"]["conv1"].pop("bias")  # BN-fed: rounding noise, as there
    want["params"]["conv1"].pop("bias")
    for name in want["params"]:
        for leaf in want["params"][name]:
            np.testing.assert_allclose(got["params"][name][leaf],
                                       want["params"][name][leaf], atol=1e-6,
                                       err_msg=f"{name}/{leaf}")
    got_opt = adam_to_optax(t_state.opt, t_state.d)["0"]
    want_opt = to_numpy_tree(j_state.opt[0]._asdict())
    assert int(got_opt["count"]) == int(want_opt["count"]) == 1
    for k in ("mu", "nu"):
        for tree in (got_opt[k], want_opt[k]):
            tree["conv1"].pop("bias")
        assert scaled_err(got_opt[k], want_opt[k]) <= 5e-4, k
    start = to_jax_variables(d)["params"]["proj_embed"]["embedding"]
    moved = np.abs(got["params"]["proj_embed"]["embedding"] - start).max()
    if kw.get("freeze_embed"):
        assert moved == 0.0
        assert not got_opt["mu"]["proj_embed"]["embedding"].any()
        assert not got_opt["nu"]["proj_embed"]["embedding"].any()
    else:
        assert moved > 1e-5


def test_class_weights_match_jax():
    for labels in ([0, 0, 0, 1, 2, 2, 5, 9], [4] * 8, list(range(8))):
        got = class_weights(torch.tensor(labels), 10)
        want = _class_weights(jnp.asarray(labels), 10)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        assert float(got.mean()) == pytest.approx(1.0)


# -- targeted serving ---------------------------------------------------------

def _replay_serving(jb, key, cfg, calibrate):
    """JAX serving's z and u draws with class_id (no label draw): burn
    round i from fold_in(key, i), round i's (k_draw, k_acc) from
    split(fold_in(key, i)); z from split(k)[0] of the draw key."""
    zs, us = [], []
    for i in range(max(1, cfg.burn_in // cfg.batch_size) if calibrate
                   else cfg.num_batches):
        k = jax.random.fold_in(key, i)
        if not calibrate:
            k, k_acc = jax.random.split(k)
            us.append(np.array(jax.random.uniform(k_acc, (cfg.batch_size,))))
        zs.append(np.array(jb.sample_z(jax.random.split(k)[0],
                                       cfg.batch_size)))
    return zs, us


@pytest.mark.parametrize("method,per_class", [("collab", False),
                                              ("reject", True)])
def test_class_id_serving_matches_jax(method, per_class, monkeypatch):
    jb, tb, g_vars, d_vars, g, d = make_cond_pair(seed=33)
    kw = dict(steps=2, rate=0.05, num_batches=2, batch_size=B, burn_in=2 * B,
              per_class_drs=per_class)
    jsrv = ServingSampler(jb, RefineConfig(**kw), method=method, class_id=3)
    k_cal, k_round = jax.random.PRNGKey(6), jax.random.PRNGKey(7)
    m_want = jsrv.calibrate(g_vars, d_vars, k_cal)
    x_want, lab_want, acc_want, lg_want = jsrv.round(g_vars, d_vars, m_want,
                                                     k_round)
    cfg = RefineConfig(**kw)
    zs, _ = _replay_serving(jb, k_cal, cfg, True)
    zs2, us = _replay_serving(jb, k_round, cfg, False)
    zs += zs2
    inject(monkeypatch, tb, t_serve, zs, [], us)  # no label is drawn
    tsrv = TServingSampler(tb, TRefineConfig(**kw), method=method,
                           class_id=3)
    m_got = tsrv.calibrate(g, d, None)
    x_got, lab_got, acc_got, lg_got = tsrv.round(g, d, m_got, None)
    assert not zs and not us
    assert lab_got.tolist() == [3] * (2 * B) == np.asarray(lab_want).tolist()
    np.testing.assert_allclose(m_got.numpy(), np.asarray(m_want), atol=1e-5)
    if per_class:  # only class 3 drawn: every other class takes its M
        assert m_got.shape == (10,) and len(set(m_got.tolist())) == 1
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want), atol=1e-5)
    np.testing.assert_allclose(lg_got.numpy(), np.asarray(lg_want), atol=1e-5)
    np.testing.assert_array_equal(acc_got.numpy(), np.asarray(acc_want))
    assert 0 < int(acc_got.sum()) < 2 * B


def test_class_id_generate(monkeypatch):
    """generate returns n samples, all of class_id, with their labels;
    random labels without class_id."""
    _, tb, _, _, g, d = make_cond_pair(seed=34)
    cfg = TRefineConfig(steps=2, rate=0.05, num_batches=2, batch_size=B,
                        burn_in=B)
    srv = TServingSampler(tb, cfg, method="collab", class_id=3)
    x, labels, stats = srv.generate(g, d, torch.Generator().manual_seed(1),
                                    n=20)
    assert x.shape == (20, *SHAPE) and x.dtype == torch.uint8
    assert labels.tolist() == [3] * 20 and stats["rounds"] >= 1
    srv = TServingSampler(tb, cfg, method="reject")
    _, labels, _ = srv.generate(g, d, torch.Generator().manual_seed(1), n=20)
    assert labels.shape == (20,) and len(set(labels.tolist())) > 1


def test_class_id_range_errors():
    _, tb, _, _, _, _ = make_cond_pair()
    with pytest.raises(ValueError, match="out of range"):
        TServingSampler(tb, TRefineConfig(), class_id=10)
    with pytest.raises(ValueError, match="out of range"):
        TServingSampler(tb, TRefineConfig(), class_id=-1)
    unc = t_make_bundle(TModelConfig(**dict(COND, num_classes=0)),
                        device="cpu")
    with pytest.raises(ValueError, match="conditional model"):
        TServingSampler(unc, TRefineConfig(), class_id=0)
