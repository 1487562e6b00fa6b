"""The ``toy2d`` slice end to end: the port's ``sample`` against the JAX
package's on a small toy2d model (hidden 64, 3 layers; the preset's K = 10,
rate 0.1 and gamma percentile 80, 3 rounds of 32 and a burn-in of 64), with
shaping every round on real batches from the ring8_imbalanced mixture, and
the 2D metrics of what each accepts.

The port is fed the JAX side's draws by replaying its key splits (see
tests/test_torch_collab.py); the real batches are JAX ``sample_mixture``
draws. With ``use_pallas`` on, the port refines through the MLP kernel's
wrapper and accepts through the DRS kernel's wrapper (their plain versions
on the CPU); the JAX side, on the CPU, runs its scan oracle either way.

Tolerances: samples and logits atol 1e-4, as in test_torch_collab.py (ten
refinement steps per round under a D that shaping moves between rounds);
shaped params atol 1e-5; accept masks equal; metrics atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.config import get_preset
from collaborative_gan_sampling_torch.data.synthetic2d import make_mixture
from collaborative_gan_sampling_torch.evals.metrics2d import metrics_2d
from collaborative_gan_sampling_torch.ops.refine_mlp import fused_refine_mlp
from collaborative_gan_sampling_torch.sampling import collab as t_collab
from collaborative_gan_sampling_torch.sampling import refine as t_refine
from collaborative_gan_sampling_torch.sampling.collab import sample as t_sample
from collaborative_gan_sampling_torch.utils.weights import to_jax_variables
from collaborative_gan_sampling_tpu.config import RefineConfig
from collaborative_gan_sampling_tpu.data.synthetic2d import (
    make_mixture as jax_make_mixture,
    sample_mixture as jax_sample_mixture,
)
from collaborative_gan_sampling_tpu.evals.metrics2d import (
    metrics_2d as jax_metrics_2d,
)
from collaborative_gan_sampling_tpu.sampling import sample
from tests.test_torch_mlp import MID
from tests.test_torch_models import make_pair, to_numpy_tree

B, ROUNDS = 32, 3
PRESET = get_preset("toy2d")
RCFG = dict(steps=PRESET.refine.steps, rate=PRESET.refine.rate,
            gamma_percentile=PRESET.refine.gamma_percentile,
            num_batches=ROUNDS, batch_size=B, burn_in=2 * B, shape_every=1,
            shaping_lr=1e-3)
DATA = PRESET.data
JSPEC = jax_make_mixture(DATA.dataset, DATA.ring_radius, DATA.mixture_std)
SPEC = make_mixture(DATA.dataset, DATA.ring_radius, DATA.mixture_std,
                    device="cpu")


def _data_fn(key, n):
    return jax_sample_mixture(key, JSPEC, n), None


def _replayed_draws(key, cfg, z_dim, method):
    """The z, u and real batches JAX's ``sample`` draws, in call order."""
    zs, us, reals = [], [], []

    def z_of(k):
        return np.array(jax.random.normal(jax.random.split(k)[0],
                                          (B, z_dim), dtype=jnp.float32))

    if method in ("standard", "refinement"):
        return [z_of(jax.random.fold_in(key, i))
                for i in range(cfg.num_batches)], us, reals
    k_burn, k_main = jax.random.split(key)
    for i in range(max(1, cfg.burn_in // cfg.batch_size)):
        zs.append(z_of(jax.random.fold_in(k_burn, i)))
    for i in range(cfg.num_batches):
        k = jax.random.fold_in(k_main, i)
        if method == "reject":
            k_draw, k_acc = jax.random.split(k)
        else:
            k_draw, k_acc, k_real, _ = jax.random.split(k, 4)
        zs.append(z_of(k_draw))
        us.append(np.array(jax.random.uniform(k_acc, (B,))))
        if method == "collab" and i % cfg.shape_every == 0:
            for j in range(cfg.shaping_steps):
                reals.append(np.array(_data_fn(jax.random.fold_in(k_real, j),
                                               B)[0]))
    return zs, us, reals


@pytest.fixture(scope="module")
def pair():
    return make_pair(MID, seed=70)


def _run_both(pair, method, use_pallas, monkeypatch):
    jb, tb, g_vars, d_vars, g, d = pair
    key = jax.random.PRNGKey(3)
    jcfg = RefineConfig(use_pallas=use_pallas, **RCFG)
    want = sample(jb, g_vars, d_vars, jcfg, key, method=method,
                  data_fn=_data_fn)

    zs, us, reals = _replayed_draws(key, jcfg, jb.z_dim, method)
    monkeypatch.setattr(type(tb), "sample_z",
                        lambda self, gen, n: torch.from_numpy(zs.pop(0)))
    real_accept = t_collab.drs_accept_mask

    def accept_with_u(gen, logits, *args, **kw):
        return real_accept(gen, logits, *args,
                           uniforms=torch.from_numpy(us.pop(0)), **kw)

    monkeypatch.setattr(t_collab, "drs_accept_mask", accept_with_u)
    kernel_calls = []
    real_refine = t_refine.fused_refine_mlp
    monkeypatch.setattr(t_refine, "fused_refine_mlp",
                        lambda *a: kernel_calls.append(1) or real_refine(*a))
    tcfg = dataclasses.replace(PRESET.refine, use_pallas=use_pallas, **RCFG)
    got = t_sample(tb, g, d, tcfg, None, method=method,
                   data_fn=lambda gen, n: (torch.from_numpy(reals.pop(0)),
                                           None))
    assert not zs and not us and not reals  # every draw was consumed
    refine_rounds = {"standard": 0, "refinement": ROUNDS, "reject": 0,
                     "collab": ROUNDS + 2}[method]
    assert len(kernel_calls) == (refine_rounds if use_pallas else 0)
    assert fused_refine_mlp.launches == 0  # the CPU takes the plain version
    return want, got


def _assert_same_samples(want, got):
    np.testing.assert_allclose(got.samples.numpy(), np.asarray(want.samples),
                               atol=1e-4)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=1e-4)
    np.testing.assert_array_equal(got.accepted.numpy(),
                                  np.asarray(want.accepted))
    m_got = metrics_2d(got.samples, SPEC, weights=got.accepted.float())
    m_want = jax_metrics_2d(want.samples, JSPEC,
                            weights=want.accepted.astype(jnp.float32))
    for k in m_want:
        np.testing.assert_allclose(float(m_got[k]), float(m_want[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["kernel_entry", "autograd"])
def test_toy2d_collab_matches_jax(pair, use_pallas, monkeypatch):
    want, got = _run_both(pair, "collab", use_pallas, monkeypatch)
    _assert_same_samples(want, got)
    assert 0 < float(got.accepted.float().mean()) < 1
    assert got.aux["shaping_steps_done"] == int(
        want.aux["shaping_steps_done"]) == ROUNDS
    np.testing.assert_allclose(float(got.aux["logit_max"]),
                               float(want.aux["logit_max"]), atol=1e-4)
    np.testing.assert_allclose(got.aux["shape_losses"].numpy(),
                               np.asarray(want.aux["shape_losses"]),
                               atol=1e-5)
    shaped = to_jax_variables(got.aux["shaped_d"])["params"]
    ref = to_numpy_tree(want.aux["shaped_d_vars"])["params"]
    moved = 0.0
    for name in ref:
        for leaf in ref[name]:
            np.testing.assert_allclose(shaped[name][leaf], ref[name][leaf],
                                       atol=1e-5, err_msg=f"{name}/{leaf}")
            moved = max(moved, np.abs(
                shaped[name][leaf]
                - to_numpy_tree(pair[3])["params"][name][leaf]).max())
    assert moved > 1e-4  # shaping did move D


@pytest.mark.parametrize("method", ["standard", "refinement", "reject"])
def test_toy2d_other_methods_match_jax(pair, method, monkeypatch):
    want, got = _run_both(pair, method, True, monkeypatch)
    _assert_same_samples(want, got)
