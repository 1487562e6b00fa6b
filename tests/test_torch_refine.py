"""Parity of the port's x-space refinement (``sampling/refine.py``) with the
JAX package's scan path (``_refine_scan``, reached with the s2d and Pallas
fast paths off).

Same weights, same x0 and, for Langevin noise, the same normal draws (the
JAX side's, fed to the port). float32 on the CPU; tolerance atol 1e-5 on x
and logits after K steps of a tiny-rate descent: the per-step gradients
agree to ~1e-7 and K steps accumulate them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.config import RefineConfig as TRefineConfig
from collaborative_gan_sampling_torch.ops.conv_refine import (
    fused_refine_conv28,
)
from collaborative_gan_sampling_torch.sampling import refine as t_refine
from collaborative_gan_sampling_torch.sampling.refine import (
    make_draw_refine_fn as t_make_draw_refine_fn,
    make_refine_fn as t_make_refine_fn,
)
from collaborative_gan_sampling_torch.utils.weights import load_jax_variables
from collaborative_gan_sampling_tpu.config import RefineConfig
from collaborative_gan_sampling_tpu.sampling.refine import (
    make_draw_refine_fn,
    make_refine_fn,
)
from tests.test_torch_models import MNIST, TINY, make_pair

ATOL = 1e-5


@pytest.fixture(scope="module")
def tiny_pair():
    """The tiny pair with a D head scaled up so that its logits spread
    apart and a stop score of 0.53 splits the batch."""
    jb, tb, g_vars, d_vars, g, d = make_pair(TINY, seed=21)
    d_vars["params"]["out"]["kernel"] = d_vars["params"]["out"]["kernel"] * 40
    load_jax_variables(d, d_vars)
    return jb, tb, g_vars, d_vars, g, d


def _x0(shape, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (4, *shape)).astype(np.float32)


CASES = {
    "ns": dict(),
    "kl": dict(objective="kl"),
    "saturating": dict(objective="saturating"),
    "clip": dict(clip_norm=1e-3),
    "stop_score": dict(stop_score=0.53),
    "proximal": dict(proximal=2.0),
    "noise": dict(noise=0.01),
}


@pytest.mark.parametrize("case", list(CASES))
def test_refine_matches_scan(tiny_pair, case, monkeypatch):
    jb, tb, _, d_vars, _, d = tiny_pair
    kw = dict(steps=3, rate=0.5, use_pallas=False, use_s2d=False,
              **CASES[case])
    x0 = _x0(jb.data_shape, seed=len(case))
    key = jax.random.PRNGKey(7)
    x_want, aux = make_refine_fn(jb, RefineConfig(**kw))(
        d_vars, jnp.asarray(x0), key=key)
    if kw.get("noise", 0) > 0:
        draws = [torch.from_numpy(np.array(jax.random.normal(
            k, x0.shape, dtype=jnp.float32)))
            for k in jax.random.split(key, kw["steps"])]
        monkeypatch.setattr(t_refine, "_normal_like",
                            lambda x, generator: draws.pop(0))
    x_got, aux_t = t_make_refine_fn(tb, TRefineConfig(**kw))(
        d, torch.from_numpy(x0))
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want), atol=ATOL)
    np.testing.assert_allclose(aux_t["logits"].numpy(),
                               np.asarray(aux["logits"]), atol=ATOL)
    moved = np.abs(x_got.numpy() - x0).reshape(4, -1).max(axis=1)
    if case == "stop_score":  # some samples frozen from the start, some not
        assert moved.min() == 0.0 and moved.max() > 1e-4
    else:
        assert moved.min() > 1e-4


def test_trajectory_and_tensor_rate(tiny_pair):
    jb, tb, _, d_vars, _, d = tiny_pair
    kw = dict(steps=2, rate=0.1, use_pallas=False, use_s2d=False)
    x0 = _x0(jb.data_shape, seed=9)
    x_want, aux = make_refine_fn(jb, RefineConfig(**kw),
                                 return_trajectory=True)(
        d_vars, jnp.asarray(x0), rate=jnp.float32(0.3))
    x_got, aux_t = t_make_refine_fn(tb, TRefineConfig(**kw),
                                    return_trajectory=True)(
        d, torch.from_numpy(x0), rate=torch.tensor(0.3))
    assert aux_t["traj"].shape == (3, *x0.shape)
    np.testing.assert_allclose(aux_t["traj"].numpy(), np.asarray(aux["traj"]),
                               atol=ATOL)
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want), atol=ATOL)


def test_mnist_refine_dispatches_to_kernel_path(monkeypatch):
    """At the mnist widths the gate holds: the refine runs through the
    conv-D kernel's wrapper (its plain version on the CPU) and matches the
    JAX refine of the same preset."""
    jb, tb, _, d_vars, _, d = make_pair(MNIST, seed=31)
    calls = []
    real = t_refine.fused_refine_conv28
    monkeypatch.setattr(t_refine, "fused_refine_conv28",
                        lambda *a: calls.append(1) or real(*a))
    kw = dict(steps=2, rate=0.05)
    x0 = _x0(jb.data_shape, seed=4)
    x_want, aux = make_refine_fn(jb, RefineConfig(**kw))(d_vars,
                                                         jnp.asarray(x0))
    x_got, aux_t = t_make_refine_fn(tb, TRefineConfig(**kw))(
        d, torch.from_numpy(x0))
    assert calls == [1] and fused_refine_conv28.launches == 0
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want), atol=ATOL)
    np.testing.assert_allclose(aux_t["logits"].numpy(),
                               np.asarray(aux["logits"]), atol=ATOL)


def test_draw_refine_matches(tiny_pair, monkeypatch):
    """z -> G -> K steps, with the JAX draw of z fed to the port."""
    jb, tb, g_vars, d_vars, g, d = tiny_pair
    kw = dict(steps=2, rate=0.2, use_pallas=False)
    key = jax.random.PRNGKey(5)
    x_want, _, lg_want = make_draw_refine_fn(jb, RefineConfig(**kw))(
        g_vars, d_vars, key, 4)
    z = np.array(jb.sample_z(jax.random.split(key)[0], 4))
    monkeypatch.setattr(type(tb), "sample_z",
                        lambda self, generator, n: torch.from_numpy(z))
    x_got, labels, lg_got = t_make_draw_refine_fn(tb, TRefineConfig(**kw))(
        g, d, None, 4)
    assert labels is None
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want), atol=ATOL)
    np.testing.assert_allclose(lg_got.numpy(), np.asarray(lg_want), atol=ATOL)


def test_latent_space_not_ported(monkeypatch):
    """Latent-space refinement, ported: with K = 0 it is the plain draw
    G(z) and its logits, with K = 2 it moves x off G(z0) toward higher D
    scores (the parity with JAX's _make_draw_refine_z is
    tests/test_torch_refine_z.py's); another space is refused."""
    from tests.test_torch_refine_z import sensitive

    jb, tb, _, _, g, d = sensitive(make_pair(TINY, seed=21), 200)
    z = np.random.default_rng(3).standard_normal((4, jb.z_dim)).astype(
        np.float32)
    monkeypatch.setattr(type(tb), "sample_z",
                        lambda self, generator, n: torch.from_numpy(z))
    with torch.no_grad():
        x0 = tb.generate(g, torch.from_numpy(z))
        lg0 = tb.discriminate(d, x0)
    x, labels, lg = t_make_draw_refine_fn(tb, TRefineConfig(
        space="z", steps=0))(g, d, None, 4)
    assert labels is None
    assert torch.equal(x, x0) and torch.equal(lg, lg0)
    x, _, lg = t_make_draw_refine_fn(tb, TRefineConfig(
        space="z", steps=2, rate=5.0))(g, d, None, 4)
    assert float((x - x0).abs().amax(dim=(1, 2, 3)).min()) > 1e-4
    assert float(lg.mean()) > float(lg0.mean())  # toward higher D scores
    with pytest.raises(ValueError, match="'x' or 'z'"):
        t_make_draw_refine_fn(tb, dataclasses.replace(TRefineConfig(),
                                                      space="w"))
