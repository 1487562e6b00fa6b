"""Parity of the port's latent-space refinement (``make_draw_refine_fn`` with
``space='z'``) with the JAX package's ``_make_draw_refine_z``: z drifts
along -grad_z l(D(G(z))) for K steps, then x = G(z_K) and its logits.

The same weights (G's kernels and D's head scaled up so that x depends on
z), and JAX's draws fed to the port: z0 from split(key)[0],
the labels from split(key)[1] (conditional pair), the Langevin noise of
step k from split(fold_in(key, 1), K)[k]. Unconditional (the tiny pair of
tests/test_torch_models.py) and conditional (tests/test_torch_conditional
.py's), float32; tolerance atol 1e-5 on x and logits, as the x-space
refinement's (tests/test_torch_refine.py): each step's gradient through G
and D agrees to ~1e-7 and three steps accumulate it.
"""

import jax
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.config import RefineConfig as TRefineConfig
from collaborative_gan_sampling_torch.sampling import refine as t_refine
from collaborative_gan_sampling_torch.sampling.refine import (
    make_draw_refine_fn as t_make_draw_refine_fn,
)
from collaborative_gan_sampling_torch.utils.weights import load_jax_variables
from collaborative_gan_sampling_tpu.config import RefineConfig
from collaborative_gan_sampling_tpu.sampling.refine import make_draw_refine_fn
from tests.test_torch_conditional import (  # noqa: F401 (a fixture)
    make_cond_pair,
    one_torch_thread,
    port_pair,
)
from tests.test_torch_models import TINY

ATOL = 1e-5
N, STEPS, RATE = 4, 3, 5.0

CASES = {
    "plain": dict(),
    "proximal": dict(proximal=2.0),
    "clip": dict(clip_norm=1e-3),
    "stop_score": dict(stop_score="median"),
    "noise": dict(noise=0.01),
}


def run_both(pair, kw, monkeypatch, seed=8):
    """(JAX's (x, labels, logits), the port's, z0) of one z-space
    draw-and-refine on the same draws. A stop score of "median" is the
    median of sigmoid(D(G(z0))), so that it splits the batch."""
    jb, tb, g_vars, d_vars, g, d = pair
    key = jax.random.PRNGKey(seed)
    k_z, k_lab = jax.random.split(key)
    z0 = np.array(jb.sample_z(k_z, N))
    labels = (torch.from_numpy(np.array(jb.sample_labels(k_lab, N)))
              if jb.conditional else None)
    if kw.get("stop_score") == "median":
        with torch.no_grad():
            lg = tb.discriminate(d, tb.generate(g, torch.from_numpy(z0),
                                                labels), labels)
        kw = dict(kw, stop_score=float(torch.sigmoid(lg).median()))
    cfg = dict(space="z", steps=STEPS, rate=RATE, **kw)
    want = make_draw_refine_fn(jb, RefineConfig(**cfg))(g_vars, d_vars, key,
                                                        N)
    monkeypatch.setattr(type(tb), "sample_z",
                        lambda self, gen, n: torch.from_numpy(z0))
    monkeypatch.setattr(type(tb), "sample_labels",
                        lambda self, gen, n: labels)
    noise = [torch.from_numpy(np.array(jax.random.normal(k, z0.shape)))
             for k in jax.random.split(jax.random.fold_in(key, 1), STEPS)]
    monkeypatch.setattr(t_refine, "_normal_like",
                        lambda v, generator: noise.pop(0))
    got = t_make_draw_refine_fn(tb, TRefineConfig(**cfg))(g, d, None, N)
    assert not noise or not kw.get("noise")  # every step's draw was taken
    return want, got, z0


def check(want, got, pair, z0, case):
    jb, tb, g_vars, _, g, _ = pair
    x_want, lab_want, lg_want = (np.asarray(a) if a is not None else None
                                 for a in want)
    x_got, lab_got, lg_got = got
    if jb.conditional:
        np.testing.assert_array_equal(lab_got.numpy(), lab_want)
    else:
        assert lab_got is None and lab_want is None
    np.testing.assert_allclose(x_got.numpy(), x_want, atol=ATOL)
    np.testing.assert_allclose(lg_got.numpy(), lg_want, atol=ATOL)
    # The drift moved the samples (for stop_score, some and not others).
    with torch.no_grad():
        x0 = tb.generate(g, torch.from_numpy(z0), lab_got).numpy()
    moved = np.abs(x_got.numpy() - x0).reshape(N, -1).max(axis=1)
    if case == "stop_score":
        assert moved.min() == 0.0 and moved.max() > 1e-4
    else:
        assert moved.min() > 1e-4


def sensitive(pair, d_out_scale):
    """The pair with G's kernels 6 times and D's head ``d_out_scale`` times
    their drawn scale: at the DCGAN init G's output hardly depends on z
    (|grad_z| ~ 1e-6), here it does (~1e-2) and the logits spread."""
    jb, tb, g_vars, d_vars, g, d = pair
    for p in g_vars["params"].values():
        if "kernel" in p:
            p["kernel"] = p["kernel"] * 6
    d_vars["params"]["out"]["kernel"] = (d_vars["params"]["out"]["kernel"]
                                         * d_out_scale)
    load_jax_variables(g, g_vars)
    load_jax_variables(d, d_vars)
    return pair


@pytest.fixture(scope="module")
def uncond():
    return sensitive(port_pair(TINY, seed=21), 200)


@pytest.fixture(scope="module")
def cond():
    return sensitive(make_cond_pair(seed=22), 10)


@pytest.mark.parametrize("case", list(CASES))
def test_unconditional_matches_jax(uncond, case, monkeypatch):
    want, got, z0 = run_both(uncond, CASES[case], monkeypatch)
    check(want, got, uncond, z0, case)


@pytest.mark.parametrize("case", list(CASES))
def test_conditional_matches_jax(cond, case, monkeypatch):
    want, got, z0 = run_both(cond, CASES[case], monkeypatch, seed=10)
    check(want, got, cond, z0, case)


def test_given_labels_are_kept(cond, monkeypatch):
    """With labels given, none are drawn and the refinement is of those
    classes."""
    jb, tb, g_vars, d_vars, g, d = cond
    labels = torch.tensor([1, 1, 7, 2])
    monkeypatch.setattr(type(tb), "sample_labels", None)  # must not run
    x, lab, logits = t_make_draw_refine_fn(
        tb, TRefineConfig(space="z", steps=2, rate=0.1))(
        g, d, torch.Generator().manual_seed(0), N, labels=labels)
    assert lab is labels and x.shape == (N, 16, 16, 3)
    assert bool(torch.isfinite(logits).all())
