"""Parity of the port's conditional x-space draw-and-refine unit with the
JAX package's ``make_draw_refine_fn`` on the tiny conditional DCGAN of
tests/test_torch_conditional.py: G draws from JAX's z and labels, K steps
of refinement under D with the labels threaded through, D's final logits.

For a DCGAN, JAX's unit runs through its space-to-depth rewrite
(``ops/refine_s2d.py``, on by default): exact math in permuted
coordinates, so float32 agrees at atol 1e-5 (tests/test_torch_refine.py's);
at bfloat16 the port is held to JAX's f32 within twice JAX's own spread
between its s2d and plain bf16 paths and its f32 (max over the batch).
"""

import functools

import jax
import numpy as np
import torch

from collaborative_gan_sampling_torch.config import RefineConfig as TRefineConfig
from collaborative_gan_sampling_torch.sampling.refine import (
    make_draw_refine_fn as t_make_draw_refine_fn,
)
from collaborative_gan_sampling_tpu.config import RefineConfig
from collaborative_gan_sampling_tpu.sampling.refine import make_draw_refine_fn
from tests.test_torch_conditional import (  # noqa: F401 (a fixture)
    COND,
    COND_BF16,
    make_cond_pair,
    one_torch_thread,
)

CFG = dict(steps=3, rate=0.2)
KEY = jax.random.PRNGKey(5)


@functools.lru_cache(maxsize=None)
def _jax(dtype: str, use_s2d: bool = True):
    """JAX's (x, labels, logits) of one draw-and-refine, computed once per
    dtype and path."""
    model_kw = COND if dtype == "float32" else COND_BF16
    jb, _, g_vars, d_vars, _, _ = make_cond_pair(model_kw, seed=41)
    out = make_draw_refine_fn(jb, RefineConfig(**CFG, use_s2d=use_s2d))(
        g_vars, d_vars, KEY, 8)
    return tuple(np.asarray(a) for a in out)


def _port(model_kw, monkeypatch):
    """The port's (x, labels, logits) on JAX's z and labels."""
    jb, tb, _, _, g, d = make_cond_pair(model_kw, seed=41)
    k_z, k_lab = jax.random.split(KEY)
    z, lab = (np.array(jb.sample_z(k_z, 8)),
              np.array(jb.sample_labels(k_lab, 8)))
    monkeypatch.setattr(type(tb), "sample_z",
                        lambda self, gen, n: torch.from_numpy(z))
    monkeypatch.setattr(type(tb), "sample_labels",
                        lambda self, gen, n: torch.from_numpy(lab).long())
    got = t_make_draw_refine_fn(tb, TRefineConfig(**CFG))(g, d, None, 8)
    return [a.numpy() for a in got]


def test_conditional_draw_refine_matches_jax_s2d(monkeypatch):
    want, got = _jax("float32"), _port(COND, monkeypatch)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)


def test_conditional_draw_refine_bf16_within_s2d_spread(monkeypatch):
    want, got = _jax("bfloat16"), _port(COND_BF16, monkeypatch)
    plain, ref = _jax("bfloat16", use_s2d=False), _jax("float32")
    np.testing.assert_array_equal(got[1], want[1])
    for i in (0, 2):  # x, logits
        spread = max(np.abs(want[i] - ref[i]).max(),
                     np.abs(plain[i] - ref[i]).max())
        assert spread > 0
        assert np.abs(got[i] - ref[i]).max() <= 2 * spread
