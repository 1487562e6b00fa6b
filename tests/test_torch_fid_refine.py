"""FID-backprop refinement against the JAX package's: ``fid_loss`` (value
and gradient through the classifier's features, the batch moments and
Newton-Schulz at 10 iterations with eps 1e-3) and ``make_fid_refine_fn``
(x after 3 clipped steps, the start and end values), with the classifier's
weights carried over.

Tolerances: the loss at rtol 1e-4 and its gradient at atol 1e-3 of its
largest entry (float32 through a feature net, a 256x256 covariance and 10
Newton-Schulz iterations in another order); x after 3 steps at atol 1e-5
(each step moves a sample by at most the clip norm 1 in L2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.evals import fid as tfid
from collaborative_gan_sampling_torch.evals import features as tfeat
from collaborative_gan_sampling_torch.sampling import fid_refine as tref
from collaborative_gan_sampling_torch.utils.weights import load_jax_params
from collaborative_gan_sampling_tpu.evals import features as jfeat
from collaborative_gan_sampling_tpu.evals import fid as jfid
from collaborative_gan_sampling_tpu.sampling import fid_refine as jref
from tests.test_torch_models import to_numpy_tree

SHAPE, B = (28, 28, 1), 16


@pytest.fixture(scope="module")
def setup():
    jm = jfeat.SmallClassifier(num_classes=10)
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, *SHAPE)))
    tm = tfeat.SmallClassifier(1, 10)
    load_jax_params(tm, to_numpy_tree(params["params"]))
    tm.eval().requires_grad_(False)
    rng = np.random.default_rng(0)
    real = rng.uniform(-1, 1, (512, *SHAPE)).astype(np.float32) * 0.8
    x0 = rng.uniform(-1, 1, (B, *SHAPE)).astype(np.float32)
    j_fn = lambda x: jm.apply(params, x, return_features=True)  # noqa: E731
    t_fn = lambda x: tm(x, return_features=True)  # noqa: E731
    j_real = jfid.stats_from_features(j_fn(jnp.asarray(real)))
    t_real = tfid.FIDStats(*(torch.from_numpy(np.array(t)) for t in j_real))
    return j_fn, t_fn, j_real, t_real, x0


def test_fid_loss_value_and_gradient_match_jax(setup):
    j_fn, t_fn, j_real, t_real, x0 = setup
    want, want_g = jax.value_and_grad(
        lambda x: jref.fid_loss(x, j_fn, j_real))(jnp.asarray(x0))
    x = torch.from_numpy(x0).requires_grad_(True)
    got = tref.fid_loss(x, t_fn, t_real)
    (g,) = torch.autograd.grad(got, x)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-4)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=0,
                               atol=1e-3 * np.abs(want_g).max())


def test_fid_refine_steps_match_jax(setup):
    j_fn, t_fn, j_real, t_real, x0 = setup
    j_x, j_aux = jref.make_fid_refine_fn(j_fn, j_real, 3, 0.02)(
        jnp.asarray(x0))
    t_x, t_aux = tref.make_fid_refine_fn(t_fn, t_real, 3, 0.02)(
        torch.from_numpy(x0))
    np.testing.assert_allclose(t_x.numpy(), np.asarray(j_x), rtol=0,
                               atol=1e-5)
    for k in ("fid_start", "fid_end"):
        assert float(t_aux[k]) == pytest.approx(float(j_aux[k]), rel=1e-4)
    np.testing.assert_allclose(t_aux["fid_trajectory"].numpy(),
                               np.asarray(j_aux["fid_trajectory"]),
                               rtol=1e-4)
    assert float(t_aux["fid_end"]) < float(t_aux["fid_start"])
    # Each step moves a sample by at most the clip norm.
    step = (t_x - torch.from_numpy(x0)).flatten(1).norm(dim=1)
    assert float(step.max()) <= 3.0 + 1e-5


def test_fid_refine_zero_steps(setup):
    _, t_fn, _, t_real, x0 = setup
    x, aux = tref.make_fid_refine_fn(t_fn, t_real, 0, 0.02)(
        torch.from_numpy(x0))
    assert torch.equal(x, torch.from_numpy(x0))
    assert float(aux["fid_start"]) == float(aux["fid_end"])
    assert aux["fid_trajectory"].shape == (0,)
