"""End-to-end parity of the port's collab sampling with the JAX package's, at
the tiny DCGAN of ``__graft_entry__._dryrun_multichip_body`` made
unconditional (16x16x1, 8 filters, z = 8), float32, 3 rounds, shaping every
round.

The port is fed the JAX side's draws by replaying its key splits:
``k_burn, k_main = split(key)``; burn round i draws z from
``split(fold_in(k_burn, i))[0]``; main round i splits
``fold_in(k_main, i)`` into (k_draw, k_acc, k_real, k_shape) and draws z from
``split(k_draw)[0]``, u from ``uniform(k_acc, (n,))`` and real batch j from
``data_fn(fold_in(k_real, j), n)``.

Tolerances: samples and logits atol 1e-4. Each shaping step moves the bias
of conv1, which feeds a train-mode BatchNorm and so has a gradient of pure
rounding noise, by up to Adam's step bound (see tests/test_torch_shaping.py);
in eval mode that shift reaches the next rounds' D. The shaped params are
held as in test_torch_shaping.py. The accept masks must be equal: no u here
lies within float32 rounding of its acceptance probability.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.config import RefineConfig as TRefineConfig
from collaborative_gan_sampling_torch.sampling import collab as t_collab
from collaborative_gan_sampling_torch.sampling.collab import sample as t_sample
from collaborative_gan_sampling_torch.utils.weights import to_jax_variables
from collaborative_gan_sampling_tpu.config import RefineConfig
from collaborative_gan_sampling_tpu.sampling import sample
from tests.test_torch_models import TINY, make_pair, to_numpy_tree
from tests.test_torch_shaping import ADAM_STEP_BOUND

B, ROUNDS = 8, 3
RCFG = dict(steps=2, rate=0.05, num_batches=ROUNDS, batch_size=B, burn_in=B,
            shape_every=1, shaping_lr=1e-4)


def _data_fn(key, n):
    return jax.random.uniform(key, (n, 16, 16, 1), minval=-1.0,
                              maxval=1.0), None


def _replayed_draws(key, cfg, z_dim):
    """The z, u and real batches the JAX collab run draws, in call order."""
    k_burn, k_main = jax.random.split(key)
    zs, us, reals = [], [], []

    def z_of(k):
        return np.array(jax.random.normal(jax.random.split(k)[0],
                                          (B, z_dim), dtype=jnp.float32))

    for i in range(max(1, cfg.burn_in // cfg.batch_size)):
        zs.append(z_of(jax.random.fold_in(k_burn, i)))
    for i in range(cfg.num_batches):
        k_draw, k_acc, k_real, _ = jax.random.split(
            jax.random.fold_in(k_main, i), 4)
        zs.append(z_of(k_draw))
        us.append(np.array(jax.random.uniform(k_acc, (B,))))
        if i % cfg.shape_every == 0:
            for j in range(cfg.shaping_steps):
                reals.append(np.array(_data_fn(jax.random.fold_in(k_real, j),
                                               B)[0]))
    return zs, us, reals


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["kernel_entry", "torch_draw"])
def test_collab_matches_jax(use_pallas, monkeypatch):
    jb, tb, g_vars, d_vars, g, d = make_pair(TINY, seed=61)
    key = jax.random.PRNGKey(1)
    jcfg = RefineConfig(use_pallas=use_pallas, **RCFG)
    want = sample(jb, g_vars, d_vars, jcfg, key, method="collab",
                  data_fn=_data_fn)

    zs, us, reals = _replayed_draws(key, jcfg, jb.z_dim)
    monkeypatch.setattr(type(tb), "sample_z",
                        lambda self, gen, n: torch.from_numpy(zs.pop(0)))
    real_accept = t_collab.drs_accept_mask

    def accept_with_u(gen, logits, *args, **kw):
        return real_accept(gen, logits, *args,
                           uniforms=torch.from_numpy(us.pop(0)), **kw)

    monkeypatch.setattr(t_collab, "drs_accept_mask", accept_with_u)
    got = t_sample(tb, g, d, TRefineConfig(use_pallas=use_pallas, **RCFG),
                   None, method="collab",
                   data_fn=lambda gen, n: (torch.from_numpy(reals.pop(0)),
                                           None))
    assert not zs and not us and not reals  # every draw was consumed

    np.testing.assert_allclose(got.samples.numpy(), np.asarray(want.samples),
                               atol=1e-4)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=1e-4)
    np.testing.assert_array_equal(got.accepted.numpy(),
                                  np.asarray(want.accepted))
    assert 0 < float(got.accepted.float().mean()) < 1
    assert got.aux["shaping_steps_done"] == int(
        want.aux["shaping_steps_done"]) == ROUNDS
    np.testing.assert_allclose(float(got.aux["logit_max"]),
                               float(want.aux["logit_max"]), atol=1e-4)

    shaped = to_jax_variables(got.aux["shaped_d"])
    ref = to_numpy_tree(want.aux["shaped_d_vars"])
    noise = np.abs(shaped["params"]["conv1"].pop("bias")
                   - ref["params"]["conv1"].pop("bias")).max()
    assert noise <= 2 * ADAM_STEP_BOUND * ROUNDS
    for name in ref["params"]:
        for leaf in ref["params"][name]:
            np.testing.assert_allclose(shaped["params"][name][leaf],
                                       ref["params"][name][leaf], atol=1e-5,
                                       err_msg=f"{name}/{leaf}")
    np.testing.assert_allclose(shaped["batch_stats"]["bn1"]["var"],
                               ref["batch_stats"]["bn1"]["var"], atol=1e-4)
    # The caller's D is left as it was.
    assert to_jax_variables(d)["params"]["out"]["kernel"].tolist() == \
        to_numpy_tree(d_vars)["params"]["out"]["kernel"].tolist()
