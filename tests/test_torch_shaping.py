"""Parity of the port's D shaping (``training/shaping.py``) with the JAX
package's ``make_shaping_step``: params, BatchNorm statistics, loss and the
update count after one or two Adam steps on the same (real, refined) pair.

float32 on the CPU. Tolerance atol 1e-6 on params (an Adam step moves each
param by ~lr = 1e-4, and the two frameworks' gradients agree to ~1e-6
relative) and atol 1e-5 on BN statistics and the loss.

One exception: the bias of a conv that feeds a train-mode BatchNorm has a
gradient of exactly zero (BN subtracts the batch mean), so each framework
computes rounding noise of ~1e-7 there, which Adam's normalisation turns
into steps of either sign. Those biases are held to Adam's bound on one
update, lr * (1 - b1) / sqrt(1 - b2) (Kingma & Ba, section 2.1), instead, and the running mean of the BatchNorm
they feed, which takes (1 - momentum) = 0.1 of the bias shift at each of
the two train-mode passes of a step, is held to that share of the shift on
top of 1e-5. The running variance does not see a bias shift.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.training.shaping import ShapingStep
from collaborative_gan_sampling_torch.utils.weights import to_jax_variables
from collaborative_gan_sampling_tpu.training.shaping import make_shaping_step
from tests.test_torch_models import (
    TINY,
    assert_trees_close,
    make_pair,
    to_numpy_tree,
)

LR = 1e-4
ADAM_STEP_BOUND = LR * (1 - 0.5) / (1 - 0.999) ** 0.5


def _batches(jb, n_steps, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-1, 1, (4, *jb.data_shape)).astype(np.float32),
             rng.uniform(-1, 1, (4, *jb.data_shape)).astype(np.float32))
            for _ in range(n_steps)]


def _run_both(kw, n_steps=1, anchor=False, seed=51):
    jb, tb, _, d_vars, _, d = make_pair(TINY, seed=seed)
    j_step = make_shaping_step(jb, LR, **kw)
    t_step = ShapingStep(tb, LR, **kw)
    j_state, t_state = j_step.init(d_vars), t_step.init(d)
    j_anchor = d_vars["params"] if anchor else None
    t_anchor = ([p.detach().clone() for p in d.parameters()] if anchor
                else None)
    for x_real, x_fake in _batches(jb, n_steps):
        j_state, j_loss = j_step(j_state, jnp.asarray(x_real),
                                 jnp.asarray(x_fake), anchor_params=j_anchor)
        t_state, t_loss = t_step(t_state, torch.from_numpy(x_real),
                                 torch.from_numpy(x_fake),
                                 anchor_params=t_anchor)
        assert float(t_loss) == pytest.approx(float(j_loss), abs=1e-5)
    assert t_state.step == int(j_state.step)
    got, want = to_jax_variables(t_state.d), to_numpy_tree(j_state.d_vars)
    for name in want["params"]:
        bn = f"bn{name[4:]}"
        if name.startswith("conv") and bn in want["params"]:
            noise = np.abs(got["params"][name].pop("bias")
                           - want["params"][name].pop("bias")).max()
            assert noise <= 2 * ADAM_STEP_BOUND * n_steps
            np.testing.assert_allclose(
                got["batch_stats"][bn].pop("mean"),
                want["batch_stats"][bn].pop("mean"),
                atol=1e-5 + 2 * 0.1 * n_steps * noise)
    assert_trees_close(got["params"], want["params"], atol=1e-6)
    assert_trees_close(got["batch_stats"], want["batch_stats"], atol=1e-5)
    return d, t_state


@pytest.mark.parametrize("kw,n_steps", [
    (dict(), 1),
    (dict(), 2),
    (dict(decay=0.5), 2),
    (dict(r1_gamma=10.0), 2),
], ids=["one_step", "two_steps", "decay", "r1"])
def test_shaping_steps_match(kw, n_steps):
    d, state = _run_both(kw, n_steps)
    assert state.step == n_steps
    # The caller's D is not touched; shaping works on a copy.
    assert state.d is not d
    moved = [float((p - q).abs().max().detach()) for p, q in
             zip(d.parameters(), state.d.parameters())]
    assert max(moved) > 1e-5


def test_anchor_matches():
    _run_both(dict(anchor=50.0), n_steps=2, anchor=True)


def test_target_skip_leaves_state_unchanged():
    d, state = _run_both(dict(target=100.0), n_steps=1)
    assert state.step == 0
    for p, q in zip(d.parameters(), state.d.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    for b, c in zip(d.buffers(), state.d.buffers()):
        torch.testing.assert_close(b, c, rtol=0, atol=0)


def test_target_below_separation_applies():
    _, state = _run_both(dict(target=1e-9), n_steps=1, seed=52)
    assert state.step in (0, 1)  # decided by the data, identically to JAX
