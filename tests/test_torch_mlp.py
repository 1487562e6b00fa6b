"""Parity of the port's MLP (G, D) (``models/mlp.py``) with the Flax models.

Same weights (carried by ``utils/weights.py``), same inputs from a seeded
numpy generator, float32 on the CPU; atol 1e-5 as for the DCGAN pair
(tests/test_torch_models.py): the two frameworks sum the same products in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.config import ModelConfig as TModelConfig
from collaborative_gan_sampling_torch.models import make_bundle as t_make_bundle
from collaborative_gan_sampling_torch.models.mlp import MLPDiscriminator
from collaborative_gan_sampling_torch.ops.nn import LECUN_TRUNC_STD
from collaborative_gan_sampling_torch.ops.refine_mlp import mlp_params_from_d
from collaborative_gan_sampling_torch.utils.weights import to_jax_variables
from collaborative_gan_sampling_tpu.config import ModelConfig
from collaborative_gan_sampling_tpu.models import make_bundle
from collaborative_gan_sampling_tpu.ops.refine_pallas import (
    _mlp_params_from_dvars,
)
from tests.test_torch_models import ATOL, assert_trees_close, make_pair

SMALL = dict(kind="mlp", z_dim=4, data_dim=2, g_hidden=16, d_hidden=16,
             g_layers=2, d_layers=2, compute_dtype="float32")
MID = dict(kind="mlp", z_dim=4, data_dim=2, g_hidden=64, d_hidden=64,
           g_layers=3, d_layers=3, compute_dtype="float32")
DEEP = dict(SMALL, d_hidden=8, d_layers=11)  # fc10 after fc9
TOY2D = dict(kind="mlp", z_dim=4, data_dim=2, g_hidden=128, d_hidden=128,
             g_layers=3, d_layers=3, compute_dtype="float32")
CASES = {"small": SMALL, "mid": MID, "deep": DEEP}


@pytest.mark.parametrize("name", list(CASES))
def test_weights_roundtrip(name):
    _, _, g_vars, d_vars, g, d = make_pair(CASES[name], seed=1)
    assert_trees_close(to_jax_variables(g), g_vars, atol=0.0)
    assert_trees_close(to_jax_variables(d), d_vars, atol=0.0)


@pytest.mark.parametrize("name", list(CASES))
def test_generator(name):
    jb, tb, g_vars, _, g, _ = make_pair(CASES[name], seed=2)
    z = np.random.default_rng(3).standard_normal((6, jb.z_dim), np.float32)
    want = jb.generate(g_vars, jnp.asarray(z), train=False)
    with torch.no_grad():
        got = tb.generate(g, torch.from_numpy(z), train=False)
    assert got.shape == (6, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_discriminator(name, train):
    jb, tb, _, d_vars, _, d = make_pair(CASES[name], seed=3)
    x = (np.random.default_rng(4).standard_normal((6, 2)) * 2).astype(
        np.float32)
    out = jb.discriminate(d_vars, jnp.asarray(x), train=train)
    want = out[0] if train else out  # no batch_stats: train is the same
    with torch.no_grad():
        got = tb.discriminate(d, torch.from_numpy(x), train=train)
    assert got.shape == (6,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_layer_order_beyond_ten_layers():
    """fc10 follows fc9 in the forward and in the kernel's parameter list,
    as in the JAX package's numeric sort."""
    _, _, _, d_vars, _, d = make_pair(DEEP, seed=5)
    names = [n for n, _ in d.named_children()]
    assert names == [f"fc{i}" for i in range(11)] + ["out"]
    want = _mlp_params_from_dvars(d_vars)
    got = mlp_params_from_d(d)
    assert len(got) == len(want) == 12
    for (w, b), (jw, jb_) in zip(got, want):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb_))


@pytest.mark.parametrize("which", ["g", "d"])
def test_init_is_lecun_normal(which):
    """Flax's default Dense init: a unit normal truncated at +-2, scaled to
    std sqrt(1 / fan_in); zero bias. Held as statistics (the two RNGs
    differ) against the same statistics of the JAX init."""
    tb = t_make_bundle(TModelConfig(**TOY2D), device="cpu")
    g, d = tb.init(torch.Generator().manual_seed(0))
    jvars = make_bundle(ModelConfig(**TOY2D)).init(jax.random.PRNGKey(0))
    module = {"g": g, "d": d}[which]
    jparams = jvars[0 if which == "g" else 1]["params"]
    for name, layer in module.named_children():
        w = layer.weight.detach().numpy()
        jw = np.asarray(jparams[name]["kernel"])
        fan_in = w.shape[1]
        std = np.sqrt(1.0 / fan_in)
        bound = 2.0 * std / LECUN_TRUNC_STD
        assert max(np.abs(w).max(), np.abs(jw).max()) <= bound + 1e-6
        assert not layer.bias.detach().any()
        if w.size >= 2048:  # enough draws for the std to settle
            # std of n draws is within ~3 / sqrt(2n) of its value
            tol = 3.0 * std / np.sqrt(2 * w.size)
            assert abs(w.std() - std) < tol, name
            assert abs(jw.std() - std) < tol, name
            assert abs(w.mean()) < 4 * std / np.sqrt(w.size), name


def test_init_draws_from_the_generator():
    tb = t_make_bundle(TModelConfig(**SMALL), device="cpu")
    a = tb.init(torch.Generator().manual_seed(7))
    b = tb.init(torch.Generator().manual_seed(7))
    c = tb.init(torch.Generator().manual_seed(8))
    for m1, m2, m3 in zip(a, b, c):
        for p1, p2, p3 in zip(m1.parameters(), m2.parameters(),
                              m3.parameters()):
            assert torch.equal(p1, p2)
            if p1.any():
                assert not torch.equal(p1, p3)


def test_bundle_facts():
    tb = t_make_bundle(TModelConfig(**SMALL, num_classes=3), device="cpu")
    assert tb.data_shape == (2,) and tb.z_dim == 4
    assert not tb.conditional  # as in JAX: the MLP pair is unconditional
    z = tb.sample_z(torch.Generator().manual_seed(0), 5)
    assert z.shape == (5, 4) and z.dtype == torch.float32
    g, d = tb.init(torch.Generator().manual_seed(0))
    assert isinstance(d, MLPDiscriminator) and not g.training


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown model kind"):
        t_make_bundle(TModelConfig(kind="vae"), device="cpu")
