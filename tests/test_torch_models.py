"""Parity of the PyTorch port's DCGAN (G, D) with the Flax models.

Same weights (carried by ``utils/weights.py``), same inputs from a seeded
numpy generator, float32 compute on the CPU. Tolerance atol 1e-5: the two
frameworks sum the same products in another order, which in float32 moves
activations of order 1 by ~1e-6.

The helpers here are shared by the other ``test_torch_*`` files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.config import ModelConfig as TModelConfig
from collaborative_gan_sampling_torch.models import make_bundle as t_make_bundle
from collaborative_gan_sampling_torch.utils.weights import (
    load_jax_variables,
    to_jax_variables,
)
from collaborative_gan_sampling_tpu.config import ModelConfig
from collaborative_gan_sampling_tpu.models import make_bundle

ATOL = 1e-5

TINY = dict(kind="dcgan", z_dim=8, image_size=16, channels=1,
            g_base_filters=8, d_base_filters=8, compute_dtype="float32")
MNIST = dict(kind="dcgan", z_dim=100, image_size=28, channels=1,
             g_base_filters=64, d_base_filters=64, compute_dtype="float32")


def to_numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def perturb(variables, seed):
    """Random BN scale/bias/statistics so that every term is exercised."""
    rng = np.random.default_rng(seed)
    out = to_numpy_tree(variables)
    for name, p in out["params"].items():
        if name.startswith("bn"):
            p["scale"] = (1.0 + 0.3 * rng.standard_normal(
                p["scale"].shape)).astype(np.float32)
            p["bias"] = (0.1 * rng.standard_normal(
                p["bias"].shape)).astype(np.float32)
        elif "bias" in p:
            p["bias"] = (0.05 * rng.standard_normal(
                p["bias"].shape)).astype(np.float32)
    for s in out.get("batch_stats", {}).values():
        s["mean"] = (0.2 * rng.standard_normal(s["mean"].shape)
                     ).astype(np.float32)
        s["var"] = rng.uniform(0.3, 1.5, s["var"].shape).astype(np.float32)
    return out


def make_pair(model_kw, seed=0):
    """(jax bundle, torch bundle, g_vars, d_vars, g, d) sharing weights."""
    jb = make_bundle(ModelConfig(**model_kw))
    g_vars, d_vars = jb.init(jax.random.PRNGKey(seed))
    g_vars, d_vars = perturb(g_vars, seed + 1), perturb(d_vars, seed + 2)
    tb = t_make_bundle(TModelConfig(**model_kw), device="cpu")
    g, d = tb.init(torch.Generator().manual_seed(seed))
    load_jax_variables(g, g_vars)
    load_jax_variables(d, d_vars)
    return jb, tb, g_vars, d_vars, g, d


def assert_trees_close(got, want, atol=ATOL, rtol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_trees_close(got[k], want[k], atol, rtol)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=atol, rtol=rtol)


@pytest.mark.parametrize("model_kw", [TINY, MNIST], ids=["tiny16", "mnist28"])
def test_weights_roundtrip(model_kw):
    _, _, g_vars, d_vars, g, d = make_pair(model_kw)
    assert_trees_close(to_jax_variables(g), g_vars, atol=0.0)
    assert_trees_close(to_jax_variables(d), d_vars, atol=0.0)


@pytest.mark.parametrize("model_kw", [TINY, MNIST], ids=["tiny16", "mnist28"])
def test_generator_eval(model_kw):
    jb, tb, g_vars, _, g, _ = make_pair(model_kw)
    z = np.random.default_rng(3).standard_normal((4, jb.z_dim), np.float32)
    want = jb.generate(g_vars, jnp.asarray(z), train=False)
    with torch.no_grad():
        got = tb.generate(g, torch.from_numpy(z), train=False)
    assert got.shape == (4, *jb.data_shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("model_kw", [TINY, MNIST], ids=["tiny16", "mnist28"])
def test_generator_train_updates_stats(model_kw):
    jb, tb, g_vars, _, g, _ = make_pair(model_kw)
    z = np.random.default_rng(4).standard_normal((4, jb.z_dim), np.float32)
    want, upd = jb.generate(g_vars, jnp.asarray(z), train=True)
    with torch.no_grad():
        got = tb.generate(g, torch.from_numpy(z), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert_trees_close(to_jax_variables(g)["batch_stats"],
                       to_numpy_tree(upd["batch_stats"]))


@pytest.mark.parametrize("model_kw", [TINY, MNIST], ids=["tiny16", "mnist28"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_discriminator(model_kw, train):
    jb, tb, _, d_vars, _, d = make_pair(model_kw)
    x = np.random.default_rng(5).uniform(
        -1, 1, (4, *jb.data_shape)).astype(np.float32)
    out = jb.discriminate(d_vars, jnp.asarray(x), train=train)
    with torch.no_grad():
        got = tb.discriminate(d, torch.from_numpy(x), train=train)
    want = out[0] if train else out
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if train:
        assert_trees_close(to_jax_variables(d)["batch_stats"],
                           to_numpy_tree(out[1]["batch_stats"]))


def test_transposed_conv_matches_lax_on_random_weights():
    """Pins the kernel flip, padding and crop of SameConvTranspose2d
    against Flax's ConvTranspose(padding='SAME') on random weights."""
    from flax import linen as fnn

    from collaborative_gan_sampling_torch.ops.nn import SameConvTranspose2d

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, 7, 3)).astype(np.float32)
    kernel = rng.standard_normal((5, 5, 3, 4)).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    want = fnn.ConvTranspose(4, (5, 5), strides=(2, 2), padding="SAME").apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x))
    layer = SameConvTranspose2d(3, 4)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(
            kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1].copy()))
        layer.bias.copy_(torch.from_numpy(bias))
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 4, 14, 14)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=ATOL)


def test_same_conv_padding_is_low1_high2():
    from collaborative_gan_sampling_torch.ops.nn import same_pads

    assert same_pads(28, 5, 2) == (1, 2)
    assert same_pads(14, 5, 2) == (1, 2)
