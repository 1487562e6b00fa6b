"""The port's feature nets against the JAX package's on the same weights:
``RandomConvFeatures`` and ``SmallClassifier`` at 28x28x1 and 32x32x3 (the
stride-2 SAME convs pad (0, 1) or (1, 1) by input size, and a stage keeps
stride 2 only while min(H, W) >= 2), the RotNet rotations, and a few Adam
steps of ``train_classifier_features`` / ``train_rotation_features`` from
the same init on the same batches and rotations.

Tolerances: forward features at atol 1e-5 relative to their scale (float32
convs summed in another order); parameters after 3 Adam steps at atol
5e-5, 5% of lr = 1e-3: Adam's first steps are ~lr * g / (|g| + 1e-8), so a
gradient within float32 rounding of 0 moves its parameter by a different
part of lr (2 of 73,728 elements differed, by up to 1.5e-5, measured on
a CPU; all others by less than 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.evals import features as tfeat
from collaborative_gan_sampling_torch.utils.weights import (
    load_jax_params,
    params_to_flax,
)
from collaborative_gan_sampling_tpu.evals import features as jfeat
from tests.test_torch_models import assert_trees_close, to_numpy_tree

SHAPES = [(28, 28, 1), (32, 32, 3)]


def _images(n, shape, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, *shape)).astype(np.float32)


def _carried(jmodule, tmodule, shape, seed=0):
    params = jmodule.init(jax.random.PRNGKey(seed),
                          jnp.zeros((1, *shape), jnp.float32))
    load_jax_params(tmodule, to_numpy_tree(params["params"]))
    return params, tmodule.eval()


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("shape", SHAPES, ids=["28x28x1", "32x32x3"])
def test_random_conv_features_match_jax(shape):
    jm = jfeat.RandomConvFeatures()
    params, tm = _carried(jm, tfeat.RandomConvFeatures(shape[-1]), shape)
    x = _images(4, shape, 1)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (4, 512)
    _close(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=["28x28x1", "32x32x3"])
def test_small_classifier_matches_jax(shape):
    jm = jfeat.SmallClassifier(num_classes=10)
    params, tm = _carried(jm, tfeat.SmallClassifier(shape[-1], 10), shape)
    x = _images(4, shape, 2)
    for feats in (True, False):
        want = np.asarray(jm.apply(params, jnp.asarray(x),
                                   return_features=feats))
        got = tm(torch.from_numpy(x), return_features=feats).detach().numpy()
        assert got.shape == (4, 256 if feats else 10)
        _close(got, want)


def test_same_padding_and_stride_rule():
    """28 -> 14 -> 7 -> 4 -> 2: a symmetric padding=1 conv would give the
    same sizes but other values; and a 1x1 input keeps stride 1."""
    tm = tfeat.RandomConvFeatures(1)
    tm.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images(2, (28, 28, 1), 3)).permute(0, 3, 1, 2)
    h = tm.conv0(x, stride=2)
    assert h.shape[-2:] == (14, 14)
    sym = torch.nn.functional.conv2d(x, tm.conv0.weight, tm.conv0.bias,
                                     stride=2, padding=1)
    assert sym.shape == h.shape and not torch.allclose(sym, h)
    assert tfeat._stride(torch.zeros(1, 3, 1, 5)) == 1
    assert tfeat._stride(torch.zeros(1, 3, 2, 2)) == 2


def test_rotate_batch_matches_jax_rot90():
    x = _images(5, (6, 6, 2), 4)
    k = np.array([0, 1, 2, 3, 1])
    got = tfeat.rotate_batch(torch.from_numpy(x), torch.from_numpy(k))
    for i in range(5):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(jnp.rot90(jnp.asarray(x[i:i + 1]),
                                                 k[i], axes=(1, 2)))[0])


STEPS, BATCH, SEED = 3, 8, 5
SHAPE = (28, 28, 1)


def _jax_data(key, n):
    x = jax.random.uniform(key, (n, *SHAPE), minval=-1.0, maxval=1.0)
    y = jax.random.randint(jax.random.fold_in(key, 1), (n,), 0, 10)
    return x, y


def _init(num_classes):
    """The JAX trainer's init (fold_in(PRNGKey(seed), 0)) in both."""
    params = jfeat.SmallClassifier(num_classes=num_classes).init(
        jax.random.fold_in(jax.random.PRNGKey(SEED), 0),
        jnp.zeros((1, *SHAPE), jnp.float32))
    tm = tfeat.SmallClassifier(1, num_classes)
    load_jax_params(tm, to_numpy_tree(params["params"]))
    return tm


def _replay(items):
    """A port data_fn that hands out ``items`` in turn."""
    it = iter(items)
    return lambda gen, n: next(it)


def test_train_classifier_steps_match_jax():
    _, info = jfeat.train_classifier_features(_jax_data, 10, SHAPE,
                                              steps=STEPS, batch=BATCH,
                                              seed=SEED)
    key = jax.random.PRNGKey(SEED)
    batches = [tuple(torch.from_numpy(np.array(t)) for t in
                     _jax_data(jax.random.fold_in(key, 1 + i), BATCH))
               for i in range(STEPS)]
    fn, got = tfeat.train_classifier_features(
        _replay(batches), 10, SHAPE, steps=STEPS, batch=BATCH, seed=SEED,
        device="cpu", init=_init(10))
    assert_trees_close(params_to_flax(got["module"]),
                       to_numpy_tree(info["params"]["params"]), atol=5e-5)
    assert got["final_loss"] == pytest.approx(float(info["final_loss"]),
                                              rel=1e-5)
    assert fn(batches[0][0]).shape == (BATCH, 256)


def test_train_rotation_steps_match_jax(monkeypatch):
    def x_only(key, n):
        return _jax_data(key, n)[0]

    _, info = jfeat.train_rotation_features(x_only, SHAPE, steps=STEPS,
                                            batch=BATCH, seed=SEED)
    key = jax.random.PRNGKey(SEED)
    xs, rots = [], []
    for i in range(STEPS):
        k_i = jax.random.fold_in(key, 1 + i)
        xs.append(torch.from_numpy(np.array(
            x_only(jax.random.fold_in(k_i, 0), BATCH))))
        rots.append(torch.from_numpy(np.array(jax.random.randint(
            jax.random.fold_in(k_i, 1), (BATCH,), 0, 4))))
    monkeypatch.setattr(tfeat, "draw_rotations", _replay(rots))
    _, got = tfeat.train_rotation_features(
        _replay(xs), SHAPE, steps=STEPS, batch=BATCH, seed=SEED,
        device="cpu", init=_init(4))
    assert_trees_close(params_to_flax(got["module"]),
                       to_numpy_tree(info["params"]["params"]), atol=5e-5)
    assert got["final_loss"] == pytest.approx(float(info["final_loss"]),
                                              rel=1e-5)


def test_make_feature_fn_labels_and_errors():
    fn, label = tfeat.make_feature_fn("random_conv", SHAPE, device="cpu")
    assert label == "torch/random_conv"
    assert fn(torch.zeros(2, *SHAPE)).shape == (2, 512)
    with pytest.raises(FileNotFoundError, match="Inception weight file"):
        tfeat.make_feature_fn("inception:/nonexistent.msgpack", SHAPE,
                              device="cpu")
    with pytest.raises(ValueError, match="unknown feature spec"):
        tfeat.make_feature_fn("vgg", SHAPE, device="cpu")
