"""The port's Inception-v3 (pool3) against the JAX package's on the same
variables, batch 2, with the preprocessing (grey tiled to 3 channels,
bilinear resize to 299) included; the resize alone at 28, 32 and 64 with
its edges; the variables files across the two packages; the torchvision /
pytorch-fid state-dict loaders of both.

The JAX variables come from ``jax.eval_shape`` of ``init`` filled with
seeded numpy (running ``init`` itself takes ~30 s on a CPU). Tolerances:
the resize at atol 1e-6 (the same taps and weights); pool3 features at
atol 2e-4 relative to their scale (float32 convs over 94 layers summed in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.evals import inception as tinc
from collaborative_gan_sampling_torch.evals.features import make_feature_fn
from collaborative_gan_sampling_torch.utils.weights import to_jax_variables
from collaborative_gan_sampling_tpu.evals import inception as jinc
from tests.test_torch_models import assert_trees_close


def _fill(tree, rng, path=()):
    """Seeded values of the shapes in ``tree``: lecun-scaled kernels, BN
    scale ~1, shift, mean ~0 and var in [0.5, 1.5]."""
    if hasattr(tree, "items"):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, leaf = tree.shape, path[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
                ).astype(np.float32)
    if leaf == "scale":
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    if leaf == "var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def variables():
    shapes = jax.eval_shape(
        lambda: jinc.InceptionV3Features().init(
            jax.random.PRNGKey(0), jnp.zeros((1, 299, 299, 3), jnp.float32)))
    return _fill(jax.tree_util.tree_map(lambda s: s, shapes),
                 np.random.default_rng(0))


@pytest.fixture(scope="module")
def port_net(variables):
    return tinc.load_inception_from_variables(variables, "cpu")


@pytest.mark.parametrize("size,channels", [(28, 1), (32, 3), (64, 1)])
def test_preprocess_matches_jax_resize(size, channels):
    x = np.random.default_rng(size).uniform(
        -1, 1, (2, size, size, channels)).astype(np.float32)
    want = np.asarray(jinc.preprocess_for_inception(jnp.asarray(x)))
    got = tinc.preprocess_for_inception(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # The edges: the outermost rows and columns take the edge pixels.
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(got[edge], want[edge], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, 0, 0, 0], x[:, 0, 0, 0], atol=1e-6)


def test_pool3_matches_jax(variables, port_net):
    x = np.random.default_rng(1).uniform(-1, 1, (2, 28, 28, 1)).astype(
        np.float32)
    want = np.asarray(jinc.InceptionV3Features().apply(
        variables, jinc.preprocess_for_inception(jnp.asarray(x))))
    with torch.no_grad():
        got = port_net(tinc.preprocess_for_inception(
            torch.from_numpy(x))).numpy()
    assert got.shape == (2, tinc.POOL3_DIM)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * float(np.abs(want).max()))


def test_variables_files_cross_both_ways(variables, port_net, tmp_path):
    jax_file = jinc.save_inception_params(str(tmp_path / "j.msgpack"),
                                          variables)
    assert_trees_close(to_jax_variables(tinc.load_inception(jax_file, "cpu")),
                       variables, atol=0.0)
    port_file = tinc.save_inception_params(str(tmp_path / "p.msgpack"),
                                           port_net)
    back = jinc.load_inception_variables(port_file)
    assert_trees_close(jax.tree_util.tree_map(np.asarray, back), variables,
                       atol=0.0)
    fn, label = make_feature_fn(f"inception:{port_file}", (28, 28, 1),
                                device="cpu")
    assert label == "inception_v3"
    assert fn(torch.zeros(1, 28, 28, 1)).shape == (1, 2048)
    bad = str(tmp_path / "bad.msgpack")
    with open(bad, "wb") as fh:
        from collaborative_gan_sampling_torch.utils import msgpack
        fh.write(msgpack.packb({"params": {"Conv2d_1a_3x3": {}}}))
    with pytest.raises(ValueError, match="parameter tree mismatch"):
        tinc.load_inception(bad, "cpu")


def test_torch_state_dict_loaders_agree(port_net):
    """A torchvision-named state dict (with the entries pool3 does not use)
    loads into the same net, and JAX's converter reads it to the same
    variables."""
    sd = {k: v.clone() for k, v in port_net.state_dict().items()}
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["Mixed_5b.branch1x1.bn.num_batches_tracked"] = torch.tensor(0)
    net = tinc.inception_from_torch_state_dict(sd, "cpu")
    want = to_jax_variables(port_net)
    assert_trees_close(to_jax_variables(net), want, atol=0.0)
    converted = jinc.params_from_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    assert_trees_close(jax.tree_util.tree_map(np.asarray, converted), want,
                       atol=0.0)
    del sd["Mixed_7c.branch_pool.bn.running_var"]
    with pytest.raises(ValueError, match="state dict lacks"):
        tinc.inception_from_torch_state_dict(sd, "cpu")
