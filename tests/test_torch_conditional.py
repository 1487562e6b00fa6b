"""Parity of the port's class-conditional DCGAN with the Flax models:
``Embed`` against ``nn.Embed``, the conditional G (``label_embed`` concatenated
to z) and the projection D (``proj_embed``) against ``DCGANGenerator`` /
``DCGANDiscriminator`` with ``num_classes=10``, their weights both ways and
checkpoints across the packages.

The model: 16x16x3, 8 filters, z = 16, 10 classes, its embeddings drawn
wider than the DCGAN init so that the label terms move the outputs. D's
features are 4 x 4 x 16 (a spatial side above 1), so a projection read in
another flattening order than NHWC would not match.

Tolerances: float32 atol 1e-5 (tests/test_torch_models.py's: the same
products summed in another order); weights and checkpoints exact. bfloat16:
the two frameworks round bf16 products and sums at other points (the
logits differ by one bf16 ulp), so the yardstick is JAX's own spread,
|JAX bf16 - JAX f32|: the port's bf16 is held to JAX's f32 within twice
that spread at most and 1.5 times it on the mean (measured, over eight
weight draws: 0.67 to 1.39 and 0.89 to 1.28 of it). It is held from below
too, so that a port computing in f32 fails: its outputs must be bf16
values, and its mean distance from JAX's f32 at least half the spread's
(0.89 at the least over those draws; an ``Embed`` that kept f32 rows gave
0.009 to 0.025 for G, and outputs off the bf16 grid for both G and D).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import serialization

from collaborative_gan_sampling_torch import config as tconfig
from collaborative_gan_sampling_torch.models import make_bundle as t_make_bundle
from collaborative_gan_sampling_torch.models.dcgan import (
    DCGANDiscriminator,
    DCGANGenerator,
)
from collaborative_gan_sampling_torch.ops.nn import Embed
from collaborative_gan_sampling_torch.training.gan import train_state_from
from collaborative_gan_sampling_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    state_dict,
)
from collaborative_gan_sampling_torch.utils.weights import (
    load_jax_variables,
    to_jax_variables,
)
from collaborative_gan_sampling_tpu import config as jconfig
from collaborative_gan_sampling_tpu.config import ModelConfig
from collaborative_gan_sampling_tpu.models import make_bundle
from collaborative_gan_sampling_tpu.ops.nn import dcgan_kernel_init
from collaborative_gan_sampling_tpu.utils import checkpoint as jckpt
from tests.test_torch_checkpoint import _cfgs, _np, assert_same_state
from tests.test_torch_models import (
    assert_trees_close,
    perturb,
    to_numpy_tree,
)
from tests.test_torch_train import jax_state, run_both

ATOL = 1e-5
COND = dict(kind="dcgan", z_dim=16, image_size=16, channels=3,
            g_base_filters=8, d_base_filters=8, num_classes=10,
            compute_dtype="float32")
COND_BF16 = dict(COND, compute_dtype="bfloat16")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch at one thread for the module, the count restored after it: the
    test workers share the host's cores, and at these sizes a torch op
    gains nothing from more threads than that (the ``imagenet64``
    experiment of tests/test_torch_conditional_pipeline.py took 39 s at
    the default count beside five other workers, 4 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_pair(model_kw, seed=0):
    """``make_pair``'s (jax bundle, torch bundle, g_vars, d_vars, g, d),
    the weights drawn by the port's DCGAN init (the same distributions as
    Flax's) and carried to JAX, and the same BN terms perturbed. Flax's
    init runs op by op, which costs ~15 s of compiles in each test process
    the first time; this costs none."""
    jb = make_bundle(ModelConfig(**model_kw))
    tb = t_make_bundle(tconfig.ModelConfig(**model_kw), device="cpu")
    g, d = tb.init(torch.Generator().manual_seed(seed))
    g_vars = perturb(to_jax_variables(g), seed + 1)
    d_vars = perturb(to_jax_variables(d), seed + 2)
    load_jax_variables(g, g_vars)
    load_jax_variables(d, d_vars)
    return jb, tb, g_vars, d_vars, g, d


def make_cond_pair(model_kw=COND, seed=0, proj_std=0.3):
    """``port_pair`` with the label embeddings redrawn at N(0, 0.3) (D's at
    N(0, proj_std)), so that G's label input and D's projection term weigh
    in."""
    jb, tb, g_vars, d_vars, g, d = port_pair(model_kw, seed=seed)
    rng = np.random.default_rng(seed + 3)
    for variables, name, std in ((g_vars, "label_embed", 0.3),
                                 (d_vars, "proj_embed", proj_std)):
        table = variables["params"][name]["embedding"]
        variables["params"][name]["embedding"] = (
            std * rng.standard_normal(table.shape)).astype(np.float32)
    load_jax_variables(g, g_vars)
    load_jax_variables(d, d_vars)
    return jb, tb, g_vars, d_vars, g, d


def inputs(jb, n=4, seed=0):
    """(z, x, labels) from a seeded numpy generator; the labels int32 for
    JAX, as numpy, and int64 for the port."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, jb.z_dim)).astype(np.float32)
    x = rng.uniform(-1, 1, (n, *jb.data_shape)).astype(np.float32)
    labels = rng.integers(0, jb.num_classes, n)
    return z, x, labels


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def test_embed_matches_flax():
    table = np.random.default_rng(1).standard_normal((7, 5)).astype(
        np.float32)
    idx = np.array([0, 6, 3, 3, 1])
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = fnn.Embed(7, 5, embedding_init=dcgan_kernel_init,
                         dtype=jdt).apply({"params": {"embedding": table}},
                                          jnp.asarray(idx))
        layer = Embed(7, 5, tdt)
        with torch.no_grad():
            layer.embedding.copy_(_t(table))
        got = layer(_t(idx))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.detach().float().numpy(),
                                      np.asarray(want, np.float32))


def test_embed_init_is_dcgan():
    layer = Embed(1000, 64)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    assert layer.embedding.shape == (1000, 64)
    assert float(layer.embedding.detach().std()) == pytest.approx(
        0.02, rel=0.02)


def test_weights_roundtrip():
    jb, _, g_vars, d_vars, g, d = make_cond_pair()
    assert g.label_embed.embedding.shape == (10, 64)
    assert d.proj_embed.embedding.shape == (10, 4 * 4 * 16)
    assert g.project.weight.shape[1] == jb.z_dim + 64
    assert_trees_close(to_jax_variables(g), g_vars, atol=0.0)
    assert_trees_close(to_jax_variables(d), d_vars, atol=0.0)
    # The Flax init builds the same tree as the port's modules.
    want = jax.tree.map(np.shape, jax.eval_shape(jb.init,
                                                 jax.random.PRNGKey(0)))
    got = jax.tree.map(np.shape, (to_jax_variables(g), to_jax_variables(d)))
    assert got == want


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_generator(train):
    jb, tb, g_vars, _, g, _ = make_cond_pair(seed=1)
    z, _, labels = inputs(jb, seed=2)
    out = jb.generate(g_vars, jnp.asarray(z), jnp.asarray(labels),
                      train=train)
    with torch.no_grad():
        got = tb.generate(g, _t(z), _t(labels), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(out[0] if train
                                                       else out), atol=ATOL)
    if train:
        assert_trees_close(to_jax_variables(g)["batch_stats"],
                           to_numpy_tree(out[1]["batch_stats"]))
    # The labels reach the samples: other labels, other images.
    with torch.no_grad():
        other = tb.generate(g, _t(z), _t((labels + 1) % 10), train=False)
        same = tb.generate(g, _t(z), _t(labels), train=False)
    assert float((other - same).abs().max()) > 100 * ATOL


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_projection_discriminator(train):
    jb, tb, _, d_vars, _, d = make_cond_pair(seed=4)
    _, x, labels = inputs(jb, seed=5)
    out = jb.discriminate(d_vars, jnp.asarray(x), jnp.asarray(labels),
                          train=train)
    with torch.no_grad():
        got = tb.discriminate(d, _t(x), _t(labels), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(out[0] if train
                                                       else out), atol=ATOL)
    if train:
        assert_trees_close(to_jax_variables(d)["batch_stats"],
                           to_numpy_tree(out[1]["batch_stats"]))


def test_projection_reads_features_in_nhwc_order():
    """D with its dense head zeroed is the projection term alone: it
    matches JAX, and a table permuted from NHWC to NCHW order does not."""
    jb, tb, _, d_vars, _, d = make_cond_pair(seed=6)
    d_vars["params"]["out"]["kernel"] = np.zeros_like(
        d_vars["params"]["out"]["kernel"])
    d_vars["params"]["out"]["bias"] = np.zeros_like(
        d_vars["params"]["out"]["bias"])
    load_jax_variables(d, d_vars)
    _, x, labels = inputs(jb, seed=7)
    want = np.asarray(jb.discriminate(d_vars, jnp.asarray(x),
                                      jnp.asarray(labels)))
    with torch.no_grad():
        got = tb.discriminate(d, _t(x), _t(labels)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)
        table = d.proj_embed.embedding
        d.proj_embed.embedding.copy_(table.reshape(10, 4, 4, 16).permute(
            0, 3, 1, 2).reshape(10, -1))
        permuted = tb.discriminate(d, _t(x), _t(labels)).numpy()
    assert np.abs(want).min() > 100 * ATOL
    assert np.abs(permuted - want).max() > 100 * ATOL


def test_bf16_within_jax_spread():
    """G and D at bf16 against JAX's f32, within JAX's own bf16-vs-f32
    spread."""
    jb, tb, g_vars, d_vars, g, d = make_cond_pair(COND_BF16, seed=8)
    jb32 = make_bundle(ModelConfig(**COND))
    z, x, labels = inputs(jb, n=8, seed=9)
    jz, jx, jl = jnp.asarray(z), jnp.asarray(x), jnp.asarray(labels)
    with torch.no_grad():
        got = (tb.generate(g, _t(z), _t(labels)).numpy(),
               tb.discriminate(d, _t(x), _t(labels)).numpy())
    want = (np.asarray(jb.generate(g_vars, jz, jl)),
            np.asarray(jb.discriminate(d_vars, jx, jl)))
    ref = (np.asarray(jb32.generate(g_vars, jz, jl)),
           np.asarray(jb32.discriminate(d_vars, jx, jl)))
    for a, b, r in zip(got, want, ref):
        spread = np.abs(b - r)
        assert spread.max() > 0
        assert np.abs(a - r).max() <= 2 * spread.max()
        assert np.abs(a - r).mean() <= 1.5 * spread.mean()
        # From below: computed in bf16, not f32. The outputs are bf16
        # values cast to f32 at the end, as JAX's are, and they sit as far
        # from JAX's f32 as JAX's own bf16 does.
        for out in (a, b):
            np.testing.assert_array_equal(
                out.astype(jnp.bfloat16).astype(np.float32), out)
        assert np.abs(a - r).mean() >= 0.5 * spread.mean()


def test_bundle_facts():
    jb, tb, _, _, g, d = make_cond_pair()
    assert tb.conditional and tb.num_classes == 10
    labels = tb.sample_labels(torch.Generator().manual_seed(0), 500)
    assert labels.shape == (500,) and labels.dtype == torch.int64
    assert int(labels.min()) == 0 and int(labels.max()) == 9
    z = tb.sample_z(None, 2)
    with pytest.raises(ValueError, match="needs labels"):
        tb.generate(g, z)
    with pytest.raises(ValueError, match="needs labels"):
        tb.discriminate(d, torch.zeros(2, 16, 16, 3))
    unc = t_make_bundle(tconfig.ModelConfig(**dict(COND, num_classes=0)),
                        device="cpu")
    assert unc.sample_labels(None, 3) is None
    with pytest.raises(ValueError, match="takes no labels"):
        unc.generate(unc.init(None)[0], z, labels[:2])


def test_imagenet64_pair_sizes():
    """The preset's pair at full width, built on the meta device: G ~12.1 M
    parameters (64 K of them label_embed), D ~22.0 M (12.29 M of them
    proj_embed, 1,000 x 12,288), as the JAX package's."""
    m = tconfig.get_preset("imagenet64").model
    with torch.device("meta"):
        g = DCGANGenerator(m.image_size, m.channels, m.g_base_filters,
                           m.z_dim, num_classes=m.num_classes)
        d = DCGANDiscriminator(m.image_size, m.channels, m.d_base_filters,
                               num_classes=m.num_classes)
    n_g = sum(p.numel() for p in g.parameters())
    n_d = sum(p.numel() for p in d.parameters())
    assert g.label_embed.embedding.numel() == 64_000
    assert tuple(d.proj_embed.embedding.shape) == (1000, 12_288)
    assert 12.0e6 < n_g < 12.2e6 and 21.9e6 < n_d < 22.1e6


# -- checkpoints across the packages ------------------------------------------

def _same_outputs(j_state, t_state, jb, tb):
    z, x, labels = inputs(jb, seed=11)
    jl = jnp.asarray(labels)
    with torch.no_grad():
        got = (tb.discriminate(t_state.d, _t(x), _t(labels)).numpy(),
               tb.generate(t_state.g, _t(z), _t(labels)).numpy())
    want = (jb.discriminate(j_state.d_vars, jnp.asarray(x), jl),
            jb.generate(j_state.g_vars, jnp.asarray(z), jl))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL)


def test_checkpoints_cross_both_ways(tmp_path):
    """A JAX checkpoint of the conditional pair restores in the port, and
    the port's in JAX, embeddings and their Adam moments included: the
    same arrays bit for bit and the same logits and samples."""
    jcfg, tcfg = _cfgs(COND)
    j_state, _, t_state, _, _ = run_both(COND, dict(steps_per_call=1),
                                        pair=port_pair)
    jb, tb, g_vars, d_vars, g, d = make_cond_pair(seed=12)  # other weights
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 1, j_state,
                                  config=jcfg)
    restored = restore_checkpoint(jpath, target=train_state_from(
        g, d, tcfg.train), config=tcfg)
    tree = state_dict(restored)
    assert "proj_embed" in tree["d_opt"]["0"]["mu"]
    assert_same_state(tree, _np(serialization.to_state_dict(j_state)))
    _same_outputs(j_state, restored, jb, tb)

    tpath = save_checkpoint(str(tmp_path / "t"), 1, t_state, config=tcfg)
    back = jckpt.restore_checkpoint(tpath, target=jax_state(
        g_vars, d_vars, jcfg.train), config=jcfg)
    assert_same_state(_np(serialization.to_state_dict(back)),
                      state_dict(t_state))
    _same_outputs(back, t_state, jb, tb)


def test_imagenet64_sidecar_is_the_same_in_both_packages(tmp_path):
    t, j = tconfig.get_preset("imagenet64"), jconfig.get_preset("imagenet64")
    assert t.to_dict() == j.to_dict()
    t_state = run_both(COND, dict(steps_per_call=1), pair=port_pair)[2]
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, {"step": np.int32(1)},
                          config=j)
    save_checkpoint(str(tmp_path / "t"), 1, t_state, config=t)
    sides = [(tmp_path / d / "config.json").read_bytes() for d in "jt"]
    assert sides[0] == sides[1]
