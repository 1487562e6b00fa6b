"""The port's TF1 migration (``compat/tf1_import.py``, ``tf1_export.py``,
``tf1_graph.py``, ``cli import-tf1``) against the JAX package's.

* A Saver checkpoint that TensorFlow writes with the reference's names is
  imported by both packages: the same Flax-layout trees, and the port's G
  outputs and D logits equal JAX's within 1e-5 (float32), for a small
  DCGAN and for the MLP; both within JAX ``test_tf1_import.py``'s bounds of
  the TF1 graph's own outputs.
* Export -> import round-trips bit for bit; a real Saver checkpoint does.
* ``state_to_tf1`` gives the same names and arrays as JAX's on the same
  weights, raw and EMA.
* ``TF1RefineLoop``'s logits against the port's D, and its refined pool
  against the port's plain refinement, at JAX
  ``test_tf1_export.py:94-137``'s tolerances.
* ``cli import-tf1 ... --device cpu`` then ``cli collab`` runs; the
  imported checkpoint is finished (``load_or_train`` does not train).
* The error cases of JAX ``test_tf1_import.py:139``, ``:204``, and the
  traps: an ambiguous suffix names its candidates, ``scale=False`` batch
  norms have no gamma, optimizer slots are not parameters, conditional
  DCGANs are refused both ways.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow").compat.v1

import jax.numpy as jnp  # noqa: E402

from collaborative_gan_sampling_torch import cli  # noqa: E402
from collaborative_gan_sampling_torch.compat import tf1_export  # noqa: E402
from collaborative_gan_sampling_torch.compat import tf1_import  # noqa: E402
from collaborative_gan_sampling_torch.compat.tf1_graph import (  # noqa: E402
    TF1RefineLoop,
)
from collaborative_gan_sampling_torch.config import (  # noqa: E402
    ModelConfig,
    RefineConfig,
    TrainConfig,
    apply_overrides,
    get_preset,
)
from collaborative_gan_sampling_torch.models import make_bundle  # noqa: E402
from collaborative_gan_sampling_torch.pipeline import Experiment  # noqa: E402
from collaborative_gan_sampling_torch.sampling.refine import (  # noqa: E402
    make_refine_fn,
)
from collaborative_gan_sampling_torch.training.gan import (  # noqa: E402
    create_train_state,
)
from collaborative_gan_sampling_torch.utils.weights import (  # noqa: E402
    load_jax_variables,
    params_to_flax,
    to_jax_variables,
)
from collaborative_gan_sampling_tpu import config as jconfig  # noqa: E402
from collaborative_gan_sampling_tpu.compat import (  # noqa: E402
    tf1_export as j_export,
)
from collaborative_gan_sampling_tpu.compat import (  # noqa: E402
    tf1_import as j_import,
)
from collaborative_gan_sampling_tpu.models import (  # noqa: E402
    make_bundle as j_make_bundle,
)

ATOL = 1e-5
DCGAN = dict(kind="dcgan", z_dim=8, image_size=16, channels=1,
             g_base_filters=8, d_base_filters=8, compute_dtype="float32")
MLP = dict(kind="mlp", z_dim=4, data_dim=2, g_hidden=32, g_layers=3,
           d_hidden=32, d_layers=3, compute_dtype="float32")
MLP_FLAGS = ["model.z_dim=4", "model.g_hidden=32", "model.g_layers=3",
             "model.d_hidden=32", "model.d_layers=3"]


def _var(rng, name, shape, positive=False):
    init = (rng.uniform(0.5, 1.5, shape) if positive
            else rng.standard_normal(shape) * 0.2).astype(np.float32)
    return tf.get_variable(name, initializer=tf.constant(init))


def _bn_eval(rng, x, scope, scale=True):
    with tf.variable_scope(scope):
        c = int(x.shape[-1])
        gamma = _var(rng, "gamma", (c,), positive=True) if scale else None
        beta = _var(rng, "beta", (c,))
        mean = _var(rng, "moving_mean", (c,))
        var = _var(rng, "moving_variance", (c,), positive=True)
    return tf.nn.batch_normalization(x, mean, var, beta, gamma, 1e-5)


def _linear(rng, x, out_dim, scope, w="Matrix", b="bias"):
    with tf.variable_scope(scope):
        kernel = _var(rng, w, (int(x.shape[-1]), out_dim))
        bias = _var(rng, b, (out_dim,))
    return tf.matmul(x, kernel) + bias


def _conv(rng, x, out_ch, scope):
    with tf.variable_scope(scope):
        w = _var(rng, "w", (5, 5, int(x.shape[-1]), out_ch))
        b = _var(rng, "biases", (out_ch,))
    return tf.nn.bias_add(
        tf.nn.conv2d(x, w, strides=[1, 2, 2, 1], padding="SAME"), b)


def _deconv(rng, x, out_ch, scope):
    b_, h, w_, in_ch = [int(s) for s in x.shape]
    with tf.variable_scope(scope):
        w = _var(rng, "w", (5, 5, out_ch, in_ch))
        b = _var(rng, "biases", (out_ch,))
    y = tf.nn.conv2d_transpose(x, w, output_shape=[b_, 2 * h, 2 * w_, out_ch],
                               strides=[1, 2, 2, 1], padding="SAME")
    return tf.nn.bias_add(y, b)


def _dcgan_graph(rng, batch, bn_scale=True):
    """The reference-named 16x16 DCGAN (2 stages), eval-mode forward, with
    an Adam slot and ``beta1_power`` beside the weights, as a real Saver
    checkpoint has them."""
    z_ph = tf.placeholder(tf.float32, (batch, 8), name="z")
    x_ph = tf.placeholder(tf.float32, (batch, 16, 16, 1), name="x")
    with tf.variable_scope("generator"):
        h = tf.reshape(_linear(rng, z_ph, 4 * 4 * 16, "g_h0_lin"),
                       (batch, 4, 4, 16))
        h = tf.nn.relu(_bn_eval(rng, h, "g_bn0", bn_scale))
        h = tf.nn.relu(_bn_eval(rng, _deconv(rng, h, 8, "g_h1"), "g_bn1",
                                bn_scale))
        gen = tf.nn.tanh(_deconv(rng, h, 1, "g_h2"))
    with tf.variable_scope("discriminator"):
        h = tf.nn.leaky_relu(_conv(rng, x_ph, 8, "d_h0_conv"), alpha=0.2)
        h = tf.nn.leaky_relu(_bn_eval(rng, _conv(rng, h, 16, "d_h1_conv"),
                                      "d_bn1", bn_scale), alpha=0.2)
        logit = _linear(rng, tf.reshape(h, (batch, 256)), 1, "d_h2_lin")
    tf.get_variable("generator/g_h0_lin/Matrix/Adam",
                    initializer=tf.zeros((8, 256)))
    tf.get_variable("beta1_power", initializer=tf.constant(0.5))
    return z_ph, x_ph, gen, logit


def _mlp_graph(rng, batch):
    """Synthetic-stack MLPs under two namings: TF-layers style (dense,
    dense_1, ...) under ``generator`` and ``d_fc{i}/{w,b}`` for D."""
    z_ph = tf.placeholder(tf.float32, (batch, 4), name="z")
    x_ph = tf.placeholder(tf.float32, (batch, 2), name="x")
    h = z_ph
    with tf.variable_scope("generator"):
        for scope in ["dense", "dense_1", "dense_2"]:
            h = tf.nn.relu(_linear(rng, h, 32, scope))
        gen = _linear(rng, h, 2, "dense_3")
    h = x_ph
    for i in range(3):
        h = tf.nn.relu(_linear(rng, h, 32, f"d_fc{i}", "w", "b"))
    logit = _linear(rng, h, 1, "d_out", "w", "b")
    return z_ph, x_ph, gen, logit


def _saved(kind, ckpt_dir, batch=4, step=25_000, **graph_kw):
    """Run the TF1 graph and save a Saver checkpoint: (z, x, TF's G
    output, TF's D logits)."""
    rng = np.random.default_rng(42)
    zdim, xshape = (8, (16, 16, 1)) if kind == "dcgan" else (4, (2,))
    z = rng.standard_normal((batch, zdim)).astype(np.float32)
    x = rng.standard_normal((batch, *xshape)).astype(np.float32)
    build = _dcgan_graph if kind == "dcgan" else _mlp_graph
    with tf.Graph().as_default():
        z_ph, x_ph, gen, logit = build(rng, batch, **graph_kw)
        with tf.Session() as sess:
            sess.run(tf.global_variables_initializer())
            g_out, d_out = sess.run([gen, logit], {z_ph: z, x_ph: x})
            tf.train.Saver().save(sess, os.path.join(str(ckpt_dir), "model"),
                                  global_step=step)
    return z, x, g_out, d_out[:, 0]


def _modules(source, cfg, device):
    """The imported (G, D) as the port's modules."""
    g_vars, d_vars = tf1_import.import_tf1(source, cfg)
    g, d = make_bundle(cfg, device).init(torch.Generator().manual_seed(0))
    return load_jax_variables(g, g_vars), load_jax_variables(d, d_vars)


def _assert_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("kind", ["dcgan", "mlp"])
def test_saver_checkpoint_imports_as_jax_does(tmp_path, kind):
    model = DCGAN if kind == "dcgan" else MLP
    z, x, g_tf, d_tf = _saved(kind, tmp_path)
    tf_vars = tf1_import.read_tf1_checkpoint(str(tmp_path))  # directory
    if kind == "dcgan":  # optimizer slots beside the weights
        assert "beta1_power" in tf_vars
    t_trees = tf1_import.import_tf1(tf_vars, ModelConfig(**model))
    j_trees = j_import.import_tf1(str(tmp_path),
                                  jconfig.ModelConfig(**model))
    for t, j in zip(t_trees, j_trees):
        _assert_trees_equal(t, j)

    g, d = _modules(str(tmp_path), ModelConfig(**model),
                                  device="cpu")
    tb = make_bundle(ModelConfig(**model), "cpu")
    jb = j_make_bundle(jconfig.ModelConfig(**model))
    with torch.no_grad():
        g_t = tb.generate(g, torch.from_numpy(z)).numpy()
        d_t = tb.discriminate(d, torch.from_numpy(x)).numpy()
    g_j = np.asarray(jb.generate(j_trees[0], jnp.asarray(z), train=False))
    d_j = np.asarray(jb.discriminate(j_trees[1], jnp.asarray(x),
                                     train=False))
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=ATOL)
    # The reference graph's own outputs, at JAX test_tf1_import's bounds.
    np.testing.assert_allclose(g_t, g_tf, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(d_t, d_tf, rtol=1e-4, atol=1e-4)


def _pair(model, seed=0):
    bundle = make_bundle(ModelConfig(**model), "cpu")
    g, d = bundle.init(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # non-trivial BN terms
        for t in list(g.buffers()) + list(d.buffers()):
            t.add_(torch.rand(t.shape, generator=torch.Generator()
                              .manual_seed(seed + 5)))
    return bundle, g, d


@pytest.mark.parametrize("model", [DCGAN, MLP], ids=["dcgan", "mlp"])
def test_export_import_roundtrip(model):
    cfg = ModelConfig(**model)
    _, g, d = _pair(model)
    g2, d2 = _modules(tf1_export.export_tf1(g, d, cfg), cfg,
                                    device="cpu")
    for a, b in ((g, g2), (d, d2)):
        for t1, t2 in zip(a.state_dict().values(), b.state_dict().values()):
            assert torch.equal(t1, t2)


def test_saver_write_roundtrip(tmp_path):
    cfg = ModelConfig(**MLP)
    _, g, d = _pair(MLP)
    tf_vars = tf1_export.export_tf1(g, d, cfg)
    prefix = tf1_export.write_tf1_checkpoint(tf_vars,
                                             str(tmp_path / "model-100"))
    assert prefix == str(tmp_path / "model-100")
    back = tf1_import.read_tf1_checkpoint(str(tmp_path))
    assert sorted(back) == sorted(tf_vars)
    for name, arr in tf_vars.items():
        np.testing.assert_array_equal(back[name], arr)


@pytest.mark.parametrize("model,use_ema", [(DCGAN, False), (DCGAN, True),
                                           (MLP, True)],
                         ids=["dcgan", "dcgan-ema", "mlp-ema"])
def test_state_to_tf1_matches_jax(model, use_ema):
    cfg = ModelConfig(**model)
    bundle, g, d = _pair(model)
    state = create_train_state(bundle, TrainConfig(g_ema_decay=0.9), 0)
    state.g.load_state_dict(g.state_dict())
    state.d.load_state_dict(d.state_dict())
    with torch.no_grad():
        for p in state.g_ema.parameters():
            p.mul_(0.5)
    got = tf1_export.state_to_tf1(state, cfg, use_ema=use_ema)
    jstate = SimpleNamespace(g_vars=to_jax_variables(state.g),
                             d_vars=to_jax_variables(state.d),
                             g_ema=params_to_flax(state.g_ema))
    want = j_export.state_to_tf1(jstate, jconfig.ModelConfig(**model),
                                 use_ema=use_ema)
    _assert_trees_equal(got, want)
    state.g_ema = None
    with pytest.raises(ValueError, match="EMA"):
        tf1_export.state_to_tf1(state, cfg, use_ema=True)


@pytest.mark.parametrize("model,shape,tol", [
    (MLP, (32, 2), 1e-5), (DCGAN, (8, 16, 16, 1), 1e-4)],
    ids=["mlp", "dcgan"])
def test_tf1_loop_matches_port(model, shape, tol):
    """The reference's D graph from exported weights scores as the port's
    D does, and its per-step sess.run loop refines as the port's plain
    refinement does, from the same x0."""
    cfg = ModelConfig(**model)
    bundle, g, d = _pair(model)
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    x0 = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    loop = TF1RefineLoop(tf1_export.export_tf1(g, d, cfg), cfg, shape)
    try:
        logits_tf = loop.score(x)
        x_tf, _ = loop.refine(x0, steps=8, rate=0.05)
    finally:
        loop.close()
    with torch.no_grad():
        want = bundle.discriminate(d, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(logits_tf, want, rtol=1e-4, atol=1e-5)
    rcfg = RefineConfig(steps=8, rate=0.05, use_pallas=False)
    x_port, aux = make_refine_fn(bundle, rcfg)(d, torch.from_numpy(x0))
    np.testing.assert_allclose(x_port.numpy(), x_tf, rtol=tol, atol=tol)
    with torch.no_grad():
        at_tf = bundle.discriminate(d, torch.from_numpy(x_tf)).numpy()
    np.testing.assert_allclose(aux["logits"].numpy(), at_tf, rtol=1e-3,
                               atol=1e-3)


def test_cli_import_tf1_then_collab(tmp_path, capsys):
    z, _, g_tf, _ = _saved("mlp", tmp_path / "tf1", step=3)
    wd = tmp_path / "wd"
    common = ["--config", "toy2d", "--device", "cpu", "--workdir", str(wd),
              *MLP_FLAGS, "train.niters=7", "refine.batch_size=32",
              "refine.num_batches=2", "refine.burn_in=64"]
    assert cli.main(["import-tf1", *common, f"tf1={tmp_path / 'tf1'}"]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["checkpoint"].endswith("ckpt_00000007.msgpack")
    assert cli.main(["collab", *common]) == 0
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert row["method"] == "collab" and np.isfinite(row["pct_hq"])
    assert not (wd / "train.jsonl").exists()  # restored, not trained
    # tf1= and step= are import-tf1's keys only.
    with pytest.raises(KeyError, match="no field 'step'"):
        cli.main(["collab", *common, "step=3"])
    assert cli.main(["import-tf1", *common]) == 2  # no tf1=


def test_tf1_to_checkpoint_feeds_load_or_train(tmp_path):
    _, g, d = _pair(MLP)
    cfg = apply_overrides(get_preset("toy2d"), MLP_FLAGS + [
        "train.niters=7", "train.g_ema_decay=0.9"]).replace(
        workdir=str(tmp_path))
    tf_vars = tf1_export.export_tf1(g, d, cfg.model)
    path = tf1_import.tf1_to_checkpoint(tf_vars, cfg, device="cpu")
    assert os.path.exists(path)
    state = Experiment(cfg, echo_metrics=False, device="cpu").load_or_train()
    assert state.step == 7  # a finished run, not resumed
    for a, b in zip(g.parameters(), state.g.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(g.parameters(), state.g_ema.parameters()):
        assert torch.equal(a, b)  # the EMA starts at the imported G
    for opt in (state.g_opt, state.d_opt):  # fresh Adam states
        for st in opt.state.values():
            assert float(st["step"]) == 0
            assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()


def test_dcgan_import_rejects_conditional_and_bad_shapes(tmp_path):
    _saved("dcgan", tmp_path)
    tf_vars = tf1_import.read_tf1_checkpoint(str(tmp_path))
    cfg = ModelConfig(**DCGAN)
    with pytest.raises(tf1_import.TF1ImportError, match="unconditional"):
        tf1_import.import_dcgan(tf_vars,
                                dataclasses.replace(cfg, num_classes=10))
    with pytest.raises(tf1_import.TF1ImportError, match="shape"):
        tf1_import.import_dcgan(tf_vars, dataclasses.replace(cfg, z_dim=100))
    with pytest.raises(tf1_import.TF1ImportError,
                       match="no variable matching"):
        tf1_import.import_dcgan({k: v for k, v in tf_vars.items()
                                 if not k.endswith("g_h0_lin/Matrix")}, cfg)
    ambiguous = dict(tf_vars, **{"other/g_h0_lin/Matrix":
                                 tf_vars["generator/g_h0_lin/Matrix"]})
    with pytest.raises(tf1_import.TF1ImportError,
                       match="ambiguous.*generator/g_h0_lin/Matrix.*"
                             "other/g_h0_lin/Matrix"):
        tf1_import.import_dcgan(ambiguous, cfg)
    cond = dataclasses.replace(cfg, num_classes=4)
    _, g, d = _pair(dataclasses.asdict(cond))
    with pytest.raises(tf1_import.TF1ImportError, match="conditional"):
        tf1_export.export_tf1(g, d, cond)


def test_batch_norm_without_scale_imports_ones(tmp_path):
    z, x, g_tf, d_tf = _saved("dcgan", tmp_path, bn_scale=False)
    tf_vars = tf1_import.read_tf1_checkpoint(str(tmp_path))
    assert not any(n.endswith("/gamma") for n in tf_vars)
    g_vars, d_vars = tf1_import.import_dcgan(tf_vars, ModelConfig(**DCGAN))
    np.testing.assert_array_equal(d_vars["params"]["bn1"]["scale"],
                                  np.ones(16, np.float32))
    g, d = _modules(tf_vars, ModelConfig(**DCGAN),
                                  device="cpu")
    bundle = make_bundle(ModelConfig(**DCGAN), "cpu")
    with torch.no_grad():
        np.testing.assert_allclose(
            bundle.discriminate(d, torch.from_numpy(x)).numpy(), d_tf,
            rtol=1e-4, atol=1e-4)


def test_mlp_import_explicit_scopes_and_chain_error():
    with tf.Graph().as_default():
        _mlp_graph(np.random.default_rng(0), 2)
        with tf.Session() as sess:
            sess.run(tf.global_variables_initializer())
            names = [v.name.split(":")[0] for v in tf.global_variables()]
            tf_vars = dict(zip(names, sess.run(tf.global_variables())))
    cfg = ModelConfig(**MLP)
    g_vars, _ = tf1_import.import_mlp(
        tf_vars, cfg,
        g_scopes=["generator/dense", "generator/dense_1",
                  "generator/dense_2", "generator/dense_3"],
        d_scopes=["d_fc0", "d_fc1", "d_fc2", "d_out"])
    assert g_vars["params"]["out"]["kernel"].shape == (32, 2)
    with pytest.raises(tf1_import.TF1ImportError, match="chain|input dim"):
        tf1_import.import_mlp(
            tf_vars, cfg,
            g_scopes=["generator/dense_3", "generator/dense",
                      "generator/dense_1", "generator/dense_2"],
            d_scopes=["d_fc0", "d_fc1", "d_fc2", "d_out"])
    with pytest.raises(tf1_import.TF1ImportError, match="MLP imports only"):
        tf1_import.import_tf1(tf_vars, ModelConfig(**DCGAN),
                              g_scopes=["x"])
