"""The reference's TF1 discriminator graph and refinement loop, from
exported weights.

Counterpart of ``collaborative_gan_sampling_tpu/compat/tf1_graph.py``
(JAX ``:49-151``), in TensorFlow only; this copy reads the port's config
and ``models/dcgan.py::num_stages``. It is the TF1 arm of an equal-weights
comparison: the reference's execution model run from the same weights as
the port.

* ``build_tf1_discriminator`` builds the reference's D graph (stride-2
  5x5 SAME convs, lrelu(0.2), eval-mode batchnorm and a linear logit; or
  the relu MLP) in a ``tf.compat.v1`` graph, every variable initialised
  from a ``compat/tf1_export.py`` map.
* ``TF1RefineLoop`` runs the reference's hot loop as the reference runs
  it: one ``sess.run(grad)`` per refinement step, with the update
  ``x -= rate * grad`` in host numpy between steps.

Held in ``tests/test_torch_tf1.py``: the graph's logits against the port's
D, and the loop's refined pool against the port's plain refinement, at
the tolerances of JAX ``tests/test_tf1_export.py:94-137``.
"""

from __future__ import annotations

import time
from typing import Mapping

import numpy as np

from collaborative_gan_sampling_torch.config import ModelConfig
from collaborative_gan_sampling_torch.models.dcgan import num_stages


def _tf():
    import tensorflow.compat.v1 as tf

    return tf


def _var(tf, tf_vars: Mapping[str, np.ndarray], name: str):
    if name not in tf_vars:
        raise KeyError(f"TF1 variable map is missing {name!r} — was it "
                       "produced by compat.tf1_export for this ModelConfig?")
    return tf.get_variable(name,
                           initializer=np.asarray(tf_vars[name], np.float32))


def build_tf1_discriminator(tf_vars: Mapping[str, np.ndarray],
                            cfg: ModelConfig, x_ph):
    """D(x) logits tensor for an exported variable map, reference semantics.

    Eval-mode batchnorm (moving statistics, eps 1e-5), as the port's
    sampling and refinement run D (``bundle.discriminate(...,
    train=False)``), so per-sample gradients are exact and the TF1 graph
    scores samples the same way.
    """
    tf = _tf()
    if cfg.kind == "mlp":
        h = x_ph
        for i in range(cfg.d_layers):
            w = _var(tf, tf_vars, f"discriminator/fc{i}/Matrix")
            b = _var(tf, tf_vars, f"discriminator/fc{i}/bias")
            h = tf.nn.relu(tf.matmul(h, w) + b)
        w = _var(tf, tf_vars, "discriminator/out/Matrix")
        b = _var(tf, tf_vars, "discriminator/out/bias")
        return (tf.matmul(h, w) + b)[:, 0]

    if cfg.kind != "dcgan":
        raise ValueError(f"unsupported model kind {cfg.kind!r}")
    n = num_stages(cfg.image_size)

    def conv(h, scope):
        w = _var(tf, tf_vars, f"{scope}/w")
        b = _var(tf, tf_vars, f"{scope}/biases")
        return tf.nn.conv2d(h, w, strides=[1, 2, 2, 1], padding="SAME") + b

    def bn(h, scope):
        return tf.nn.batch_normalization(
            h,
            _var(tf, tf_vars, f"{scope}/moving_mean"),
            _var(tf, tf_vars, f"{scope}/moving_variance"),
            _var(tf, tf_vars, f"{scope}/beta"),
            _var(tf, tf_vars, f"{scope}/gamma"), 1e-5)

    def lrelu(h):
        return tf.maximum(h, 0.2 * h)

    h = lrelu(conv(x_ph, "discriminator/d_h0_conv"))
    for i in range(1, n):
        h = lrelu(bn(conv(h, f"discriminator/d_h{i}_conv"),
                     f"discriminator/d_bn{i}"))
    h = tf.reshape(h, [tf.shape(h)[0], -1])
    w = _var(tf, tf_vars, f"discriminator/d_h{n}_lin/Matrix")
    b = _var(tf, tf_vars, f"discriminator/d_h{n}_lin/bias")
    return (tf.matmul(h, w) + b)[:, 0]


_TF_OBJECTIVES = {
    "ns": lambda tf, d: tf.nn.softplus(-d),
    "kl": lambda tf, d: -d,
    "saturating": lambda tf, d: -tf.nn.softplus(d),
}


class TF1RefineLoop:
    """The reference's refinement execution model, runnable from exported
    weights: graph built once, then per batch a host Python loop issuing one
    ``sess.run(grad)`` per step and updating x in numpy."""

    def __init__(self, tf_vars: Mapping[str, np.ndarray], cfg: ModelConfig,
                 batch_shape: tuple[int, ...], objective: str = "ns"):
        tf = _tf()
        self._graph = tf.Graph()
        with self._graph.as_default():
            self.x_ph = tf.placeholder(tf.float32, batch_shape, name="x")
            with tf.variable_scope("export"):
                self.logits = build_tf1_discriminator(tf_vars, cfg, self.x_ph)
            loss = tf.reduce_sum(_TF_OBJECTIVES[objective](tf, self.logits))
            self.grad = tf.gradients(loss, self.x_ph)[0]
            self._init = tf.global_variables_initializer()
        self.sess = tf.Session(graph=self._graph)
        self.sess.run(self._init)

    def score(self, x: np.ndarray) -> np.ndarray:
        return self.sess.run(self.logits, {self.x_ph: x})

    def refine(self, x0: np.ndarray, steps: int, rate: float
               ) -> tuple[np.ndarray, float]:
        """(refined batch, wall seconds). One sess.run per step — the
        measured reference hot loop, not an approximation of it."""
        x = np.asarray(x0, np.float32)
        t0 = time.perf_counter()
        for _ in range(steps):
            g = self.sess.run(self.grad, {self.x_ph: x})
            x = x - rate * g  # host-side numpy update, as the reference
        return x, time.perf_counter() - t0

    def refine_pool(self, x0_pool: np.ndarray, steps: int, rate: float
                    ) -> tuple[np.ndarray, float]:
        """Refine a (num_batches, B, ...) pool; returns (pool, total secs)."""
        outs, total = [], 0.0
        for x0 in x0_pool:
            x, dt = self.refine(x0, steps, rate)
            outs.append(x)
            total += dt
        return np.stack(outs), total

    def close(self):
        self.sess.close()
