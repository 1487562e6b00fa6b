"""Export the port's (G, D) in the reference's TF1 variable layout.

Counterpart of ``collaborative_gan_sampling_tpu/compat/tf1_export.py`` and
the inverse of ``compat/tf1_import.py``: (G, D), as the port's modules or
as Flax-layout variable trees, become a ``{tf1_variable_name:
np.ndarray}`` map in the carpedm20 naming the reference inherits,
optionally written as a real ``tf.train.Saver`` checkpoint that a TF1
process restores. Held to the JAX package in ``tests/test_torch_tf1.py``:
``state_to_tf1`` gives the same names and arrays as JAX's on the same
weights, and export -> import round-trips bit for bit.

Layouts, the importer's inverted:

* Flax ``Dense`` kernel ``[in, out]`` -> dense ``Matrix`` (identity);
* Flax ``Conv`` HWIO kernel -> conv ``w`` (identity);
* Flax ``ConvTranspose`` HWIO kernel -> TF1 ``conv2d_transpose`` ``w``
  ``[kh, kw, out, in]`` by spatial flip and ``(0, 1, 3, 2)`` transpose (an
  involution: the import's op);
* Flax ``BatchNorm`` ``{scale, bias}`` and ``{mean, var}`` -> contrib
  ``batch_norm`` ``{gamma, beta, moving_mean, moving_variance}``.

TensorFlow is imported lazily, in the writer only.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
from torch import nn

from collaborative_gan_sampling_torch.compat.tf1_import import TF1ImportError
from collaborative_gan_sampling_torch.config import ModelConfig
from collaborative_gan_sampling_torch.models.dcgan import num_stages
from collaborative_gan_sampling_torch.utils.weights import (
    params_to_flax,
    to_jax_variables,
)


def _variables(vs: nn.Module | Mapping) -> dict:
    """Flax-layout float32 numpy variables of a module or a variables
    tree."""
    tree = to_jax_variables(vs) if isinstance(vs, nn.Module) else vs

    def cast(t):
        if isinstance(t, Mapping):
            return {k: cast(v) for k, v in t.items()}
        return np.asarray(t, dtype=np.float32)

    return cast(tree)


def _deconv_kernel_tf(w_flax: np.ndarray) -> np.ndarray:
    """Flax ConvTranspose HWIO -> TF1 conv2d_transpose [kh, kw, out, in]
    (its own inverse: ``tf1_import._deconv_kernel``)."""
    return np.flip(np.transpose(w_flax, (0, 1, 3, 2)), axis=(0, 1)).copy()


def _bn_vars(params: Mapping, stats: Mapping, scope: str) -> dict:
    return {
        f"{scope}/gamma": params["scale"],
        f"{scope}/beta": params["bias"],
        f"{scope}/moving_mean": stats["mean"],
        f"{scope}/moving_variance": stats["var"],
    }


def export_dcgan(g, d, cfg: ModelConfig) -> dict[str, np.ndarray]:
    """(G, D) -> carpedm20-named TF1 variable map (JAX ``export_dcgan``;
    ``tf1_import.import_dcgan``'s correspondence table). Conditional
    models are refused: the reference's TF1 graphs have no label
    embeddings."""
    if cfg.kind != "dcgan":
        raise TF1ImportError(
            f"export_dcgan needs kind='dcgan', got {cfg.kind!r}")
    if cfg.num_classes:
        raise TF1ImportError(
            "conditional DCGANs (num_classes > 0) have projection/embedding "
            "parameters the reference's TF1 graphs cannot hold — export an "
            "unconditional model")
    g_vars, d_vars = _variables(g), _variables(d)
    gp, gs = g_vars["params"], g_vars.get("batch_stats", {})
    dp, ds = d_vars["params"], d_vars.get("batch_stats", {})
    n = num_stages(cfg.image_size)

    out: dict[str, np.ndarray] = {
        "generator/g_h0_lin/Matrix": gp["project"]["kernel"],
        "generator/g_h0_lin/bias": gp["project"]["bias"],
    }
    out.update(_bn_vars(gp["bn_project"], gs["bn_project"],
                        "generator/g_bn0"))
    for i in range(n - 1):
        out[f"generator/g_h{i + 1}/w"] = _deconv_kernel_tf(
            gp[f"deconv{i}"]["kernel"])
        out[f"generator/g_h{i + 1}/biases"] = gp[f"deconv{i}"]["bias"]
        out.update(_bn_vars(gp[f"bn{i}"], gs[f"bn{i}"],
                            f"generator/g_bn{i + 1}"))
    out[f"generator/g_h{n}/w"] = _deconv_kernel_tf(
        gp["deconv_out"]["kernel"])
    out[f"generator/g_h{n}/biases"] = gp["deconv_out"]["bias"]

    out["discriminator/d_h0_conv/w"] = dp["conv0"]["kernel"]
    out["discriminator/d_h0_conv/biases"] = dp["conv0"]["bias"]
    for i in range(1, n):
        out[f"discriminator/d_h{i}_conv/w"] = dp[f"conv{i}"]["kernel"]
        out[f"discriminator/d_h{i}_conv/biases"] = dp[f"conv{i}"]["bias"]
        out.update(_bn_vars(dp[f"bn{i}"], ds[f"bn{i}"],
                            f"discriminator/d_bn{i}"))
    out[f"discriminator/d_h{n}_lin/Matrix"] = dp["out"]["kernel"]
    out[f"discriminator/d_h{n}_lin/bias"] = dp["out"]["bias"]
    return out


def export_mlp(g, d, cfg: ModelConfig) -> dict[str, np.ndarray]:
    """(G, D) MLPs -> TF1 variable map (JAX ``export_mlp``): scopes
    ``generator/fc{i}`` ... ``discriminator/out``, which the importer's
    natural name sort puts back in graph order."""
    if cfg.kind != "mlp":
        raise TF1ImportError(f"export_mlp needs kind='mlp', got {cfg.kind!r}")
    out: dict[str, np.ndarray] = {}
    for who, net in (("generator", g), ("discriminator", d)):
        for scope, layer in _variables(net)["params"].items():
            out[f"{who}/{scope}/Matrix"] = layer["kernel"]
            out[f"{who}/{scope}/bias"] = layer["bias"]
    return out


def export_tf1(g, d, cfg: ModelConfig) -> dict[str, np.ndarray]:
    """TF1 variable map for either model family (the mirror of
    ``tf1_import.import_tf1``)."""
    if cfg.kind == "dcgan":
        return export_dcgan(g, d, cfg)
    if cfg.kind == "mlp":
        return export_mlp(g, d, cfg)
    raise TF1ImportError(f"unsupported model kind {cfg.kind!r}")


def write_tf1_checkpoint(tf_vars: Mapping[str, np.ndarray],
                         prefix: str) -> str:
    """Write a real ``tf.train.Saver`` checkpoint that a TF1 process
    restores: a throwaway graph of ``tf.Variable``s named as in
    ``tf_vars``, saved once. Returns the prefix (``Saver.save``'s return);
    the ``checkpoint`` index file beside it lets
    ``tf.train.latest_checkpoint`` resolve the directory."""
    import tensorflow.compat.v1 as tf

    with tf.Graph().as_default():
        for name, arr in sorted(tf_vars.items()):
            tf.get_variable(name, initializer=np.asarray(arr, np.float32))
        saver = tf.train.Saver()
        with tf.Session() as sess:
            sess.run(tf.global_variables_initializer())
            return saver.save(sess, prefix)


def state_to_tf1(state: Any, cfg: ModelConfig, prefix: str | None = None,
                 use_ema: bool = False):
    """A ``training.gan.TrainState`` -> TF1 variable map, or with
    ``prefix`` a Saver checkpoint (its prefix returned). ``use_ema``
    exports the EMA generator's parameters (what sampling uses) with the
    live G's BatchNorm statistics, as JAX's does."""
    g = to_jax_variables(state.g)
    if use_ema:
        if state.g_ema is None:
            raise ValueError("use_ema=True but the state tracks no EMA "
                             "(train.g_ema_decay == 0)")
        g = dict(g, params=params_to_flax(state.g_ema))
    tf_vars = export_tf1(g, state.d, cfg)
    if prefix is not None:
        return write_tf1_checkpoint(tf_vars, prefix)
    return tf_vars
