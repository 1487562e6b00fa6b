"""Import the reference's ``tf.train.Saver`` checkpoints into the port.

Counterpart of ``collaborative_gan_sampling_tpu/compat/tf1_import.py``,
held to it in ``tests/test_torch_tf1.py``: a Saver checkpoint that
TensorFlow writes with the reference's names gives the same G outputs and
D logits in both packages within 1e-5 (float32), and the maps give the
same trees. The reference trains with TF1 and persists (G, D) with
``tf.train.Saver``; collaborative sampling runs after training on such a
restored checkpoint, so a user of the reference brings those weights
along:

    from collaborative_gan_sampling_torch.compat.tf1_import import (
        tf1_to_checkpoint)
    tf1_to_checkpoint("/path/to/tf1/checkpoint_dir", cfg)

after which every sampling, refinement, shaping and evaluation command runs
on the imported (G, D) as on a checkpoint the port trained.

The route: the TF1 name map becomes a Flax-layout numpy tree by the JAX
package's own maps (copied here), checked against the port's own template
(``utils/weights.py::to_jax_variables`` of a fresh bundle), and is loaded
into the port's modules by ``utils/weights.py::load_jax_variables``.

Two architectures, the reference's two model families:

* **DCGAN** with the carpedm20 names the reference inherits:
  ``generator/g_h0_lin/{Matrix,bias}``, ``generator/g_bn{i}/{beta,gamma,
  moving_mean,moving_variance}``, ``generator/g_h{i}/{w,biases}``
  (conv2d_transpose), ``discriminator/d_h{i}_conv/{w,biases}``,
  ``discriminator/d_bn{i}/...``, ``discriminator/d_h{n}_lin/{Matrix,bias}``;
  conditional DCGANs are refused (the reference's are unconditional);
* **MLP** (the synthetic stack) through a matcher that infers the layer
  order (scopes grouped, natural name sort, checked by the chain of
  in/out widths); explicit scope lists override it.

Layouts: dense ``Matrix`` is ``[in, out]`` (a Flax ``Dense`` kernel);
conv ``w`` is HWIO (a Flax ``Conv`` kernel); ``conv2d_transpose`` ``w`` is
``[kh, kw, out, in]`` and TF1's op is the gradient of conv2d, so the Flax
``ConvTranspose`` kernel is its spatial flip transposed ``(0, 1, 3, 2)``;
contrib ``batch_norm``'s ``{gamma, beta, moving_mean, moving_variance}``
are Flax's ``{scale, bias}`` and ``{mean, var}`` (no ``gamma`` in a
``scale=False`` graph: ones). Adam slots, ``beta*_power`` and
``global_step`` are not parameters (``_AUX_LEAVES``).

TensorFlow is imported lazily, in the reader only.
"""

from __future__ import annotations

import difflib
import os
import re
from typing import Any, Callable, Mapping

import numpy as np
import torch

from collaborative_gan_sampling_torch.config import Config, ModelConfig
from collaborative_gan_sampling_torch.models import make_bundle
from collaborative_gan_sampling_torch.models.dcgan import num_stages
from collaborative_gan_sampling_torch.utils.weights import (
    load_jax_params,
    load_jax_variables,
    to_jax_variables,
)

TFVars = Mapping[str, np.ndarray]

# Optimizer slot / bookkeeping variables a Saver checkpoint carries alongside
# the model weights; never model parameters.
_AUX_LEAVES = {
    "adam", "adam_1", "momentum", "rmsprop", "rmsprop_1",
    "beta1_power", "beta2_power", "global_step",
}


class TF1ImportError(ValueError):
    """A TF1 checkpoint does not match the target architecture."""


# -- reading ----------------------------------------------------------------

def read_tf1_checkpoint(path: str) -> dict[str, np.ndarray]:
    """All variables of a TF1 Saver checkpoint as {name: np.ndarray}.

    ``path`` may be a checkpoint prefix (``.../model-25000``) or a
    directory, which ``tf.train.latest_checkpoint`` resolves, as the
    reference's ``load()`` helpers restore."""
    import tensorflow as tf  # lazy: only reading the source format needs it

    if os.path.isdir(path):
        resolved = tf.train.latest_checkpoint(path)
        if resolved is None:
            raise FileNotFoundError(
                f"no TF1 checkpoint found in directory {path!r} "
                "(no 'checkpoint' index file)")
        path = resolved
    reader = tf.train.load_checkpoint(path)
    return {name: np.asarray(reader.get_tensor(name))
            for name in reader.get_variable_to_shape_map()}


def _model_vars(tf_vars: TFVars) -> dict[str, np.ndarray]:
    return {n: a for n, a in tf_vars.items()
            if n.rsplit("/", 1)[-1].lower() not in _AUX_LEAVES}


# -- name resolution --------------------------------------------------------

def _get(tf_vars: TFVars, suffix: str,
         optional: bool = False) -> np.ndarray | None:
    """The unique variable whose name is `suffix` or ends with `/suffix`."""
    hits = [n for n in tf_vars if n == suffix or n.endswith("/" + suffix)]
    if len(hits) == 1:
        return tf_vars[hits[0]]
    if len(hits) > 1:
        raise TF1ImportError(
            f"TF1 checkpoint: variable suffix {suffix!r} is ambiguous: "
            f"{sorted(hits)}")
    if optional:
        return None
    close = difflib.get_close_matches(suffix.rsplit("/", 1)[0],
                                      sorted(tf_vars), n=5, cutoff=0.3)
    raise TF1ImportError(
        f"TF1 checkpoint: no variable matching '*/{suffix}'. "
        f"Closest names: {close or sorted(tf_vars)[:8]}")


def _deconv_kernel(w_tf: np.ndarray) -> np.ndarray:
    """TF1 conv2d_transpose kernel [kh,kw,out,in] -> Flax ConvTranspose HWIO.

    TF1's op is the gradient of conv2d, which also flips the kernel
    spatially relative to Flax's direct transposed convolution
    (pinned in tests/test_tf1_parity.py::test_conv2d_transpose_...).
    """
    return np.flip(np.transpose(w_tf, (0, 1, 3, 2)), axis=(0, 1)).copy()


def _bn_group(tf_vars: TFVars, scope: str) -> tuple[dict, dict]:
    """contrib batch_norm variables under `scope` -> (params, stats)."""
    beta = _get(tf_vars, f"{scope}/beta")
    mean = _get(tf_vars, f"{scope}/moving_mean")
    var = _get(tf_vars, f"{scope}/moving_variance")
    gamma = _get(tf_vars, f"{scope}/gamma", optional=True)
    if gamma is None:  # batch_norm(scale=False) graphs
        gamma = np.ones_like(beta)
    return ({"scale": gamma, "bias": beta}, {"mean": mean, "var": var})


# -- shape conformance ------------------------------------------------------

def _conform(built: Any, template: Any, path: str = "") -> Any:
    """Check ``built`` against the port's freshly initialised ``template``
    tree (same keys, same leaf shapes) and cast its leaves to the
    template's dtypes. A mismatch here is an architecture mismatch: name
    it, rather than let it surface as a shape error inside a forward."""
    if isinstance(template, Mapping):
        if not isinstance(built, Mapping):
            raise TF1ImportError(f"{path or 'tree'}: expected a dict with "
                                 f"keys {sorted(template)}")
        missing = set(template) - set(built)
        extra = set(built) - set(template)
        if missing or extra:
            raise TF1ImportError(
                f"{path or 'tree'}: key mismatch vs target architecture "
                f"(missing={sorted(missing)}, unexpected={sorted(extra)})")
        return {k: _conform(built[k], template[k], f"{path}/{k}")
                for k in template}
    t = np.asarray(template)
    b = np.asarray(built)
    if b.shape != t.shape:
        raise TF1ImportError(
            f"{path}: TF1 variable has shape {b.shape}, target architecture "
            f"expects {t.shape} — check the ModelConfig "
            "(sizes/filters/z_dim) matches the checkpoint's graph")
    return b.astype(t.dtype)


def _templates(cfg: ModelConfig) -> tuple[dict, dict]:
    """The port's (G, D) variables of ``cfg``, freshly initialised: only
    their keys, shapes and dtypes are read, so they are built on the
    CPU."""
    bundle = make_bundle(cfg, "cpu")
    g, d = bundle.init(torch.Generator().manual_seed(0))
    return to_jax_variables(g), to_jax_variables(d)


# -- DCGAN ------------------------------------------------------------------

def import_dcgan(tf_vars: TFVars, cfg: ModelConfig) -> tuple[dict, dict]:
    """carpedm20-named TF1 DCGAN variables -> (g_vars, d_vars), Flax-layout
    numpy trees (JAX ``import_dcgan``).

    Layer correspondence (n = number of stride-2 stages, ``num_stages``):
    ``project``<-``g_h0_lin``, ``bn_project``<-``g_bn0``,
    ``deconv{i}``<-``g_h{i+1}``, ``bn{i}``<-``g_bn{i+1}``,
    ``deconv_out``<-``g_h{n}``; ``conv0``<-``d_h0_conv``,
    ``conv{i}``<-``d_h{i}_conv``, ``bn{i}``<-``d_bn{i}``,
    ``out``<-``d_h{n}_lin``.
    """
    if cfg.kind != "dcgan":
        raise TF1ImportError(
            f"import_dcgan needs kind='dcgan', got {cfg.kind!r}")
    if cfg.num_classes:
        raise TF1ImportError(
            "the reference's DCGANs are unconditional; a conditional "
            "ModelConfig (num_classes > 0) has label-embedding parameters "
            "no TF1 checkpoint provides — import into an unconditional "
            "config instead")
    v = _model_vars(tf_vars)
    n = num_stages(cfg.image_size)

    g_params: dict[str, Any] = {
        "project": {"kernel": _get(v, "g_h0_lin/Matrix"),
                    "bias": _get(v, "g_h0_lin/bias")},
    }
    g_stats: dict[str, Any] = {}
    g_params["bn_project"], g_stats["bn_project"] = _bn_group(v, "g_bn0")
    for i in range(n - 1):
        g_params[f"deconv{i}"] = {
            "kernel": _deconv_kernel(_get(v, f"g_h{i + 1}/w")),
            "bias": _get(v, f"g_h{i + 1}/biases"),
        }
        g_params[f"bn{i}"], g_stats[f"bn{i}"] = _bn_group(v, f"g_bn{i + 1}")
    g_params["deconv_out"] = {
        "kernel": _deconv_kernel(_get(v, f"g_h{n}/w")),
        "bias": _get(v, f"g_h{n}/biases"),
    }

    d_params: dict[str, Any] = {
        "conv0": {"kernel": _get(v, "d_h0_conv/w"),
                  "bias": _get(v, "d_h0_conv/biases")},
    }
    d_stats: dict[str, Any] = {}
    for i in range(1, n):
        d_params[f"conv{i}"] = {"kernel": _get(v, f"d_h{i}_conv/w"),
                                "bias": _get(v, f"d_h{i}_conv/biases")}
        d_params[f"bn{i}"], d_stats[f"bn{i}"] = _bn_group(v, f"d_bn{i}")
    d_params["out"] = {"kernel": _get(v, f"d_h{n}_lin/Matrix"),
                       "bias": _get(v, f"d_h{n}_lin/bias")}

    g_tpl, d_tpl = _templates(cfg)
    return (_conform({"params": g_params, "batch_stats": g_stats}, g_tpl,
                     "g_vars"),
            _conform({"params": d_params, "batch_stats": d_stats}, d_tpl,
                     "d_vars"))


# -- MLP ----------------------------------------------------------------------

_KERNEL_LEAVES = {"w", "matrix", "kernel", "weight", "weights"}
_BIAS_LEAVES = {"b", "bias", "biases"}
# Literal spellings for explicit-scope lookup (checkpoint names are
# case-sensitive; the grouped path compares lowercased leaves instead).
_KERNEL_LITERALS = ("w", "W", "Matrix", "kernel", "weight", "weights")
_BIAS_LITERALS = ("b", "bias", "biases")
_G_TOKENS = {"generator", "gen", "g"}
_D_TOKENS = {"discriminator", "disc", "dis", "d"}


def _scope_matches(parts: list[str], tokens: set[str], prefix: str) -> bool:
    return any(p.lower() in tokens or p.lower().startswith(prefix)
               for p in parts)


def _natural_key(s: str) -> list:
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def _dense_stack(tf_vars: TFVars, scopes: list[str] | None,
                 pred: Callable[[list[str]], bool], who: str) -> list[dict]:
    """Ordered [{kernel, bias}, ...] dense layers for one network.

    With explicit `scopes`, each is resolved by suffix. Otherwise layers are
    grouped by variable scope and ordered by natural name sort — the order
    TF1 graph builders produce (``dense``, ``dense_1``, ... / ``fc0``,
    ``fc1``, ...).
    """
    if scopes is not None:
        out = []
        for s in scopes:
            kern = next((a for leaf in _KERNEL_LITERALS
                         if (a := _get(tf_vars, f"{s}/{leaf}",
                                       optional=True)) is not None), None)
            bias = next((a for leaf in _BIAS_LITERALS
                         if (a := _get(tf_vars, f"{s}/{leaf}",
                                       optional=True)) is not None), None)
            if kern is None or bias is None:
                raise TF1ImportError(
                    f"{who}: scope {s!r} has no (kernel, bias) pair among "
                    f"leaves {_KERNEL_LITERALS + _BIAS_LITERALS}")
            out.append({"kernel": kern, "bias": bias})
        return out
    grouped: dict[str, dict] = {}
    for name, arr in tf_vars.items():
        parts = name.split("/")
        if len(parts) < 2 or not pred(parts[:-1]):
            continue
        leaf = parts[-1].lower()
        scope = "/".join(parts[:-1])
        if leaf in _KERNEL_LEAVES and arr.ndim == 2:
            grouped.setdefault(scope, {})["kernel"] = arr
        elif leaf in _BIAS_LEAVES and arr.ndim == 1:
            grouped.setdefault(scope, {})["bias"] = arr
    layers = []
    for scope in sorted(grouped, key=_natural_key):
        layer = grouped[scope]
        if "kernel" in layer and "bias" in layer:
            layers.append(layer)
    if not layers:
        raise TF1ImportError(
            f"{who}: found no dense (kernel, bias) scopes — variable names "
            f"don't carry a recognisable {who} scope token "
            f"({sorted(_G_TOKENS if who == 'generator' else _D_TOKENS)}); "
            "pass explicit g_scopes=/d_scopes= lists")
    return layers


def import_mlp(tf_vars: TFVars, cfg: ModelConfig,
               g_scopes: list[str] | None = None,
               d_scopes: list[str] | None = None) -> tuple[dict, dict]:
    """TF1 synthetic-MLP variables -> (g_vars, d_vars), Flax-layout numpy
    trees (JAX ``import_mlp``). Layers are inferred by scope grouping and
    natural name order and checked by the chain of in/out widths, or
    pinned by ``g_scopes`` / ``d_scopes`` (ordered, input to output)."""
    if cfg.kind != "mlp":
        raise TF1ImportError(f"import_mlp needs kind='mlp', got {cfg.kind!r}")
    v = _model_vars(tf_vars)
    g_layers = _dense_stack(v, g_scopes,
                            lambda p: _scope_matches(p, _G_TOKENS, "g_"),
                            "generator")
    d_layers = _dense_stack(v, d_scopes,
                            lambda p: _scope_matches(p, _D_TOKENS, "d_"),
                            "discriminator")

    def stack_to_params(layers: list[dict], in_dim: int, who: str) -> dict:
        dim = in_dim
        for i, layer in enumerate(layers):
            k = layer["kernel"]
            if k.shape[0] != dim:
                raise TF1ImportError(
                    f"{who}: layer {i} kernel has input dim {k.shape[0]}, "
                    f"expected {dim} — the inferred layer order "
                    "(natural name sort) doesn't chain; pass explicit "
                    "g_scopes=/d_scopes= in graph order")
            dim = k.shape[1]
        params = {f"fc{i}": layer for i, layer in enumerate(layers[:-1])}
        params["out"] = layers[-1]
        return params

    g_params = stack_to_params(g_layers, cfg.z_dim, "generator")
    d_params = stack_to_params(d_layers, cfg.data_dim, "discriminator")
    g_tpl, d_tpl = _templates(cfg)
    return (_conform({"params": g_params}, g_tpl, "g_vars"),
            _conform({"params": d_params}, d_tpl, "d_vars"))


# -- top level ----------------------------------------------------------------

def import_tf1(source: str | TFVars, cfg: ModelConfig,
               **mlp_kwargs) -> tuple[dict, dict]:
    """(g_vars, d_vars) from a TF1 checkpoint path / prefix or a
    name -> array map."""
    tf_vars = (read_tf1_checkpoint(source) if isinstance(source, str)
               else source)
    if cfg.kind == "dcgan":
        if mlp_kwargs:
            raise TF1ImportError("g_scopes/d_scopes apply to MLP imports only")
        return import_dcgan(tf_vars, cfg)
    if cfg.kind == "mlp":
        return import_mlp(tf_vars, cfg, **mlp_kwargs)
    raise TF1ImportError(f"unsupported model kind {cfg.kind!r}")


def tf1_to_checkpoint(source: str | TFVars, cfg: Config,
                      workdir: str | None = None, step: int | None = None,
                      device: str | torch.device | None = None,
                      **mlp_kwargs) -> str:
    """Convert a TF1 Saver checkpoint into a checkpoint of the workdir
    (the JAX package's format, ``utils/checkpoint.py``): the imported G and
    D, fresh Adam states and, where ``train.g_ema_decay`` > 0, an EMA
    generator seeded from the imported G, with the config sidecar, so every
    command after training picks it up through ``load_or_train``.

    ``step`` defaults to ``cfg.train.niters``: an imported checkpoint is a
    finished run; a smaller step would make ``load_or_train`` train on top
    of the imported weights."""
    from collaborative_gan_sampling_torch.training.gan import (
        create_train_state,
    )
    from collaborative_gan_sampling_torch.utils.checkpoint import (
        save_checkpoint,
    )

    g_vars, d_vars = import_tf1(source, cfg.model, **mlp_kwargs)
    bundle = make_bundle(cfg.model, device)
    state = create_train_state(bundle, cfg.train, cfg.seed)
    load_jax_variables(state.g, g_vars)
    load_jax_variables(state.d, d_vars)
    if state.g_ema is not None:
        load_jax_params(state.g_ema, g_vars["params"])
    state.step = cfg.train.niters if step is None else int(step)
    ckpt_dir = os.path.join(workdir or cfg.workdir, "ckpts")
    return save_checkpoint(ckpt_dir, state.step, state, config=cfg)
