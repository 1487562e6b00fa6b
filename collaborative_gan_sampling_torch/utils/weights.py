"""Weights across the two packages: JAX variables <-> the port's modules.

JAX variables are given as nested dicts of numpy arrays,
``{'params': {...}, 'batch_stats': {...}}``, keyed by the Flax module names;
the port's submodules carry the same names, nested as deep as the Flax
modules are (Inception-v3's ``Mixed_5b/branch5x5_1/conv``). Layouts:

=====================  ========================  ===========================
layer                  Flax                      port
=====================  ========================  ===========================
Dense                  kernel (in, out)          weight (out, in)
Conv                   kernel (kh, kw, in, out)  weight (out, in, kh, kw);
                                                 no bias where Flax has none
ConvTranspose (SAME)   kernel (kh, kw, in, out)  weight (in, out, kh, kw),
                                                 spatially flipped
BatchNorm              scale, bias; mean, var    weight, bias; running_*
Embed                  embedding (num, features) embedding, as it is
=====================  ========================  ===========================

Adam's state goes the same way: optax's ``ScaleByAdamState(count, mu,
nu)`` is torch Adam's per-parameter ``step``, ``exp_avg`` and
``exp_avg_sq``; mu and nu take the parameters' layouts above, and optax's
one int32 count is every parameter's step.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from collaborative_gan_sampling_torch.ops.nn import (
    Dense,
    Embed,
    FlaxBatchNorm,
    FlaxConv,
    SameConv2d,
    SameConvTranspose2d,
)

# The layers that hold Flax params; any other submodule is a container
# whose children are looked up one level down in the Flax tree.
_LAYERS = (Dense, Embed, FlaxBatchNorm, FlaxConv, SameConv2d,
           SameConvTranspose2d)


def _layers(module: nn.Module, path: tuple[str, ...] = ()):
    """(Flax path, layer) of every layer under ``module``, in order."""
    for name, child in module.named_children():
        if isinstance(child, _LAYERS):
            yield path + (name,), child
        else:
            yield from _layers(child, path + (name,))


def _at(tree: Any, path: tuple[str, ...]) -> Any:
    for name in path:
        tree = tree[name]
    return tree


def _put(tree: dict, path: tuple[str, ...], value: Any) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = value


def _to_torch(layer: nn.Module, p: dict) -> dict[str, np.ndarray]:
    if isinstance(layer, Embed):
        return {"embedding": np.asarray(p["embedding"])}
    if isinstance(layer, Dense):
        return {"weight": np.asarray(p["kernel"]).T,
                "bias": np.asarray(p["bias"])}
    if isinstance(layer, (SameConv2d, FlaxConv)):
        out = {"weight": np.asarray(p["kernel"]).transpose(3, 2, 0, 1)}
        if layer.bias is not None:
            out["bias"] = np.asarray(p["bias"])
        return out
    if isinstance(layer, SameConvTranspose2d):
        k = np.asarray(p["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        return {"weight": k, "bias": np.asarray(p["bias"])}
    if isinstance(layer, FlaxBatchNorm):
        return {"weight": np.asarray(p["scale"]),
                "bias": np.asarray(p["bias"])}
    raise TypeError(f"no Flax counterpart for {type(layer).__name__}")


def _to_flax(layer: nn.Module, w: np.ndarray, b: np.ndarray | None
             ) -> dict[str, np.ndarray]:
    """Flax arrays of one layer's (weight, bias)-shaped pair: its params,
    or Adam's moments of them (``b`` None for a bias-free conv or an
    embedding)."""
    if isinstance(layer, Embed):
        return {"embedding": w}
    if isinstance(layer, Dense):
        return {"kernel": w.T.copy(), "bias": b}
    if isinstance(layer, (SameConv2d, FlaxConv)):
        out = {"kernel": w.transpose(2, 3, 1, 0).copy()}
        if b is not None:
            out["bias"] = b
        return out
    if isinstance(layer, SameConvTranspose2d):
        return {"kernel": w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1).copy(),
                "bias": b}
    if isinstance(layer, FlaxBatchNorm):
        return {"scale": w, "bias": b}
    raise TypeError(f"no Flax counterpart for {type(layer).__name__}")


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy: ``.numpy()`` of a host tensor would share its storage."""
    return t.detach().cpu().numpy().copy()


def params_to_flax(module: nn.Module, of=lambda p: p) -> dict[str, dict]:
    """The Flax params tree of ``module``, or of ``of(p)`` for each of its
    parameters p (e.g. an optimizer's moment of p), as numpy arrays."""
    out: dict = {}
    for path, layer in _layers(module):
        weight = (layer.embedding if isinstance(layer, Embed)
                  else layer.weight)
        bias = getattr(layer, "bias", None)
        bias = None if bias is None else _numpy(of(bias))
        _put(out, path, _to_flax(layer, _numpy(of(weight)), bias))
    return out


def _tensors_from_flax(module: nn.Module, params: Any):
    """(parameter, numpy array in its layout) for every parameter of
    ``module`` from a Flax params-shaped tree."""
    for path, layer in _layers(module):
        for attr, value in _to_torch(layer, _at(params, path)).items():
            yield getattr(layer, attr), np.array(value)


def load_jax_params(module: nn.Module, params: Any) -> nn.Module:
    """Copy a Flax params tree into ``module``'s parameters in place."""
    with torch.no_grad():
        for t, value in _tensors_from_flax(module, params):
            t.copy_(torch.tensor(value, dtype=t.dtype))
    return module


def load_jax_variables(module: nn.Module, variables: Any) -> nn.Module:
    """Copy JAX variables (nested dicts of arrays) into ``module`` in place;
    every parameter and BatchNorm buffer of the module must be given."""
    load_jax_params(module, variables["params"])
    stats = variables.get("batch_stats", {})
    with torch.no_grad():
        for path, layer in _layers(module):
            if isinstance(layer, FlaxBatchNorm):
                bn = _at(stats, path)
                layer.running_mean.copy_(torch.tensor(
                    np.array(bn["mean"]), dtype=torch.float32))
                layer.running_var.copy_(torch.tensor(
                    np.array(bn["var"]), dtype=torch.float32))
    return module


def to_jax_variables(module: nn.Module) -> dict[str, dict]:
    """The module's state as JAX variables (nested dicts of numpy arrays)."""
    stats: dict = {}
    for path, layer in _layers(module):
        if isinstance(layer, FlaxBatchNorm):
            _put(stats, path, {"mean": _numpy(layer.running_mean),
                               "var": _numpy(layer.running_var)})
    out = {"params": params_to_flax(module)}
    if stats:
        out["batch_stats"] = stats
    return out


def adam_to_optax(opt: torch.optim.Adam, module: nn.Module) -> dict:
    """optax.adam's state for ``module``'s parameters, as Flax writes it:
    ``{'0': {'count', 'mu', 'nu'}, '1': {}}`` (the chain's
    ``ScaleByAdamState`` and ``EmptyState``). A parameter that has not been
    stepped yet has zero moments, as optax's init gives."""
    steps = {int(opt.state[p]["step"]) if p in opt.state else 0
             for p in module.parameters()}
    if len(steps) != 1:
        raise ValueError(f"parameters at different Adam steps {steps}: "
                         "optax keeps one count")

    def moment(key):
        return lambda p: (opt.state[p][key] if p in opt.state
                          else torch.zeros_like(p))

    return {"0": {"count": np.asarray(steps.pop(), np.int32),
                  "mu": params_to_flax(module, moment("exp_avg")),
                  "nu": params_to_flax(module, moment("exp_avg_sq"))},
            "1": {}}


def load_optax_adam(opt: torch.optim.Adam, module: nn.Module,
                    state: Any) -> torch.optim.Adam:
    """Set ``opt``'s state for ``module``'s parameters from optax.adam's
    (``adam_to_optax``'s layout, as a checkpoint holds it)."""
    adam = state["0"]
    count = float(np.asarray(adam["count"]))
    mu = dict(_tensors_from_flax(module, adam["mu"]))
    nu = dict(_tensors_from_flax(module, adam["nu"]))
    for p in module.parameters():
        opt.state[p] = {
            # torch keeps the step as a float32 tensor on the host.
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.tensor(mu[p], dtype=p.dtype, device=p.device),
            "exp_avg_sq": torch.tensor(nu[p], dtype=p.dtype,
                                       device=p.device)}
    return opt
