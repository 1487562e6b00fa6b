"""Weights across the two packages: JAX variables <-> the port's modules.

JAX variables are given as nested dicts of numpy arrays,
``{'params': {...}, 'batch_stats': {...}}``, keyed by the Flax module names;
the port's submodules carry the same names. Layouts:

=====================  ========================  ===========================
layer                  Flax                      port
=====================  ========================  ===========================
Dense                  kernel (in, out)          weight (out, in)
Conv                   kernel (kh, kw, in, out)  weight (out, in, kh, kw)
ConvTranspose (SAME)   kernel (kh, kw, in, out)  weight (in, out, kh, kw),
                                                 spatially flipped
BatchNorm              scale, bias; mean, var    weight, bias; running_*
=====================  ========================  ===========================
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from collaborative_gan_sampling_torch.ops.nn import (
    Dense,
    FlaxBatchNorm,
    SameConv2d,
    SameConvTranspose2d,
)


def _to_torch(layer: nn.Module, p: dict) -> dict[str, np.ndarray]:
    if isinstance(layer, Dense):
        return {"weight": np.asarray(p["kernel"]).T,
                "bias": np.asarray(p["bias"])}
    if isinstance(layer, SameConv2d):
        return {"weight": np.asarray(p["kernel"]).transpose(3, 2, 0, 1),
                "bias": np.asarray(p["bias"])}
    if isinstance(layer, SameConvTranspose2d):
        k = np.asarray(p["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        return {"weight": k, "bias": np.asarray(p["bias"])}
    if isinstance(layer, FlaxBatchNorm):
        return {"weight": np.asarray(p["scale"]),
                "bias": np.asarray(p["bias"])}
    raise TypeError(f"no Flax counterpart for {type(layer).__name__}")


def _to_flax(layer: nn.Module) -> dict[str, np.ndarray]:
    w = layer.weight.detach().cpu().numpy()
    b = layer.bias.detach().cpu().numpy()
    if isinstance(layer, Dense):
        return {"kernel": w.T.copy(), "bias": b}
    if isinstance(layer, SameConv2d):
        return {"kernel": w.transpose(2, 3, 1, 0).copy(), "bias": b}
    if isinstance(layer, SameConvTranspose2d):
        return {"kernel": w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1).copy(),
                "bias": b}
    if isinstance(layer, FlaxBatchNorm):
        return {"scale": w, "bias": b}
    raise TypeError(f"no Flax counterpart for {type(layer).__name__}")


def load_jax_variables(module: nn.Module, variables: Any) -> nn.Module:
    """Copy JAX variables (nested dicts of arrays) into ``module`` in place;
    every parameter and BatchNorm buffer of the module must be given."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    with torch.no_grad():
        for name, layer in module.named_children():
            for attr, value in _to_torch(layer, params[name]).items():
                t = getattr(layer, attr)
                t.copy_(torch.tensor(np.array(value), dtype=t.dtype))
            if isinstance(layer, FlaxBatchNorm):
                layer.running_mean.copy_(torch.tensor(
                    np.array(stats[name]["mean"]), dtype=torch.float32))
                layer.running_var.copy_(torch.tensor(
                    np.array(stats[name]["var"]), dtype=torch.float32))
    return module


def to_jax_variables(module: nn.Module) -> dict[str, dict]:
    """The module's state as JAX variables (nested dicts of numpy arrays)."""
    params, stats = {}, {}
    for name, layer in module.named_children():
        params[name] = _to_flax(layer)
        if isinstance(layer, FlaxBatchNorm):
            stats[name] = {
                "mean": layer.running_mean.detach().cpu().numpy(),
                "var": layer.running_var.detach().cpu().numpy()}
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out
