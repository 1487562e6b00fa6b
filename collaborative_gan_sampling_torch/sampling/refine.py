"""Discriminator-guided refinement of samples in data space (x-space).

Counterpart of ``collaborative_gan_sampling_tpu/sampling/refine.py``:

    x_{k+1} = x_k - rate * grad_x l(D(x_k)),   l = softplus(-d) for 'ns',

with optional per-sample gradient clipping, Langevin noise, a per-sample
stop score and a proximal pull toward x_0. D runs in eval mode, so it is
per-sample decoupled and the gradient of the summed loss is each sample's
own. Where ``ops/conv_refine.supports_conv_refine_kernel`` holds, the K steps
run as a fused conv-D kernel in the model's compute dtype, as the JAX package
refines the same preset: ``fused_refine_conv28_bf16`` (bf16 matmul operands,
f32 sums) for a ``bfloat16`` model, ``fused_refine_conv28`` (f32) otherwise.
Where ``ops/refine_mlp.supports_mlp_refine_kernel`` holds, they run as the
fused MLP-D kernel, which reads D's own weight tensors. Each kernel takes
its plain version on the CPU and any rate. Elsewhere the steps run as autograd steps (``_refine_steps``, the
counterpart of JAX's ``_refine_scan``). Latent-space refinement
(``space='z'``) is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from collaborative_gan_sampling_torch.config import RefineConfig
from collaborative_gan_sampling_torch.models import GANBundle
from collaborative_gan_sampling_torch.ops.conv_refine import (
    fused_refine_conv28,
    fused_refine_conv28_bf16,
    supports_conv_refine_kernel,
)
from collaborative_gan_sampling_torch.ops.conv_refine_ref import fold_dcgan_d
from collaborative_gan_sampling_torch.ops.refine_mlp import (
    fused_refine_mlp,
    mlp_layers,
    supports_mlp_refine_kernel,
)

OBJECTIVES = ("ns", "kl", "saturating")


def refine_loss_per_sample(logits: torch.Tensor,
                           objective: str = "ns") -> torch.Tensor:
    """ns: softplus(-d); kl: -d; saturating: -softplus(d)."""
    if objective == "ns":
        return F.softplus(-logits)
    if objective == "kl":
        return -logits
    if objective == "saturating":
        return -F.softplus(logits)
    raise ValueError(f"unknown refine objective {objective!r}; "
                     f"have {OBJECTIVES}")


def _clip_per_sample(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    """Clip each sample's gradient to ``max_norm`` (L2 over non-batch axes)."""
    axes = tuple(range(1, g.ndim))
    norm = torch.sqrt(torch.sum(g * g, dim=axes, keepdim=True) + 1e-12)
    return g * torch.clamp_max(max_norm / norm, 1.0)


def _freeze_stopped(x_new: torch.Tensor, x: torch.Tensor,
                    logits: torch.Tensor, stop_score: float) -> torch.Tensor:
    """Keep x for samples that D scores >= stop_score at x."""
    active = torch.sigmoid(logits) < stop_score
    return torch.where(active.reshape(active.shape + (1,) * (x.ndim - 1)),
                       x_new, x)


def _normal_like(x: torch.Tensor,
                 generator: torch.Generator | None) -> torch.Tensor:
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


def make_refine_fn(bundle: GANBundle, cfg: RefineConfig,
                   return_trajectory: bool = False) -> Callable:
    """Build ``refine(d, x0, labels=None, generator=None, rate=None)
    -> (x_K, aux)``; aux = {'logits': D(x_K), 'traj': (K+1, B, ...) if
    requested}. ``rate`` (a float or a 0-d tensor) overrides cfg.rate."""
    steps, clip_norm = cfg.steps, cfg.clip_norm
    noise, objective = cfg.noise, cfg.objective
    stop_score, proximal = cfg.stop_score, cfg.proximal
    bf16 = bundle.cfg.compute_dtype == "bfloat16"

    def refine(d, x0: torch.Tensor, labels: torch.Tensor | None = None,
               generator: torch.Generator | None = None, rate=None):
        rate = cfg.rate if rate is None else rate
        if supports_conv_refine_kernel(bundle, cfg, labels,
                                       return_trajectory):
            fused = fused_refine_conv28_bf16 if bf16 else fused_refine_conv28
            x_k, logits = fused(fold_dcgan_d(d), x0, steps, rate)
            return x_k, {"logits": logits}
        if supports_mlp_refine_kernel(bundle, cfg, labels,
                                      return_trajectory):
            x_k, logits = fused_refine_mlp(mlp_layers(d), x0, steps,
                                           rate)
            return x_k, {"logits": logits}
        return _refine_steps(d, x0, labels, generator, rate)

    def _refine_steps(d, x0, labels, generator, rate):
        x0 = x0.detach()
        x, traj = x0, [x0]
        for _ in range(steps):
            with torch.enable_grad():
                xg = x.detach().requires_grad_(True)
                logits = bundle.discriminate(d, xg, labels, train=False)
                loss = refine_loss_per_sample(logits, objective).sum()
                (g,) = torch.autograd.grad(loss, xg)
            logits = logits.detach()
            if proximal > 0:
                g = g + proximal * (x - x0)
            if clip_norm > 0:
                g = _clip_per_sample(g, clip_norm)
            x_new = x - rate * g
            if noise > 0:
                x_new = x_new + (2.0 * rate * noise) ** 0.5 * _normal_like(
                    x, generator)
            if stop_score > 0:
                x_new = _freeze_stopped(x_new, x, logits, stop_score)
            x = x_new
            if return_trajectory:
                traj.append(x)
        with torch.no_grad():
            logits = bundle.discriminate(d, x, labels, train=False)
        aux = {"logits": logits}
        if return_trajectory:
            aux["traj"] = torch.stack(traj)
        return x, aux

    return refine


def make_draw_refine_fn(bundle: GANBundle, cfg: RefineConfig) -> Callable:
    """Build ``draw_refine(g, d, generator, n, labels=None, rate=None)
    -> (x, labels, logits)``: z ~ N(0, I), x0 = G(z), then K refinement
    steps."""
    if cfg.space != "x":
        raise NotImplementedError(
            f"refine.space={cfg.space!r}: only x-space refinement is ported")
    refine = make_refine_fn(bundle, cfg)

    def draw_refine(g, d, generator: torch.Generator | None, n: int,
                    labels: torch.Tensor | None = None, rate=None):
        z = bundle.sample_z(generator, n)
        with torch.no_grad():
            x0 = bundle.generate(g, z, labels, train=False)
        x, aux = refine(d, x0, labels, generator=generator, rate=rate)
        return x, labels, aux["logits"]

    return draw_refine
