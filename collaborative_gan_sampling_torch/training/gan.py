"""GAN losses and the discriminator's real pass, in PyTorch.

Counterpart of the helpers of ``collaborative_gan_sampling_tpu/training/
gan.py`` that D shaping uses. The train chunk (d/g steps, FusedProp, EMA-G)
is not ported yet.

The JAX package threads BatchNorm statistics through ``_merge_stats``; here a
train-mode forward updates the running averages of the module in place, so
running the real pass and then the fake pass leaves the same statistics that
merging the two updates in that order does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nonsaturating_d_loss(logits_real: torch.Tensor,
                         logits_fake: torch.Tensor) -> torch.Tensor:
    return (F.softplus(-logits_real).mean()
            + F.softplus(logits_fake).mean())


def nonsaturating_g_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    return F.softplus(-logits_fake).mean()


def real_pass(bundle, d, x_real: torch.Tensor,
              labels_r: torch.Tensor | None, r1_gamma: float):
    """Train-mode D forward on the real batch (updating BN statistics once);
    with ``r1_gamma`` > 0 also E[||grad_x D(x_real)||^2] of that same
    forward, kept differentiable for the parameter gradient (R1,
    arXiv:1801.04406). Returns ``(logits_real, r1 or None)``; the caller
    scales r1 by gamma / 2."""
    if r1_gamma <= 0.0:
        return bundle.discriminate(d, x_real, labels_r, train=True), None
    x = x_real.detach().requires_grad_(True)
    lr = bundle.discriminate(d, x, labels_r, train=True)
    (gx,) = torch.autograd.grad(lr.sum(), x, create_graph=True)
    r1 = gx.float().square().sum(dim=tuple(range(1, gx.ndim))).mean()
    return lr, r1
