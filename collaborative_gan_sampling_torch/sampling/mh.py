"""MH-GAN: Metropolis-Hastings sampling from a trained GAN.

Counterpart of ``collaborative_gan_sampling_tpu/sampling/mh.py`` (Turner et
al. 2019). G is an independence proposal; with the calibrated D score
s(x) = sigmoid(a * D(x) + b), a proposal x' replaces the chain's x with
probability

    alpha = min(1, (1/s(x) - 1) / (1/s(x') - 1)).

The calibration (a, b) is Platt scaling, fit by plain gradient descent on
the device. B chains run side by side, one G proposal each per step.
"""

from __future__ import annotations

import torch

from collaborative_gan_sampling_torch.models import GANBundle


def fit_platt(logits_real: torch.Tensor, logits_fake: torch.Tensor,
              iters: int = 200, lr: float = 0.1
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fit (a, b) so that sigmoid(a * logit + b) separates real (1) from fake
    (0): ``iters`` gradient-descent steps of size ``lr`` on the mean logistic
    loss, on logits standardized to unit spread (the slope is unscaled after),
    so that the fixed step stays stable whatever D's raw logit spread."""
    logits = torch.cat([logits_real, logits_fake]).float()
    y = torch.cat([torch.ones_like(logits_real),
                   torch.zeros_like(logits_fake)]).float()
    scale = logits.std(correction=0) + 1e-6
    zs = logits / scale
    a = torch.ones((), device=logits.device)
    b = torch.zeros((), device=logits.device)
    for _ in range(iters):
        # d/dz [softplus(z) - y z] = sigmoid(z) - y
        r = torch.sigmoid(a * zs + b) - y
        a, b = a - lr * (r * zs).mean(), b - lr * r.mean()
    return a / scale, b


def calibrated_score(logits: torch.Tensor, a, b) -> torch.Tensor:
    return torch.sigmoid(a * logits + b)


def _uniform(generator: torch.Generator | None, n: int,
             device) -> torch.Tensor:
    """The chain's acceptance uniforms, (n,) in [0, 1)."""
    return torch.rand(n, generator=generator, device=device)


def make_mh_sampler(bundle: GANBundle, chain_len: int):
    """Build ``mh(d, g, generator, x_init, labels, a, b) -> (x_final, aux)``.

    ``x_init`` (B, ...) seeds B independent chains; each chain takes
    ``chain_len`` fresh G proposals (z from ``bundle.sample_z``, then u from
    ``_uniform``, per step). aux['accept_rate'] is the mean MH acceptance
    over the run; aux['n_accepts'] (B,) counts acceptances per chain. A
    chain with n_accepts == 0 still holds its initializer, which callers
    that seed chains with real data must drop."""

    @torch.no_grad()
    def mh(d, g, generator: torch.Generator | None, x_init: torch.Tensor,
           labels: torch.Tensor | None, a, b):
        batch = x_init.shape[0]
        x_cur = x_init
        s_cur = calibrated_score(
            bundle.discriminate(d, x_init, labels, train=False), a, b)
        n_acc = torch.zeros(batch, device=x_init.device)
        for _ in range(chain_len):
            z = bundle.sample_z(generator, batch)
            x_prop = bundle.generate(g, z, labels, train=False)
            s_prop = calibrated_score(
                bundle.discriminate(d, x_prop, labels, train=False), a, b)
            eps = 1e-8
            ratio = (1.0 / (s_cur + eps) - 1.0) / (1.0 / (s_prop + eps) - 1.0)
            alpha = torch.clamp_max(ratio, 1.0)
            take = _uniform(generator, batch, x_init.device) < alpha
            x_cur = torch.where(
                take.reshape((batch,) + (1,) * (x_cur.ndim - 1)), x_prop,
                x_cur)
            s_cur = torch.where(take, s_prop, s_cur)
            n_acc = n_acc + take.float()
        aux = {"score": s_cur, "accept_rate": n_acc.mean() / chain_len,
               "n_accepts": n_acc}
        return x_cur, aux

    return mh
