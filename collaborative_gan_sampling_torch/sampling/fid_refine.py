"""FID-backprop sample refinement (arXiv:2009.14075).

Counterpart of ``collaborative_gan_sampling_tpu/sampling/fid_refine.py``:
refine a batch by descending the Frechet distance between its own feature
moments and the real ones,

    x  <-  x - rate * B * clip(d FID(stats(features(x)), real) / dx),

with the gradient taken by autograd through the feature net, the batch
moments and a Newton-Schulz square root. The batch's moments couple its
samples. Newton-Schulz, not eigh: its unrolled matmuls differentiate
stably, where eigh's gradient blows up on the near-degenerate eigenvalues
of a batch covariance; a trace-scaled jitter (eps 1e-3) keeps the
rank-deficient product inside its region. Float32, TF32 off on the card.
"""

from __future__ import annotations

from typing import Callable

import torch

from collaborative_gan_sampling_torch.evals.fid import (
    FIDStats,
    stats_from_features,
)
from collaborative_gan_sampling_torch.ops.sqrtm import trace_sqrtm_product
from collaborative_gan_sampling_torch.utils.precision import full_f32


@full_f32
def fid_loss(x: torch.Tensor, feature_fn: Callable, real_stats: FIDStats,
             ns_iters: int = 10, eps: float = 1e-3) -> torch.Tensor:
    """Differentiable Frechet distance between the batch's stats and the
    real ones."""
    st = stats_from_features(feature_fn(x))
    diff = st.mu - real_stats.mu
    tr_cross = trace_sqrtm_product(st.sigma, real_stats.sigma, ns_iters, eps)
    return (diff @ diff + torch.trace(st.sigma)
            + torch.trace(real_stats.sigma) - 2.0 * tr_cross)


def make_fid_refine_fn(feature_fn: Callable, real_stats: FIDStats,
                       steps: int, rate: float, ns_iters: int = 10,
                       clip_norm: float = 1.0) -> Callable:
    """``refine(x0) -> (x_K, aux)``: K gradient steps on the batch FID, with
    aux = {'fid_start' (the loss at x0), 'fid_end' (at x_K, no gradient),
    'fid_trajectory' (the loss at each step's input)}.

    ns_iters 10: on a nearly rank-deficient, non-symmetric covariance
    product, Newton-Schulz contracts in float32 for its first ~10
    iterations only; more amplify the asymmetric noise and the loss blows
    up. Each sample's update is clipped to ``clip_norm``."""

    def refine(x0: torch.Tensor):
        # The batch moments average over B samples, so dFID/dx_i is O(1/B);
        # scaling by B makes rate a per-sample step size.
        scale = rate * x0.shape[0]
        x, vals = x0.detach().float(), []
        for _ in range(steps):
            xg = x.requires_grad_(True)
            val = fid_loss(xg, feature_fn, real_stats, ns_iters)
            (g,) = torch.autograd.grad(val, xg)
            u = scale * g
            if clip_norm > 0:
                dims = tuple(range(1, u.ndim))
                nrm = torch.sqrt((u * u).sum(dims, keepdim=True) + 1e-20)
                u = u * torch.clamp(clip_norm / nrm, max=1.0)
            x = (xg - u).detach()
            vals.append(val.detach())
        with torch.no_grad():
            fid_end = fid_loss(x, feature_fn, real_stats, ns_iters)
        fid_start = vals[0] if vals else fid_end
        traj = torch.stack(vals) if vals else fid_end.new_zeros((0,))
        return x, {"fid_start": fid_start, "fid_end": fid_end,
                   "fid_trajectory": traj}

    return refine
