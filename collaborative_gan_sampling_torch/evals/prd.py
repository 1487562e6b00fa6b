"""Improved precision and recall (k-NN manifolds, arXiv:1904.06991).

Counterpart of ``collaborative_gan_sampling_tpu/evals/prd.py``: precision is
the share of generated samples inside the real manifold (within some real
point's distance to its k-th nearest real neighbour), recall the share of
real samples inside the generated one. The all-pairs squared distances are
one matmul plus the norms, clamped at 0; the k-th smallest distance to
another point is ``torch.kthvalue`` with the point's own distance set to
+inf. Float32, TF32 off on the card.
"""

from __future__ import annotations

import torch

from collaborative_gan_sampling_torch.utils.precision import full_f32


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, D), (M, D) -> (N, M) squared euclidean distances, float32."""
    a, b = a.float(), b.float()
    a2 = (a * a).sum(1, keepdim=True)
    b2 = (b * b).sum(1, keepdim=True)
    return torch.clamp_min(a2 + b2.T - 2.0 * (a @ b.T), 0.0)


def knn_radii(feats: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Squared distance of each point to its k-th nearest other point."""
    d = _sq_dists(feats, feats)
    d.fill_diagonal_(float("inf"))  # exclude self
    return torch.kthvalue(d, k, dim=1).values


def manifold_membership(queries: torch.Tensor, support: torch.Tensor,
                        radii: torch.Tensor) -> torch.Tensor:
    """For each query, whether it lies within some support point's radius."""
    return (_sq_dists(queries, support) <= radii[None, :]).any(1)


@full_f32
def precision_recall(real_feats: torch.Tensor, fake_feats: torch.Tensor,
                     k: int = 3) -> dict[str, torch.Tensor]:
    """{'precision', 'recall'} in [0, 1] over a feature space. Both pools
    must hold more than k points: with n <= k the radius is the +inf self
    distance and every query would trivially belong."""
    if real_feats.shape[0] <= k or fake_feats.shape[0] <= k:
        raise ValueError(
            f"precision_recall needs > k={k} points per pool, got "
            f"{real_feats.shape[0]} real / {fake_feats.shape[0]} fake "
            "(k-NN radii are undefined; guard tiny accepted pools upstream)")
    r_real = knn_radii(real_feats, k)
    r_fake = knn_radii(fake_feats, k)
    precision = manifold_membership(fake_feats, real_feats, r_real).float()
    recall = manifold_membership(real_feats, fake_feats, r_fake).float()
    return {"precision": precision.mean(), "recall": recall.mean()}
