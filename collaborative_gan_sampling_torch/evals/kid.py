"""Kernel Inception Distance (KID): MMD^2 with a polynomial kernel.

Counterpart of ``collaborative_gan_sampling_tpu/evals/kid.py`` (Binkowski
et al., arXiv:1801.01401): k(x, y) = (x.y / d + 1)^3, the unbiased MMD^2
estimator, reported as mean and std over random subsets. The std is the
population std, as ``jnp.std`` gives.

``kid`` draws each subset without replacement with ``torch.randperm`` from
the given generator; ``jax.random.choice`` cannot be reproduced, so
``kid_from_indices`` takes the subsets' indices (the parity entry).
"""

from __future__ import annotations

import torch

from collaborative_gan_sampling_torch.utils.precision import full_f32
from collaborative_gan_sampling_torch.utils.prng import fold_generator


def polynomial_kernel(x: torch.Tensor, y: torch.Tensor, degree: int = 3,
                      coef: float = 1.0) -> torch.Tensor:
    """k(x, y) = (x.y / d + coef)^degree."""
    d = x.shape[-1]
    return (x @ y.T / d + coef) ** degree


def mmd2_unbiased(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unbiased MMD^2 (U-statistic): the within-set Gram matrices' diagonals
    are left out (arXiv:1801.01401 eq. 2)."""
    m, n = x.shape[0], y.shape[0]
    kxx = polynomial_kernel(x, x)
    kyy = polynomial_kernel(y, y)
    kxy = polynomial_kernel(x, y)
    sum_xx = (kxx.sum() - torch.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - torch.trace(kyy)) / (n * (n - 1))
    return sum_xx + sum_yy - 2.0 * kxy.mean()


@full_f32
def kid_from_indices(feats_real: torch.Tensor, feats_fake: torch.Tensor,
                     real_idx: torch.Tensor, fake_idx: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """KID mean and population std over the subsets whose row indices are
    ``real_idx`` and ``fake_idx``, each (n_subsets, subset size)."""
    xr, xf = feats_real.float(), feats_fake.float()
    vals = torch.stack([mmd2_unbiased(xr[i], xf[j])
                        for i, j in zip(real_idx, fake_idx)])
    return vals.mean(), vals.std(correction=0)


def kid(feats_real: torch.Tensor, feats_fake: torch.Tensor,
        generator: torch.Generator, n_subsets: int = 10,
        subset_size: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """KID mean and std over ``n_subsets`` subsets of ``min(subset_size,
    n)`` rows per side, drawn without replacement; subset i draws from
    ``fold_generator(generator, i)``."""
    nr, nf = feats_real.shape[0], feats_fake.shape[0]
    s = min(subset_size, nr, nf)
    real_idx, fake_idx = [], []
    for i in range(n_subsets):
        gen = fold_generator(generator, i)
        dev = gen.device
        real_idx.append(torch.randperm(nr, generator=gen, device=dev)[:s])
        fake_idx.append(torch.randperm(nf, generator=gen, device=dev)[:s])
    return kid_from_indices(feats_real, feats_fake,
                            torch.stack(real_idx).to(feats_real.device),
                            torch.stack(fake_idx).to(feats_fake.device))
