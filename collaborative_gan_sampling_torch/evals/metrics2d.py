"""2D mixture metrics: %HQ, mode-histogram KL and modes covered.

Counterpart of ``collaborative_gan_sampling_tpu/evals/metrics2d.py`` (the
paper's definitions, arXiv:1902.00813):

* %HQ: the share of samples within ``hq_std`` stds of their nearest mode;
* KL(empirical mode histogram of the HQ samples || mixture weights);
* modes_covered: modes holding more than 1% / M of the HQ mass.

Plain tensor code on the samples' device, O(N * M) distances.
"""

from __future__ import annotations

import torch

from collaborative_gan_sampling_torch.data.synthetic2d import MixtureSpec


def mode_assignments(samples: torch.Tensor, spec: MixtureSpec
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(nearest-mode index (N,), distance to it (N,))."""
    d2 = torch.sum((samples[:, None, :] - spec.means[None, :, :]) ** 2,
                   dim=-1)
    d2_min, idx = torch.min(d2, dim=1)
    return idx, torch.sqrt(d2_min)


def metrics_2d(samples: torch.Tensor, spec: MixtureSpec,
               hq_std: float = 4.0,
               weights: torch.Tensor | None = None
               ) -> dict[str, torch.Tensor]:
    """%HQ, KL and modes_covered of a pool of 2D samples, as 0-d float32
    tensors. ``weights`` weighs each sample (e.g. the accept mask as float,
    to score only the accepted samples without compacting them)."""
    n_modes = spec.means.shape[0]
    idx, dist = mode_assignments(samples, spec)
    if weights is None:
        weights = torch.ones(samples.shape[0], device=samples.device)
    weights = weights.float()
    total = torch.sum(weights) + 1e-12

    hq_mask = (dist < hq_std * spec.std).float() * weights
    pct_hq = torch.sum(hq_mask) / total

    # Mode histogram over the HQ samples; tiny uniform mass if none is HQ.
    counts = torch.zeros(n_modes, device=samples.device).index_add_(
        0, idx, hq_mask)
    hist = (counts + 1e-9) / (torch.sum(counts) + n_modes * 1e-9)
    kl = torch.sum(hist * (torch.log(hist) - torch.log(spec.weights + 1e-12)))

    modes_covered = torch.sum(
        (counts / (torch.sum(counts) + 1e-12)) > (0.01 / n_modes))
    return {"pct_hq": pct_hq, "kl": kl,
            "modes_covered": modes_covered.float()}
