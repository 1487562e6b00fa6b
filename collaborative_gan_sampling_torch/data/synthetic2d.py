"""2D Gaussian-mixture data, in PyTorch.

Counterpart of ``collaborative_gan_sampling_tpu/data/synthetic2d.py``: the
8-Gaussian ring, its imbalanced variant (mode weights 0.6^i, normalised) and
the 5x5 grid. The spec's tensors live on one device and ``sample_mixture``
draws there from the caller's ``torch.Generator``, so real batches for D
shaping never leave the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from collaborative_gan_sampling_torch.models import resolve_device


class MixtureSpec(NamedTuple):
    """A 2D Gaussian mixture with a shared isotropic std."""

    means: torch.Tensor  # (M, 2) float32
    weights: torch.Tensor  # (M,) float32, sums to 1
    std: float


def make_mixture(name: str, radius: float = 2.0, std: float = 0.1,
                 device: str | torch.device | None = None) -> MixtureSpec:
    """``ring8``, ``ring8_imbalanced`` or ``grid25``, on ``device`` (the card
    unless the caller asks for the CPU)."""
    if name in ("ring8", "ring8_imbalanced"):
        angles = np.arange(8) * (2.0 * np.pi / 8.0)
        means = radius * np.stack([np.cos(angles), np.sin(angles)], axis=1)
        if name == "ring8":
            weights = np.full(8, 1.0 / 8.0)
        else:
            weights = 0.6 ** np.arange(8)
            weights = weights / weights.sum()
    elif name == "grid25":
        xs = np.linspace(-radius, radius, 5)
        means = np.stack(np.meshgrid(xs, xs), axis=-1).reshape(-1, 2)
        weights = np.full(25, 1.0 / 25.0)
    else:
        raise ValueError(f"unknown 2D mixture {name!r}")
    dev = resolve_device(device)
    return MixtureSpec(
        means=torch.tensor(means, dtype=torch.float32, device=dev),
        weights=torch.tensor(weights, dtype=torch.float32, device=dev),
        std=float(std))


def sample_mixture(generator: torch.Generator | None, spec: MixtureSpec,
                   n: int) -> torch.Tensor:
    """n points (n, 2) float32: a categorical mode draw plus isotropic
    Gaussian noise, on the spec's device."""
    idx = torch.multinomial(spec.weights, n, replacement=True,
                            generator=generator)
    noise = torch.randn((n, 2), generator=generator,
                        device=spec.means.device)
    return spec.means[idx] + spec.std * noise


def log_density(spec: MixtureSpec, x: torch.Tensor) -> torch.Tensor:
    """Exact mixture log-density at x (N, 2), shape (N,)."""
    d2 = torch.sum((x[:, None, :] - spec.means[None, :, :]) ** 2, dim=-1)
    var = spec.std ** 2
    log_comp = -d2 / (2 * var) - math.log(2 * math.pi * var)
    return torch.logsumexp(torch.log(spec.weights)[None, :] + log_comp, dim=1)
