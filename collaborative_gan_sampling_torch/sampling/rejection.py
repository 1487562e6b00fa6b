"""Discriminator rejection sampling (DRS, arXiv:1810.06758) in PyTorch.

Counterpart of ``collaborative_gan_sampling_tpu/sampling/rejection.py``. With
F the D logit and M the burn-in estimate of max F, the acceptance probability
is sigmoid(F_hat) with F_hat = F - M - log(1 - exp(F - M - eps)) - gamma.
The accepted set is a boolean mask of the batch's shape.

Per-class DRS (conditional models) estimates one M per class and folds it
into the logits: the shift depends only on F - M, so ``logits - M[labels]``
with M = 0 is exact (``fold_per_class``).
"""

from __future__ import annotations

from typing import Callable

import torch

from collaborative_gan_sampling_torch.ops.accept import (
    bits_to_uniform,
    draw_seed,
    drs_accept_mask_from_uniform,
    drs_accept_mask_philox,
    drs_logit_shift,
    gamma_total,
    philox_bits_plain,
)
from collaborative_gan_sampling_torch.utils.profiling import span


def drs_acceptance_prob(logits: torch.Tensor, logit_max, gamma: float = 0.0,
                        eps: float = 1e-6,
                        gamma_percentile: float = 0.0) -> torch.Tensor:
    shifted = drs_logit_shift(logits, logit_max, 0.0, eps)
    return torch.sigmoid(shifted - gamma_total(shifted, gamma,
                                               gamma_percentile))


def drs_accept_mask(generator: torch.Generator | None, logits: torch.Tensor,
                    logit_max, gamma: float = 0.0, eps: float = 1e-6,
                    gamma_percentile: float = 0.0, use_pallas: bool = False,
                    uniforms: torch.Tensor | None = None,
                    seed: torch.Tensor | None = None) -> torch.Tensor:
    """Boolean accept mask, same shape as logits.

    With ``use_pallas`` and 1-D logits the whole step runs as the DRS accept
    kernel (``ops/accept.py``): the percentile of the expm1 shift, the
    shift, sigmoid, draw and compare in one launch up to ``STEP_CAP``
    logits (above it the percentile is taken with tensor ops first), u
    drawn inside it from a key taken from ``generator``. Otherwise u is
    drawn with ``torch.rand``. ``seed`` (an int64 Philox key) replaces the
    key's draw, and off the kernel gives u as the kernel draws it;
    ``uniforms`` replaces the draw in either case."""
    if use_pallas and logits.ndim == 1:
        if uniforms is not None:
            return drs_accept_mask_from_uniform(uniforms, logits, logit_max,
                                                gamma, eps, gamma_percentile)
        if seed is None:
            seed = draw_seed(generator, logits.device)
        return drs_accept_mask_philox(seed, logits, logit_max, gamma, eps,
                                      gamma_percentile)
    p = drs_acceptance_prob(logits, logit_max, gamma, eps, gamma_percentile)
    if uniforms is None and seed is not None:
        uniforms = bits_to_uniform(philox_bits_plain(
            seed, logits.numel())).reshape(logits.shape)
    elif uniforms is None:
        uniforms = torch.rand(logits.shape, generator=generator,
                              device=logits.device)
    return uniforms < p


def estimate_logit_max(bundle, d, sample_fn: Callable,
                       generator: torch.Generator | None, burn_in: int,
                       batch_size: int) -> torch.Tensor:
    """Burn-in estimate of M = max_x F(x) over ``burn_in // batch_size``
    (at least one) batches of ``sample_fn(generator, n) -> (x, labels)``;
    each batch's D forward and max is span ``cgs.drs.score``."""
    m = torch.tensor(float("-inf"), device=bundle.device)
    for _ in range(max(1, burn_in // batch_size)):
        x, labels = sample_fn(generator, batch_size)
        with span("cgs.drs.score"), torch.no_grad():
            logits = bundle.discriminate(d, x, labels, train=False)
            m = torch.maximum(m, logits.max())
    return m


def estimate_logit_max_per_class(bundle, d, sample_fn: Callable,
                                 generator: torch.Generator | None,
                                 burn_in: int, batch_size: int) -> torch.Tensor:
    """Per-class burn-in estimate M_c = max over the drawn samples of class
    c, shape (bundle.num_classes,), by a scatter-max; a class never drawn
    takes the global max."""
    num_classes = bundle.num_classes
    m = torch.full((num_classes,), float("-inf"), device=bundle.device)
    for _ in range(max(1, burn_in // batch_size)):
        x, labels = sample_fn(generator, batch_size)
        with span("cgs.drs.score"), torch.no_grad():
            logits = bundle.discriminate(d, x, labels, train=False)
            m = torch.maximum(m, class_max(logits, labels, num_classes))
    return torch.where(torch.isfinite(m), m, m.max())


def class_max(logits: torch.Tensor, labels: torch.Tensor,
              num_classes: int) -> torch.Tensor:
    """max logit of each class in one batch, -inf for a class not in it."""
    m = torch.full((num_classes,), float("-inf"), device=logits.device)
    return m.scatter_reduce(0, labels, logits, "amax")


def fold_per_class(logits: torch.Tensor, m: torch.Tensor,
                   labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(logits - M[labels], 0): the DRS inputs of per-class M with the
    global M's entry, a 0-d zero made on the device."""
    return logits - m[labels], torch.zeros((), device=logits.device)
