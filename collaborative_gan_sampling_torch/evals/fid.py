"""FID: feature moments and the Frechet distance.

Counterpart of ``collaborative_gan_sampling_tpu/evals/fid.py``:

* ``stats_from_features``: exact (mu, Sigma) of a (N, F) feature matrix,
  unbiased covariance;
* ``streaming_stats``: (mu, Sigma) over batches with Chan's parallel merge
  (each batch's centred scatter plus the mean-delta correction). The
  one-pass sum / sum-of-squares formula cancels in float32 for features
  with large means (relu classifier features) and inflates the FID noise
  floor by orders of magnitude. Batch i draws from
  ``fold_generator(generator, i)`` where JAX uses ``fold_in(key, i)``;
* ``frechet_distance``: float32 on the device, the eigh cross term by
  default and Newton-Schulz when ``newton_schulz_iters > 0``;
* ``frechet_distance_host``: float64 numpy eigh, inf for non-finite moments
  (float32 cannot resolve FIDs that are ~1e-5 of the covariance trace);
* ``save_stats`` / ``load_stats``: npz with the JAX package's keys (``mu``,
  ``sigma``, ``n``, ``feature_net``; ``mean`` / ``cov`` accepted), so that
  files cross between the two packages;
* ``fid_between``, ``per_class_fid`` and ``intersection_intra_fid``.

Features and moments are float32 with TF32 off on the card
(``utils/precision.py``).
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from collaborative_gan_sampling_torch.ops.sqrtm import (
    trace_sqrtm_product,
    trace_sqrtm_product_eigh,
)
from collaborative_gan_sampling_torch.utils.precision import full_f32
from collaborative_gan_sampling_torch.utils.prng import fold_generator


class FIDStats(NamedTuple):
    mu: torch.Tensor  # (F,)
    sigma: torch.Tensor  # (F, F)
    n: torch.Tensor  # scalar float32


@full_f32
def stats_from_features(feats: torch.Tensor) -> FIDStats:
    """Exact (mu, Sigma) of a (N, F) feature matrix (unbiased covariance)."""
    n = feats.shape[0]
    feats = feats.float()
    mu = feats.mean(0)
    centered = feats - mu
    sigma = (centered.T @ centered) / (n - 1)
    return FIDStats(mu, sigma, torch.tensor(float(n), device=feats.device))


@full_f32
def streaming_stats(feature_fn: Callable, batch_fn: Callable,
                    num_batches: int, batch_size: int,
                    generator: torch.Generator) -> FIDStats:
    """(mu, Sigma) over ``num_batches`` batches of ``batch_fn(generator_i,
    batch_size)`` (images in [-1, 1]) through ``feature_fn(x) -> (n, F)``,
    merged by Chan's update; the (N, F) feature matrix is never held."""
    n_a = mu_a = m2_a = None
    with torch.no_grad():
        for i in range(num_batches):
            f = feature_fn(batch_fn(fold_generator(generator, i),
                                    batch_size)).float()
            n_b = torch.tensor(float(f.shape[0]), device=f.device)
            mu_b = f.mean(0)
            fc = f - mu_b
            m2_b = fc.T @ fc  # centred scatter of this batch (stable)
            if n_a is None:  # the merge with an empty accumulator
                n_a = torch.zeros((), device=f.device)
                mu_a = torch.zeros_like(mu_b)
                m2_a = torch.zeros_like(m2_b)
            delta = mu_b - mu_a
            n = n_a + n_b
            mu_a = mu_a + delta * (n_b / n)
            m2_a = m2_a + m2_b + torch.outer(delta, delta) * (n_a * n_b / n)
            n_a = n
    return FIDStats(mu_a, m2_a / (n_a - 1.0), n_a)


@full_f32
def frechet_distance(a: FIDStats, b: FIDStats,
                     newton_schulz_iters: int = 0) -> torch.Tensor:
    """||mu_a - mu_b||^2 + Tr(Sa + Sb - 2 (Sa Sb)^(1/2)) in float32 on the
    stats' device: the eigh cross term (exact for rank-deficient
    covariances) at ``newton_schulz_iters == 0``, else Newton-Schulz."""
    diff = a.mu - b.mu
    if newton_schulz_iters > 0:
        tr_cross = trace_sqrtm_product(a.sigma, b.sigma, newton_schulz_iters)
    else:
        tr_cross = trace_sqrtm_product_eigh(a.sigma, b.sigma)
    return (diff @ diff + torch.trace(a.sigma) + torch.trace(b.sigma)
            - 2.0 * tr_cross)


def _f64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64)


def frechet_distance_host(a: FIDStats, b: FIDStats) -> float:
    """The Frechet distance in float64 numpy on the host; inf when a moment
    is not finite (divergent samples), rather than a LAPACK failure."""
    mu_a, mu_b, s_a, s_b = (_f64(t) for t in (a.mu, b.mu, a.sigma, b.sigma))
    if not (np.isfinite(mu_a).all() and np.isfinite(mu_b).all()
            and np.isfinite(s_a).all() and np.isfinite(s_b).all()):
        return float("inf")

    def psd_sqrt(s):
        s = 0.5 * (s + s.T)
        d, u = np.linalg.eigh(s)
        return (u * np.sqrt(np.maximum(d, 0.0))) @ u.T

    asq = psd_sqrt(s_a)
    m = asq @ s_b @ asq
    ev = np.linalg.eigvalsh(0.5 * (m + m.T))
    tr_cross = np.sum(np.sqrt(np.maximum(ev, 0.0)))
    diff = mu_a - mu_b
    return float(diff @ diff + np.trace(s_a) + np.trace(s_b) - 2 * tr_cross)


def save_stats(path: str, stats: FIDStats, feature_net: str = "") -> None:
    """Write (mu, Sigma, n) and the feature net's label to an npz, atomically
    (the JAX package's keys, pytorch-fid's ``mu`` / ``sigma``)."""
    tmp = path + ".tmp"
    np.savez(tmp, **{k: _f64(t).astype(np.float32)
                     for k, t in zip(("mu", "sigma", "n"), stats)},
             feature_net=np.asarray(feature_net))
    # np.savez appends .npz to paths without it
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_stats(path: str, device: str | torch.device = "cpu"
               ) -> tuple[FIDStats, str]:
    """(FIDStats on ``device``, feature-net label) from an npz written by
    either package's ``save_stats`` or by pytorch-fid / TTUR tooling
    (``mu`` / ``sigma``, or ``mean`` / ``cov``). The label is "" when the
    file carries none."""
    with np.load(path, allow_pickle=False) as z:
        keys = set(z.files)
        mu_key = "mu" if "mu" in keys else "mean" if "mean" in keys else None
        sig_key = ("sigma" if "sigma" in keys
                   else "cov" if "cov" in keys else None)
        if mu_key is None or sig_key is None:
            raise ValueError(
                f"{path}: not a FID-stats npz — expected keys mu/sigma "
                f"(or mean/cov), found {sorted(keys)}")
        mu = torch.tensor(np.asarray(z[mu_key], np.float32), device=device)
        sigma = torch.tensor(np.asarray(z[sig_key], np.float32),
                             device=device)
        n = float(z["n"]) if "n" in keys else 0.0
        label = str(z["feature_net"]) if "feature_net" in keys else ""
    if mu.ndim != 1 or sigma.shape != (mu.shape[0], mu.shape[0]):
        raise ValueError(
            f"{path}: inconsistent stats shapes mu={tuple(mu.shape)}, "
            f"sigma={tuple(sigma.shape)}")
    return FIDStats(mu, sigma, torch.tensor(n, device=device)), label


def fid_between(feature_fn: Callable, real_fn: Callable, fake_fn: Callable,
                num_samples: int, batch_size: int,
                generator: torch.Generator,
                newton_schulz_iters: int = 20) -> torch.Tensor:
    """FID between two samplers ``fn(generator, n) -> x``, on the device."""
    num_batches = max(1, num_samples // batch_size)
    real = streaming_stats(feature_fn, real_fn, num_batches, batch_size,
                           fold_generator(generator, 0))
    fake = streaming_stats(feature_fn, fake_fn, num_batches, batch_size,
                           fold_generator(generator, 1))
    return frechet_distance(real, fake, newton_schulz_iters)


def _host_stats(feats: np.ndarray) -> FIDStats:
    """A class's moments in float64, kept as float32 as the JAX package
    keeps them."""
    return FIDStats(feats.mean(0).astype(np.float32),
                    np.cov(feats, rowvar=False).astype(np.float32),
                    float(feats.shape[0]))


def per_class_fid(feats_real, labels_real, feats_fake, labels_fake,
                  min_count: int = 32, max_classes: int = 0,
                  classes=None) -> dict:
    """Intra-FID: the float64 host FID per class, averaged. Classes with
    fewer than ``min_count`` samples on either side are skipped; with
    ``max_classes`` > 0 only that many most frequent classes of the fake
    pool are scored, with ``classes`` only those. Returns
    {"intra_fid", "intra_fid_classes", "per_class": {label: fid}}."""
    fr, ff = _f64(feats_real), _f64(feats_fake)
    lr = np.asarray(_f64(labels_real)).astype(np.int64).ravel()
    lf = np.asarray(_f64(labels_fake)).astype(np.int64).ravel()
    if classes is not None:
        classes = np.asarray(sorted(classes))
    else:
        classes, counts = np.unique(lf, return_counts=True)
        classes = classes[np.argsort(-counts)]
        if max_classes > 0:
            classes = classes[:max_classes]

    per = {}
    for c in classes:
        r, f = fr[lr == c], ff[lf == c]
        if r.shape[0] < min_count or f.shape[0] < min_count:
            continue
        per[int(c)] = frechet_distance_host(_host_stats(r), _host_stats(f))
    if not per:
        return {"intra_fid": float("inf"), "intra_fid_classes": 0,
                "per_class": {}}
    return {"intra_fid": float(np.mean(list(per.values()))),
            "intra_fid_classes": len(per), "per_class": per}


def intersection_intra_fid(per_class_tables: dict) -> dict:
    """Several arms' intra-FID re-scored over the classes all of them
    measured: {arm: {class: fid}} (string class keys accepted) ->
    {"classes": N, "intra_fid": {arm: mean over the common classes}}."""
    norm = {arm: {int(c): float(v) for c, v in table.items()}
            for arm, table in per_class_tables.items()}
    common = (set.intersection(*(set(t) for t in norm.values())) if norm
              else set())
    if not common:
        return {"classes": 0,
                "intra_fid": {arm: float("inf") for arm in norm}}
    return {"classes": len(common),
            "intra_fid": {arm: float(np.mean([t[c] for c in sorted(common)]))
                          for arm, t in norm.items()}}
