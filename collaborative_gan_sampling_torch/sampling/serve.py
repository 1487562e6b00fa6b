"""Serving path: one calibrated (G, D) pair and a stream of requests for
accepted samples.

Counterpart of ``collaborative_gan_sampling_tpu/sampling/serve.py``. Where
the JAX sampler compiles its round once, PyTorch runs eagerly, so a round
here is a loop of ``num_batches`` draws that stays on the device; the
kernels it reaches (the MLP- or conv-D refinement and the DRS accept step)
are built once, at their first launch. DRS calibration (the burn-in logit
max M) runs once per ``generate`` and is carried as a 0-d device tensor.

Methods, the serving view of collab sampling:

    standard     raw G(z); accept all
    refinement   K-step refinement; accept all
    reject       DRS on raw G(z)
    collab       refinement + DRS under a *shaped* D: shaping happens once,
                 before serving (``sample(..., method="collab")`` returns the
                 shaped D in ``aux['shaped_d']``); requests never change D.

A conditional pair serves random labels, or with ``class_id`` that one
class for every sample (targeted serving); with ``per_class_drs`` M is one
per class and folds into the logits. MH-GAN is not offered, as in the JAX
package.
"""

from __future__ import annotations

import time

import torch

from collaborative_gan_sampling_torch.config import RefineConfig
from collaborative_gan_sampling_torch.data.images import denormalize_images
from collaborative_gan_sampling_torch.models import GANBundle
from collaborative_gan_sampling_torch.sampling.refine import (
    make_draw_refine_fn,
)
from collaborative_gan_sampling_torch.sampling.rejection import (
    drs_accept_mask,
    estimate_logit_max,
    estimate_logit_max_per_class,
    fold_per_class,
)

SERVING_METHODS = ("standard", "refinement", "reject", "collab")


class ServingSampler:
    """Sampler for one (bundle, RefineConfig, method) triple.

    Usage:
        srv = ServingSampler(bundle, cfg, method="collab")
        m = srv.calibrate(g, shaped_d, generator)           # burn-in, once
        x, labels, acc, logits = srv.round(g, shaped_d, m, generator)
        samples, labels, stats = srv.generate(g, shaped_d, generator, n)
    """

    def __init__(self, bundle: GANBundle, cfg: RefineConfig,
                 method: str = "collab", class_id: int | None = None):
        if method not in SERVING_METHODS:
            raise ValueError(
                f"serving supports {SERVING_METHODS}, not {method!r}")
        if class_id is not None and not bundle.conditional:
            raise ValueError("class_id needs a conditional model")
        if class_id is not None and not 0 <= class_id < bundle.num_classes:
            raise ValueError(
                f"class_id {class_id} out of range [0, {bundle.num_classes})")
        self.bundle, self.cfg, self.method = bundle, cfg, method
        self.class_id = class_id
        self._refine_on = method in ("refinement", "collab")
        self._reject_on = method in ("reject", "collab")
        self._per_class = cfg.per_class_drs and bundle.conditional
        self._draw_refine = (make_draw_refine_fn(bundle, cfg)
                             if self._refine_on else None)

    def _labels_for(self, generator, n: int) -> torch.Tensor | None:
        """Every sample ``class_id``, or random labels (None when
        unconditional)."""
        if self.class_id is not None:
            return torch.full((n,), self.class_id, dtype=torch.int64,
                              device=self.bundle.device)
        return self.bundle.sample_labels(generator, n)

    def _draw_score(self, g, d, generator, n: int):
        """One candidate batch, its labels and its final logits (refined
        when on)."""
        labels = self._labels_for(generator, n)
        if self._refine_on:
            return self._draw_refine(g, d, generator, n, labels=labels)
        z = self.bundle.sample_z(generator, n)
        with torch.no_grad():
            x = self.bundle.generate(g, z, labels, train=False)
            return x, labels, self.bundle.discriminate(d, x, labels,
                                                       train=False)

    def calibrate(self, g, d, generator: torch.Generator | None
                  ) -> torch.Tensor:
        """Burn-in DRS calibration M: a 0-d tensor, or with per-class DRS
        one per class (a 0-d 0.0 for accept-all methods)."""
        if not self._reject_on:
            return torch.zeros((), device=self.bundle.device)

        def burn(gen, n):
            x, labels, _ = self._draw_score(g, d, gen, n)
            return x, labels

        if self._per_class:
            return estimate_logit_max_per_class(
                self.bundle, d, burn, generator, self.cfg.burn_in,
                self.cfg.batch_size)
        return estimate_logit_max(self.bundle, d, burn, generator,
                                  self.cfg.burn_in, self.cfg.batch_size)

    def round(self, g, d, m: torch.Tensor,
              generator: torch.Generator | None):
        """One serving round: (samples, labels or None, accept, logits)
        with ``num_batches * batch_size`` candidates, all on the device."""
        cfg = self.cfg
        xs, labels, accs, logits = [], [], [], []
        for _ in range(cfg.num_batches):
            x, lab, lg = self._draw_score(g, d, generator, cfg.batch_size)
            if self._reject_on:
                eff, eff_m = (fold_per_class(lg, m, lab) if self._per_class
                              else (lg, m))
                acc = drs_accept_mask(generator, eff, eff_m, cfg.gamma,
                                      cfg.eps_drs, cfg.gamma_percentile,
                                      use_pallas=cfg.use_pallas)
            else:
                acc = torch.ones(lg.shape, dtype=torch.bool, device=lg.device)
            xs.append(x)
            labels.append(lab)
            accs.append(acc)
            logits.append(lg)
        labels = torch.cat(labels) if self.bundle.conditional else None
        return torch.cat(xs), labels, torch.cat(accs), torch.cat(logits)

    @staticmethod
    def compact(x: torch.Tensor, labels: torch.Tensor | None,
                acc: torch.Tensor, cap: int, quantize: bool
                ) -> tuple[torch.Tensor, torch.Tensor | None, int]:
        """The first ``cap`` accepted rows and their labels, gathered on the
        device (uint8 by ``denormalize_images`` when ``quantize``) and then
        fetched to the host, so the transfer is O(accepted), not
        O(candidates). Returns (rows, labels or None, count)."""
        idx = torch.nonzero(acc)[:cap, 0]
        x_sel = x[idx]
        if quantize:
            x_sel = denormalize_images(x_sel)
        lab = labels[idx].cpu() if labels is not None else None
        return x_sel.cpu(), lab, int(idx.shape[0])

    def generate(self, g, d, generator: torch.Generator | None, n: int,
                 max_rounds: int = 1000, quantize_images: bool = True):
        """Run rounds until >= n samples are accepted.

        Returns (samples[n] on the host, their labels or None, stats).
        Image samples come
        back uint8 in [0, 255] by default (quantized on the device, before
        the fetch); 2D samples stay float32. The first round, which also
        builds the kernels and sizes the compaction buffer, keeps its
        samples but is left out of the reported rate."""
        quantize = quantize_images and len(self.bundle.data_shape) == 3
        m = self.calibrate(g, d, generator)
        per_round = self.cfg.num_batches * self.cfg.batch_size
        x0, lab0, acc0, _ = self.round(g, d, m, generator)
        rate0 = float(acc0.float().mean())
        # 30% headroom; a round that overflows contributes `cap` samples
        # (the first k of an iid accepted set are still unbiased).
        cap = min(per_round, max(64, int(per_round * (1.3 * rate0 + 0.05))))

        xs, labs, total, rounds, overflow = [], [], 0, 0, 0

        def take(x, labels, acc):
            nonlocal total, rounds, overflow
            x_sel, lab_sel, k = self.compact(x, labels, acc, cap, quantize)
            overflow += int(acc.sum()) - k
            xs.append(x_sel)
            labs.append(lab_sel)
            total += k
            rounds += 1
            return k

        warm = take(x0, lab0, acc0)
        timed = 0
        t0 = time.perf_counter()
        while total < n:
            if rounds >= max_rounds:
                raise RuntimeError(
                    f"generate: {total}/{n} accepted after {rounds} rounds "
                    f"(accept rate too low - relax gamma/gamma_percentile)")
            x, labels, acc, _ = self.round(g, d, m, generator)
            timed += take(x, labels, acc)
        dt = time.perf_counter() - t0

        samples = torch.cat(xs)[:n]
        labels = torch.cat(labs)[:n] if self.bundle.conditional else None
        stats = {
            "n": int(n),
            "rounds": rounds,
            "candidates": rounds * per_round,
            "accept_rate": (total + overflow) / (rounds * per_round),
            "overflow_dropped": overflow,
            "seconds": dt,
            # Accepted samples per second over the rounds after the first;
            # None when the first round alone satisfied n.
            "samples_per_sec": timed / dt if timed else None,
            "warmup_samples": warm,
            "dtype": "uint8" if quantize else "float32",
            "method": self.method,
        }
        return samples, labels, stats
