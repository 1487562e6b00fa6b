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

A round is a pure function of its draws (``_round_from``: z, labels and
each batch's Philox key of the accept step). ``round`` draws them from a
``torch.Generator`` as it goes; ``round_seeded`` derives them from one
int64 seed tensor by counter-based Philox on tensor ops
(``utils/prng.py``), which is what ``sampling/export.py`` traces into its
artifact: a ``torch.Generator`` cannot be an input of an exported program.
The two give different draws, as JAX's artifact draws from its own key.

With a ``group`` (JAX ``serve.py:68-109`` under a mesh) the candidates of a
batch are drawn whole, G and the refinement run on the rank's slice, and
the batch and its logits are gathered whole, so calibration and the accept
step see the whole batch on every rank, as in ``sampling/collab.py``. An
exported artifact is one process's program (``sampling/export.py``
refuses a sampler with a group).
"""

from __future__ import annotations

import time

import torch

from collaborative_gan_sampling_torch.config import RefineConfig
from collaborative_gan_sampling_torch.data.images import denormalize_images
from collaborative_gan_sampling_torch.models import GANBundle
from collaborative_gan_sampling_torch.parallel.mesh import run_sharded
from collaborative_gan_sampling_torch.sampling.refine import (
    make_refine_z_fn,
)
from collaborative_gan_sampling_torch.sampling.rejection import (
    drs_accept_mask,
    estimate_logit_max,
    estimate_logit_max_per_class,
    fold_per_class,
)
from collaborative_gan_sampling_torch.utils.prng import (
    PhiloxNormals,
    philox_keys,
    philox_normal,
    philox_randint,
)
from collaborative_gan_sampling_torch.utils.profiling import count, span

SERVING_METHODS = ("standard", "refinement", "reject", "collab")


class ServingSampler:
    """Sampler for one (bundle, RefineConfig, method) triple.

    Usage:
        srv = ServingSampler(bundle, cfg, method="collab")
        m = srv.calibrate(g, shaped_d, generator)           # burn-in, once
        x, labels, acc, logits = srv.round(g, shaped_d, m, generator)
        x, labels, acc, logits = srv.round_seeded(g, shaped_d, m, seed)
        samples, labels, stats = srv.generate(g, shaped_d, generator, n)
    """

    def __init__(self, bundle: GANBundle, cfg: RefineConfig,
                 method: str = "collab", class_id: int | None = None,
                 group=None):
        if method not in SERVING_METHODS:
            raise ValueError(
                f"serving supports {SERVING_METHODS}, not {method!r}")
        if class_id is not None and not bundle.conditional:
            raise ValueError("class_id needs a conditional model")
        if class_id is not None and not 0 <= class_id < bundle.num_classes:
            raise ValueError(
                f"class_id {class_id} out of range [0, {bundle.num_classes})")
        self.bundle, self.cfg, self.method = bundle, cfg, method
        self.class_id, self.group = class_id, group
        self._refine_on = method in ("refinement", "collab")
        self._reject_on = method in ("reject", "collab")
        self._per_class = cfg.per_class_drs and bundle.conditional
        self._refine_z = (make_refine_z_fn(bundle, cfg, group)
                          if self._refine_on else None)

    def _labels_for(self, generator, n: int) -> torch.Tensor | None:
        """Every sample ``class_id``, or random labels (None when
        unconditional)."""
        if self.class_id is not None:
            return torch.full((n,), self.class_id, dtype=torch.int64,
                              device=self.bundle.device)
        return self.bundle.sample_labels(generator, n)

    def _score(self, g, d, z, labels, generator):
        """One candidate batch from its z and labels, and its final logits
        (refined when on; ``generator`` serves the refinement's noise)."""
        if self._refine_on:
            return self._refine_z(g, d, z, labels, generator)
        with torch.no_grad():
            x = run_sharded(self.group, lambda z_, lab: self.bundle.generate(
                g, z_, lab, train=False), z, labels)
            return x, self.bundle.discriminate(d, x, labels, train=False)

    def _draw_score(self, g, d, generator, n: int):
        """One candidate batch drawn from ``generator`` (labels, then z),
        its labels and its final logits."""
        with span("cgs.refine.draw"):
            labels = self._labels_for(generator, n)
            z = self.bundle.sample_z(generator, n)
        x, logits = self._score(g, d, z, labels, generator)
        return x, labels, logits

    def _accept(self, logits, labels, m, generator, seed=None):
        """The batch's accept mask: DRS with u from ``generator`` or from
        the Philox key ``seed``, or all accepted."""
        if not self._reject_on:
            return torch.ones(logits.shape, dtype=torch.bool,
                              device=logits.device)
        cfg = self.cfg
        with span("cgs.serve.accept"):
            eff, eff_m = (fold_per_class(logits, m, labels)
                          if self._per_class else (logits, m))
            return drs_accept_mask(generator, eff, eff_m, cfg.gamma,
                                   cfg.eps_drs, cfg.gamma_percentile,
                                   use_pallas=cfg.use_pallas, seed=seed)

    def calibrate(self, g, d, generator: torch.Generator | None
                  ) -> torch.Tensor:
        """Burn-in DRS calibration M: a 0-d tensor, or with per-class DRS
        one per class (a 0-d 0.0 for accept-all methods)."""
        if not self._reject_on:
            return torch.zeros((), device=self.bundle.device)

        def burn(gen, n):
            x, labels, _ = self._draw_score(g, d, gen, n)
            return x, labels

        estimate = (estimate_logit_max_per_class if self._per_class
                    else estimate_logit_max)
        with span("cgs.serve.calibrate"):
            return estimate(self.bundle, d, burn, generator,
                            self.cfg.burn_in, self.cfg.batch_size)

    def round(self, g, d, m: torch.Tensor,
              generator: torch.Generator | None):
        """One serving round: (samples, labels or None, accept, logits)
        with ``num_batches * batch_size`` candidates, all on the device."""
        parts = []
        with span("cgs.serve.round"):
            for _ in range(self.cfg.num_batches):
                x, labels, logits = self._draw_score(g, d, generator,
                                                     self.cfg.batch_size)
                parts.append((x, labels,
                              self._accept(logits, labels, m, generator),
                              logits))
            return self._concat(parts)

    def _round_from(self, g, d, m: torch.Tensor, z: torch.Tensor,
                    labels: torch.Tensor | None, accept_seeds: torch.Tensor,
                    noise=None):
        """The round as a pure function of its draws: z (num_batches, B,
        z_dim), labels (num_batches, B) or None, ``accept_seeds``
        (num_batches,) int64, batch i's Philox key of the accept step (off
        the kernel, u is the same bits), and where ``refine.noise`` > 0 one
        noise source per batch in ``noise`` (None: the global generator)."""
        parts = []
        for i in range(z.shape[0]):
            lab = None if labels is None else labels[i]
            x, logits = self._score(g, d, z[i], lab,
                                    None if noise is None else noise[i])
            parts.append((x, lab, self._accept(
                logits, lab, m, None, accept_seeds[i].reshape(1)), logits))
        return self._concat(parts)

    def seeded_draws(self, seed: torch.Tensor):
        """``_round_from``'s draws under one int64 seed tensor, by Philox on
        tensor ops: four keys from the seed (z, labels, accept, noise),
        z by Box-Muller, labels as bits modulo the class count (or
        ``class_id``), one accept key per batch, and per batch a
        ``PhiloxNormals`` where the refinement draws noise."""
        cfg, b = self.cfg, self.bundle
        nb, n = cfg.num_batches, cfg.batch_size
        seed = seed.to(b.device, torch.int64).reshape(1)
        k_z, k_labels, k_accept, k_noise = philox_keys(seed, 4)
        z = philox_normal(k_z, nb * n * b.z_dim).reshape(nb, n, b.z_dim)
        labels = None
        if self.class_id is not None:
            labels = torch.full((nb, n), self.class_id, dtype=torch.int64,
                                device=b.device)
        elif b.conditional:
            labels = philox_randint(k_labels, nb * n,
                                    b.num_classes).reshape(nb, n)
        noise = ([PhiloxNormals(k_noise, i) for i in range(nb)]
                 if self._refine_on and cfg.noise > 0 else None)
        return z, labels, philox_keys(k_accept, nb), noise

    def round_seeded(self, g, d, m: torch.Tensor, seed: torch.Tensor):
        """One serving round whose draws come from the int64 seed tensor
        ``seed`` (``seeded_draws``): the exported artifact's program. No
        global-RNG op is on its path."""
        return self._round_from(g, d, m, *self.seeded_draws(seed))

    def _concat(self, parts):
        xs, labels, accs, logits = zip(*parts)
        labels = torch.cat(labels) if self.bundle.conditional else None
        return torch.cat(xs), labels, torch.cat(accs), torch.cat(logits)

    @staticmethod
    def compact(x: torch.Tensor, labels: torch.Tensor | None,
                acc: torch.Tensor, cap: int, quantize: bool
                ) -> tuple[torch.Tensor, torch.Tensor | None, int]:
        """The first ``cap`` accepted rows and their labels, gathered on the
        device (uint8 by ``denormalize_images`` when ``quantize``) and then
        fetched to the host, so the transfer is O(accepted), not
        O(candidates). Returns (rows, labels or None, count). Spans
        ``cgs.serve.compact`` (the gather) and ``cgs.serve.fetch`` (the
        copies); each of ``nonzero`` and the copies reads the device."""
        with span("cgs.serve.compact"):
            idx = torch.nonzero(acc)[:cap, 0]
            count("host_syncs")
            x_sel = x[idx]
            if quantize:
                x_sel = denormalize_images(x_sel)
            lab = labels[idx] if labels is not None else None
        with span("cgs.serve.fetch"):
            if lab is not None:
                lab = lab.cpu()
                count("host_syncs")
            rows = x_sel.cpu()
            count("host_syncs")
        return rows, lab, int(idx.shape[0])

    def generate(self, g, d, generator: torch.Generator | None, n: int,
                 max_rounds: int = 1000, quantize_images: bool = True):
        """Run rounds until >= n samples are accepted.

        Returns (samples[n] on the host, their labels or None, stats).
        Image samples come
        back uint8 in [0, 255] by default (quantized on the device, before
        the fetch); 2D samples stay float32. The first round, which also
        builds the kernels and sizes the compaction buffer, keeps its
        samples but is left out of the reported rate. The request is span
        ``cgs.serve.generate``; its reads of the device (the first round's
        rate, each round's accepted count, ``compact``'s) count as
        ``host_syncs``."""
        with span("cgs.serve.generate"):
            quantize = quantize_images and len(self.bundle.data_shape) == 3
            m = self.calibrate(g, d, generator)
            per_round = self.cfg.num_batches * self.cfg.batch_size
            x0, lab0, acc0, _ = self.round(g, d, m, generator)
            rate0 = float(acc0.float().mean())
            count("host_syncs")
            # 30% headroom; a round that overflows contributes `cap`
            # samples (the first k of an iid accepted set are still
            # unbiased).
            cap = min(per_round,
                      max(64, int(per_round * (1.3 * rate0 + 0.05))))

            xs, labs, total, rounds, overflow = [], [], 0, 0, 0

            def take(x, labels, acc):
                nonlocal total, rounds, overflow
                x_sel, lab_sel, k = self.compact(x, labels, acc, cap,
                                                 quantize)
                overflow += int(acc.sum()) - k
                count("host_syncs")
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
                        f"generate: {total}/{n} accepted after {rounds} "
                        "rounds (accept rate too low - relax "
                        "gamma/gamma_percentile)")
                x, labels, acc, _ = self.round(g, d, m, generator)
                timed += take(x, labels, acc)
            dt = time.perf_counter() - t0

            samples = torch.cat(xs)[:n]
            labels = (torch.cat(labs)[:n] if self.bundle.conditional
                      else None)
            stats = {
                "n": int(n),
                "rounds": rounds,
                "candidates": rounds * per_round,
                "accept_rate": (total + overflow) / (rounds * per_round),
                "overflow_dropped": overflow,
                "seconds": dt,
                # Accepted samples per second over the rounds after the
                # first; None when the first round alone satisfied n.
                "samples_per_sec": timed / dt if timed else None,
                "warmup_samples": warm,
                "dtype": "uint8" if quantize else "float32",
                "method": self.method,
            }
            return samples, labels, stats
