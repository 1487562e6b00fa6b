"""Sampling strategies: standard, refinement, DRS reject, MH-GAN and collab.

Counterpart of ``collaborative_gan_sampling_tpu/sampling/collab.py``. The
JAX package compiles each strategy into one scanned program; here each is a
Python loop over batch rounds that stays on the device (the burn-in M, the
accept masks, the MH chains and the shaped D never leave it).

mhgan: Platt calibration of D on one real and one G batch (identity without
``data_fn``), then per round B chains of ``mh_chain_len`` G proposals, seeded
with real data when ``data_fn`` is given (else with G samples). A chain that
never accepted still holds its real initializer and is marked rejected, so
no training image leaks into the output.

collab, per round i (the spans of ``utils/profiling.py``, recorded under a
profiler, in brackets: the call is ``cgs.collab.call``, the burn-in M
``cgs.collab.burn_in``):
  1. x, logits = K-step refined G(z) under the current (shaped) D
     (``cgs.refine.draw``, ``.prepare`` and ``.steps``);
  2. with shaping on, M <- 0.7 M + 0.3 max(logits), and the accept test uses
     max(M, max(logits)); with shaping off the burn-in M stays;
  3. DRS accept mask (2 and 3: ``cgs.collab.accept``);
  4. if i % shape_every == 0: ``shaping_steps`` D updates on (real, x)
     (``cgs.collab.shape``; each step's real batch ``cgs.collab.real_batch``
     within it).

Conditional models draw a label per sample beside z, and every result keeps
them (``SampleResult.labels``). With ``per_class_drs`` the burn-in M is one
per class (``estimate_logit_max_per_class``) and folds into the logits
(``fold_per_class``); in collab each class's M takes step 2 over the
round's samples of that class and stays where the round has none. With
``class_balanced_shaping`` and a ``cond_data_fn(generator, labels)``, the
shaping real batch holds the refined batch's labels.

Data parallelism (``group``, ``parallel/mesh.py``; JAX ``collab.py:108-111``,
``:302-433`` under a mesh). z is drawn whole and sliced; G and the
refinement (the kernels among it) run on the rank's slice, and the samples
and logits are gathered whole on every rank. M, its recalibration and the
DRS mask (the kernel's in-kernel percentile among it) are then taken over
the whole batch on every rank, from the same generator state, so every
rank holds the same mask. Shaping's real batch is drawn whole and sliced,
and its gradients are summed over the ranks (``ShapingStep``). Results are
whole on every rank, so evaluation runs unsharded, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from collaborative_gan_sampling_torch.config import RefineConfig
from collaborative_gan_sampling_torch.models import GANBundle
from collaborative_gan_sampling_torch.parallel.mesh import (
    run_sharded,
    shard_batch,
)
from collaborative_gan_sampling_torch.sampling.mh import (
    fit_platt,
    make_mh_sampler,
)
from collaborative_gan_sampling_torch.sampling.refine import (
    make_draw_refine_fn,
)
from collaborative_gan_sampling_torch.sampling.rejection import (
    class_max,
    drs_accept_mask,
    estimate_logit_max,
    estimate_logit_max_per_class,
    fold_per_class,
)
from collaborative_gan_sampling_torch.training.shaping import ShapingStep
from collaborative_gan_sampling_torch.utils.profiling import span

METHODS = ("standard", "reject", "mhgan", "refinement", "collab")


class SampleResult(NamedTuple):
    """samples (N, H, W, C), accepted (N,) bool, logits (N,), labels (N,)
    int64 (None for unconditional models), aux (strategy-specific)."""

    samples: torch.Tensor
    accepted: torch.Tensor
    logits: torch.Tensor
    labels: torch.Tensor | None
    aux: dict[str, Any]

    def accepted_samples(self) -> torch.Tensor:
        return self.samples[self.accepted]

    @property
    def accept_rate(self) -> float:
        return float(self.accepted.float().mean())


def sample(bundle: GANBundle, g, d, cfg: RefineConfig,
           generator: torch.Generator | None, method: str | None = None,
           data_fn: Callable | None = None,
           cond_data_fn: Callable | None = None, group=None) -> SampleResult:
    """Run a sampling strategy end to end on the bundle's device.
    ``data_fn(generator, n) -> (x, labels)`` supplies real batches (needed
    by collab shaping; used by mhgan for calibration and chain init);
    ``cond_data_fn(generator, labels) -> (x, labels)`` real batches of the
    given classes (collab's class-balanced shaping). The given ``d`` is
    left as it is; collab returns the shaped copy in ``aux['shaped_d']``.
    ``group``: data-parallel over that process group (the same ``g`` and
    ``d`` and generator state on every rank; the result whole on each)."""
    method = method or cfg.method
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; have {METHODS}")
    if method == "collab":
        with span("cgs.collab.call"):
            return _sample_collab(bundle, g, d, cfg, generator, data_fn,
                                  cond_data_fn, group)
    if method == "mhgan":
        return _sample_mhgan(bundle, g, d, cfg, generator, data_fn, group)
    fn = {"standard": _sample_standard, "reject": _sample_reject,
          "refinement": _sample_refinement}[method]
    return fn(bundle, g, d, cfg, generator, group)


def _per_class_drs(bundle, cfg) -> bool:
    return cfg.per_class_drs and bundle.conditional


def _draw(bundle, g, generator, n, group=None):
    """z -> G(z), with a label per sample for a conditional pair; over a
    ``group`` G runs on the rank's slice and x comes back whole."""
    z = bundle.sample_z(generator, n)
    labels = bundle.sample_labels(generator, n)
    with torch.no_grad():
        x = run_sharded(group, lambda z_, lab: bundle.generate(
            g, z_, lab, train=False), z, labels)
    return x, labels


def _result(xs, logits, labels, accepted=None, aux=None) -> SampleResult:
    samples, logits = torch.cat(xs), torch.cat(logits)
    if accepted is None:
        accepted = torch.ones(samples.shape[0], dtype=torch.bool,
                              device=samples.device)
    else:
        accepted = torch.cat(accepted)
    labels = torch.cat(labels) if labels[0] is not None else None
    return SampleResult(samples, accepted, logits, labels, aux or {})


def _sample_standard(bundle, g, d, cfg, generator, group=None):
    xs, logits, labels = [], [], []
    for _ in range(cfg.num_batches):
        x, lab = _draw(bundle, g, generator, cfg.batch_size, group)
        with torch.no_grad():
            logits.append(bundle.discriminate(d, x, lab, train=False))
        xs.append(x)
        labels.append(lab)
    return _result(xs, logits, labels)


def _sample_refinement(bundle, g, d, cfg, generator, group=None):
    draw_refine = make_draw_refine_fn(bundle, cfg, group)
    xs, logits, labels = [], [], []
    for _ in range(cfg.num_batches):
        x, lab, lg = draw_refine(g, d, generator, cfg.batch_size)
        xs.append(x)
        logits.append(lg)
        labels.append(lab)
    return _result(xs, logits, labels)


def _sample_reject(bundle, g, d, cfg, generator, group=None,
                   refine_first=False):
    draw_refine = (make_draw_refine_fn(bundle, cfg, group) if refine_first
                   else None)
    per_class = _per_class_drs(bundle, cfg)

    def burn_sample(gen, n):
        if draw_refine is not None:
            x, labels, _ = draw_refine(g, d, gen, n)
            return x, labels
        return _draw(bundle, g, gen, n, group)

    if per_class:
        m = estimate_logit_max_per_class(bundle, d, burn_sample, generator,
                                         cfg.burn_in, cfg.batch_size)
    else:
        m = estimate_logit_max(bundle, d, burn_sample, generator,
                               cfg.burn_in, cfg.batch_size)
    xs, logits, labels, accepted = [], [], [], []
    for _ in range(cfg.num_batches):
        if draw_refine is not None:
            x, lab, lg = draw_refine(g, d, generator, cfg.batch_size)
        else:
            x, lab = _draw(bundle, g, generator, cfg.batch_size, group)
            with torch.no_grad():
                lg = bundle.discriminate(d, x, lab, train=False)
        eff, eff_m = fold_per_class(lg, m, lab) if per_class else (lg, m)
        accepted.append(drs_accept_mask(generator, eff, eff_m, cfg.gamma,
                                        cfg.eps_drs, cfg.gamma_percentile,
                                        use_pallas=cfg.use_pallas))
        xs.append(x)
        logits.append(lg)
        labels.append(lab)
    return _result(xs, logits, labels, accepted, {"logit_max": m})


@torch.no_grad()
def _sample_mhgan(bundle, g, d, cfg, generator, data_fn, group=None):
    mh = make_mh_sampler(bundle, cfg.mh_chain_len)
    if data_fn is not None:
        x_real, labels_r = data_fn(generator, cfg.batch_size)
        lg_real = bundle.discriminate(d, x_real, labels_r, train=False)
        x_fake, labels_f = _draw(bundle, g, generator, cfg.batch_size,
                                 group)
        lg_fake = bundle.discriminate(d, x_fake, labels_f, train=False)
        a, b = fit_platt(lg_real, lg_fake)
    else:
        a = torch.ones((), device=bundle.device)
        b = torch.zeros((), device=bundle.device)
    xs, logits, labels, n_accs = [], [], [], []
    for _ in range(cfg.num_batches):
        if data_fn is not None:
            x0, lab = data_fn(generator, cfg.batch_size)
        else:
            x0, lab = _draw(bundle, g, generator, cfg.batch_size, group)
        x, aux = mh(d, g, generator, x0, lab, a, b)
        xs.append(x)
        logits.append(bundle.discriminate(d, x, lab, train=False))
        labels.append(lab)
        n_accs.append(aux["n_accepts"])
    # Real-data chain init: a chain that never accepted a G proposal still
    # holds its real initializer; mark it rejected. G-initialized chains
    # hold generator samples from the start, so all are accepted.
    accepted = [n > 0 for n in n_accs] if data_fn is not None else None
    n_acc = torch.cat(n_accs)
    return _result(xs, logits, labels, accepted, {
        "mh_accept_rate": n_acc.mean() / cfg.mh_chain_len,
        "mh_never_accepted": (n_acc == 0).float().mean(),
        "platt_a": a, "platt_b": b})


def _sample_collab(bundle, g, d, cfg, generator, data_fn, cond_data_fn,
                   group=None):
    if data_fn is None:
        raise ValueError("collab sampling needs data_fn for D shaping")
    balanced = (cond_data_fn is not None and bundle.conditional
                and cfg.class_balanced_shaping)
    per_class = _per_class_drs(bundle, cfg)
    draw_refine = make_draw_refine_fn(bundle, cfg, group)
    shape_step = ShapingStep(
        bundle, cfg.shaping_lr, decay=cfg.shaping_decay,
        target=cfg.shaping_target, freeze_embed=cfg.shaping_freeze_embed,
        anchor=cfg.shaping_anchor,
        class_weight=cfg.shaping_class_weight and bundle.conditional,
        r1_gamma=cfg.shaping_r1_gamma, group=group)
    anchor_params = ([p.detach().clone() for p in d.parameters()]
                     if cfg.shaping_anchor > 0 else None)
    state = shape_step.init(d)
    shaping_on = cfg.shape_every > 0

    def burn_sample(gen, n):
        x, labels, _ = draw_refine(g, state.d, gen, n)
        return x, labels

    with span("cgs.collab.burn_in"):
        if per_class:
            m = estimate_logit_max_per_class(bundle, state.d, burn_sample,
                                             generator, cfg.burn_in,
                                             cfg.batch_size)
        else:
            m = estimate_logit_max(bundle, state.d, burn_sample, generator,
                                   cfg.burn_in, cfg.batch_size)
    xs, logits, labels, accepted, shape_losses = [], [], [], [], []
    zero = torch.zeros((), device=bundle.device)
    for i in range(cfg.num_batches):
        x, lab, lg = draw_refine(g, state.d, generator, cfg.batch_size)
        with span("cgs.collab.accept"):
            # D's logit scale drifts while it is shaped: recalibrate M.
            m_eff = m
            if shaping_on and per_class:  # absent classes keep their M
                rm = class_max(lg, lab, bundle.num_classes)
                seen = torch.isfinite(rm)
                m = torch.where(seen, 0.7 * m + 0.3 * rm, m)
                m_eff = torch.where(seen, torch.maximum(m, rm), m)
            elif shaping_on:
                m = 0.7 * m + 0.3 * lg.max()
                m_eff = torch.maximum(m, lg.max())
            eff, eff_m = (fold_per_class(lg, m_eff, lab) if per_class
                          else (lg, m_eff))
            accepted.append(drs_accept_mask(
                generator, eff, eff_m, cfg.gamma, cfg.eps_drs,
                cfg.gamma_percentile, use_pallas=cfg.use_pallas))
        loss = zero
        if shaping_on and i % cfg.shape_every == 0:
            with span("cgs.collab.shape"):
                for _ in range(cfg.shaping_steps):
                    with span("cgs.collab.real_batch"):
                        if balanced:
                            x_real, labels_r = cond_data_fn(generator, lab)
                        else:
                            x_real, labels_r = data_fn(generator,
                                                       cfg.batch_size)
                    state, loss = shape_step(
                        state, *(shard_batch(group, t)
                                 for t in (x_real, x, labels_r, lab)),
                        anchor_params)
        shape_losses.append(loss)
        xs.append(x)
        logits.append(lg)
        labels.append(lab)
    return _result(xs, logits, labels, accepted, {
        "logit_max": m, "shape_losses": torch.stack(shape_losses),
        "shaped_d": state.d.eval(), "shaping_steps_done": state.step})


def sample_refine_reject(bundle, g, d, cfg, generator,
                         group=None) -> SampleResult:
    """Refinement followed by DRS rejection, no shaping."""
    return _sample_reject(bundle, g, d, cfg, generator, group,
                          refine_first=True)
