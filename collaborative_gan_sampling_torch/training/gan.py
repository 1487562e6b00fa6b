"""GAN training in PyTorch: non-saturating losses, Adam, train chunks.

Counterpart of ``collaborative_gan_sampling_tpu/training/gan.py``. One
iteration is ``d_steps`` D updates then ``g_steps`` G updates (or, with
``fused_prop``, one FusedProp update of both), then the step count and the
EMA generator; ``make_train_chunk`` runs ``steps_per_call`` of them and
returns the mean of each metric over them. The JAX package compiles a chunk
into one scanned program; here it is a Python loop that stays on the
device (no host synchronization inside a chunk).

BatchNorm statistics. A train-mode forward of the port's ``FlaxBatchNorm``
updates its running averages in place, so running the real pass and then
the fake pass leaves the statistics that the JAX package's ``_merge_stats``
leaves (real first, fake on top). Where the JAX chunk discards an update,
the port restores the buffers it had before the forward:

* the D update runs G in train mode and keeps none of G's updates;
* the G update runs D in train mode and keeps none of D's updates.

Randomness. Every draw goes through ``TrainDraws``, keyed as in the JAX
chunk: the D update of index ``step * d_steps + i`` (and the FusedProp
update of index ``step``) takes a real batch (with its labels), z and, for
a conditional pair, fake labels from its "data" stream; the G update of
index ``step * g_steps + i`` takes z and fake labels from its "z" stream.
Parity tests replace it with arrays that JAX drew from its own keys.

Data parallelism (``group``, ``parallel/mesh.py``; JAX ``gan.py:139-152``
shards the same chunk over a mesh). Every rank draws the whole global batch
from the same stream and keeps its slice, so the streams advance as in one
process; BatchNorm takes its moments over the whole batch
(``ops/nn.py::batch_stats_group``); each rank's loss is scaled by 1 / world
size, so that the sum over ranks is the global mean, and the gradients are
summed over the ranks before each Adam step; every rank steps the same
Adam and the same EMA generator. The chunk's metrics are the means over
the ranks. With ``group=None`` none of this runs.
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from collaborative_gan_sampling_torch.config import TrainConfig
from collaborative_gan_sampling_torch.ops.nn import batch_stats_group
from collaborative_gan_sampling_torch.parallel.mesh import (
    all_reduce_mean,
    shard_batch,
    sum_gradients,
    world_size,
)
from collaborative_gan_sampling_torch.utils.prng import (
    step_generator,
    step_seed,
)

# data_fn(generator, n) -> (x_real, labels or None)
DataFn = Callable[[torch.Generator, int],
                  tuple[torch.Tensor, torch.Tensor | None]]


def nonsaturating_d_loss(logits_real: torch.Tensor,
                         logits_fake: torch.Tensor) -> torch.Tensor:
    return (F.softplus(-logits_real).mean()
            + F.softplus(logits_fake).mean())


def nonsaturating_g_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    return F.softplus(-logits_fake).mean()


def real_pass(bundle, d, x_real: torch.Tensor,
              labels_r: torch.Tensor | None, r1_gamma: float):
    """Train-mode D forward on the real batch (updating BN statistics once);
    with ``r1_gamma`` > 0 also E[||grad_x D(x_real)||^2] of that same
    forward, kept differentiable for the parameter gradient (R1,
    arXiv:1801.04406). Returns ``(logits_real, r1 or None)``; the caller
    scales r1 by gamma / 2."""
    if r1_gamma <= 0.0:
        return bundle.discriminate(d, x_real, labels_r, train=True), None
    x = x_real.detach().requires_grad_(True)
    lr = bundle.discriminate(d, x, labels_r, train=True)
    (gx,) = torch.autograd.grad(lr.sum(), x, create_graph=True)
    r1 = gx.float().square().sum(dim=tuple(range(1, gx.ndim))).mean()
    return lr, r1


@dataclass
class TrainState:
    """Everything that evolves during training; ``utils/checkpoint.py``
    writes it in the JAX package's layout."""

    g: nn.Module
    d: nn.Module
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int = 0
    g_ema: nn.Module | None = None  # EMA of G's params (g_ema_decay > 0)


def sampling_g(state: TrainState) -> nn.Module:
    """G for sampling and serving: the EMA generator when it is tracked
    (its params, with the live G's BatchNorm running averages copied in),
    else the live G."""
    if state.g_ema is None:
        return state.g
    with torch.no_grad():
        for b_ema, b in zip(state.g_ema.buffers(), state.g.buffers()):
            b_ema.copy_(b)
    return state.g_ema


def make_optimizers(cfg: TrainConfig, g: nn.Module, d: nn.Module
                    ) -> tuple[torch.optim.Adam, torch.optim.Adam]:
    """Adam(lr, b1 = beta1, b2 = beta2, eps 1e-8) for G and D, as the JAX
    package's optax.adam; torch's default implementation."""
    def adam(params, lr):
        return torch.optim.Adam(params, lr=lr, betas=(cfg.beta1, cfg.beta2),
                                eps=1e-8)

    return adam(g.parameters(), cfg.g_lr), adam(d.parameters(), cfg.d_lr)


def train_state_from(g: nn.Module, d: nn.Module,
                     cfg: TrainConfig) -> TrainState:
    """A step-0 state around the given modules: fresh optimizers, and a
    copy of G as the EMA generator when ``cfg.g_ema_decay`` > 0."""
    g_opt, d_opt = make_optimizers(cfg, g, d)
    ema = copy.deepcopy(g) if cfg.g_ema_decay > 0 else None
    return TrainState(g=g, d=d, g_opt=g_opt, d_opt=d_opt, step=0, g_ema=ema)


def create_train_state(bundle, cfg: TrainConfig, seed: int) -> TrainState:
    """Fresh (G, D) on the bundle's device from the run's seed."""
    g, d = bundle.init(step_generator(seed, 0, "init_g", bundle.device))
    return train_state_from(g, d, cfg)


class TrainDraws:
    """The train chunk's random draws, each from the stream of (seed, update
    index, role) on the bundle's device: ``d_batch(index)`` gives (real
    batch, its labels, z, fake labels) for a D or FusedProp update,
    ``g_batch(index)`` (z, fake labels) for a G update; labels are None
    for an unconditional pair. With a ``group``, each is drawn whole and
    the rank's slice is returned."""

    def __init__(self, bundle, data_fn: DataFn, seed: int, batch_size: int,
                 group=None):
        self.bundle, self.data_fn = bundle, data_fn
        self.seed, self.batch_size, self.group = seed, batch_size, group
        # One generator, reseeded per draw: the stream a fresh generator
        # of that seed would give.
        self._generator = torch.Generator(device=bundle.device)

    def _gen(self, index: int, role: str) -> torch.Generator:
        self._generator.manual_seed(step_seed(self.seed, index, role))
        return self._generator

    def d_batch(self, index: int):
        gen = self._gen(index, "data")
        x_real, labels_r = self.data_fn(gen, self.batch_size)
        z = self.bundle.sample_z(gen, self.batch_size)
        draws = (x_real, labels_r, z,
                 self.bundle.sample_labels(gen, self.batch_size))
        return tuple(shard_batch(self.group, t) for t in draws)

    def g_batch(self, index: int):
        gen = self._gen(index, "z")
        z = self.bundle.sample_z(gen, self.batch_size)
        draws = (z, self.bundle.sample_labels(gen, self.batch_size))
        return tuple(shard_batch(self.group, t) for t in draws)


@contextlib.contextmanager
def _stats_kept(module: nn.Module):
    """Restore ``module``'s buffers (BN running averages) on exit: the
    train-mode forwards inside leave no statistics behind."""
    saved = [b.clone() for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(module.buffers(), saved):
                b.copy_(s)


def _apply(opt: torch.optim.Adam, params: list[torch.Tensor],
           grads, group=None) -> None:
    for p, g in zip(params, sum_gradients(group, grads)):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


def make_train_chunk(bundle, cfg: TrainConfig, data_fn: DataFn | None = None,
                     seed: int = 0, steps_per_call: int | None = None,
                     draws: TrainDraws | None = None, group=None):
    """``chunk(state) -> (state, metrics)``: ``steps_per_call`` train
    iterations on ``state`` (updated in place and returned) and the mean of
    each metric over them, as 0-d tensors on the device. ``draws`` replaces
    the seeded draws from ``data_fn`` (the parity tests' seam; with a
    ``group`` they must be the rank's slices). ``group``: data-parallel
    over that process group, every rank holding the same ``state``."""
    n_steps = steps_per_call or cfg.steps_per_call
    draws = draws or TrainDraws(bundle, data_fn, seed, cfg.batch_size,
                                group)
    # Each rank's share of the global mean (1.0 in one process).
    share = 1.0 / world_size(group)

    def scaled(loss: torch.Tensor) -> torch.Tensor:
        return loss if group is None else loss * share

    def d_update(state: TrainState, x_real, labels_r, z, labels_f) -> dict:
        params = list(state.d.parameters())
        # G in train mode (batch statistics); its statistics advance only
        # in the G update.
        with torch.no_grad(), _stats_kept(state.g):
            x_fake = bundle.generate(state.g, z, labels_f, train=True)
        lr_real, r1 = real_pass(bundle, state.d, x_real, labels_r,
                                cfg.r1_gamma)
        lr_fake = bundle.discriminate(state.d, x_fake, labels_f, train=True)
        loss = nonsaturating_d_loss(lr_real, lr_fake)
        if r1 is not None:
            loss = loss + 0.5 * cfg.r1_gamma * r1
        _apply(state.d_opt, params,
               torch.autograd.grad(scaled(loss), params), group)
        metrics = {"d_loss": loss.detach(), "d_real": lr_real.detach().mean(),
                   "d_fake": lr_fake.detach().mean()}
        if r1 is not None:
            metrics["r1"] = r1.detach()
        return metrics

    def g_update(state: TrainState, z, labels) -> dict:
        params = list(state.g.parameters())
        # D in train mode (batch statistics), its statistics discarded.
        with _stats_kept(state.d):
            x_fake = bundle.generate(state.g, z, labels, train=True)
            logits = bundle.discriminate(state.d, x_fake, labels, train=True)
        loss = nonsaturating_g_loss(logits)
        _apply(state.g_opt, params,
               torch.autograd.grad(scaled(loss), params), group)
        return {"g_loss": loss.detach()}

    def fused_update(state: TrainState, x_real, labels_r, z,
                     labels_f) -> dict:
        """FusedProp (arXiv:2004.03335): one G forward and one D forward on
        the fake batch serve both updates, through the cotangents of the D
        loss, sigmoid(l) / B, and of the G loss, -sigmoid(-l) / B; D and G
        step at once, from the same z."""
        g_params = list(state.g.parameters())
        d_params = list(state.d.parameters())
        x_fake = bundle.generate(state.g, z, labels_f, train=True)
        lr, r1 = real_pass(bundle, state.d, x_real, labels_r, cfg.r1_gamma)
        loss_real = F.softplus(-lr).mean()
        if r1 is not None:
            loss_real = loss_real + 0.5 * cfg.r1_gamma * r1
        d_grads_real = torch.autograd.grad(scaled(loss_real), d_params)
        # The fake pass's statistics go on top of the real pass's.
        lf = bundle.discriminate(state.d, x_fake, labels_f, train=True)
        lf_ = lf.detach()
        inv_b = 1.0 / (lf.shape[0] * world_size(group))  # the global B
        # The D cotangent goes to D's params only, never into G.
        d_grads_fake = torch.autograd.grad(
            lf, d_params, grad_outputs=torch.sigmoid(lf_) * inv_b,
            retain_graph=True)
        g_grads = torch.autograd.grad(
            lf, g_params, grad_outputs=-torch.sigmoid(-lf_) * inv_b)
        _apply(state.d_opt, d_params,
               [a + b for a, b in zip(d_grads_real, d_grads_fake)], group)
        _apply(state.g_opt, g_params, g_grads, group)
        metrics = {"d_loss": loss_real.detach() + F.softplus(lf_).mean(),
                   "g_loss": F.softplus(-lf_).mean(),
                   "d_real": lr.detach().mean(), "d_fake": lf_.mean()}
        if r1 is not None:
            metrics["r1"] = r1.detach()
        return metrics

    def update_ema(state: TrainState) -> None:
        # TF1 ExponentialMovingAverage's num_updates warm-up,
        # min(d, (1 + t) / (10 + t)), in float32 with t the new step.
        t = np.float32(state.step)
        d = np.minimum(np.float32(cfg.g_ema_decay),
                       (np.float32(1) + t) / (np.float32(10) + t))
        ema, live = list(state.g_ema.parameters()), list(state.g.parameters())
        with torch.no_grad():
            torch._foreach_mul_(ema, float(d))
            torch._foreach_add_(ema, live, alpha=float(np.float32(1) - d))

    def train_step(state: TrainState) -> dict:
        if cfg.fused_prop:
            metrics = fused_update(state, *draws.d_batch(state.step))
        else:
            metrics = {}
            for i in range(cfg.d_steps):
                metrics.update(d_update(
                    state, *draws.d_batch(state.step * cfg.d_steps + i)))
            # With g_steps > 1 the last G update's g_loss is kept.
            for i in range(cfg.g_steps):
                metrics.update(g_update(
                    state, *draws.g_batch(state.step * cfg.g_steps + i)))
        state.step += 1
        if state.g_ema is not None:
            update_ema(state)
        return metrics

    def chunk(state: TrainState):
        with batch_stats_group(group):
            ms = [train_step(state) for _ in range(n_steps)]
        means = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        if group is not None:  # the ranks' means, in one all-reduce
            vals = all_reduce_mean(group, torch.stack(
                [v.float() for v in means.values()]))
            means = {k: v.to(means[k].dtype) for k, v in zip(means, vals)}
        return state, means

    return chunk
