"""Discriminator shaping: the 'collaborative' half of collab sampling.

Counterpart of ``collaborative_gan_sampling_tpu/training/shaping.py``. D is
fine-tuned on (real, refined) batches with the non-saturating D loss and its
own Adam (b1 = 0.5, eps 1e-8) at ``shaping_lr``; G stays frozen.

With a ``group`` (``parallel/mesh.py``) each rank takes its slice of the
(real, refined) pair: BatchNorm moments, the separation test and the class
weights are taken over the whole batch, each rank's loss is scaled by
1 / world size and the gradients are summed over the ranks before Adam
steps, so every rank holds the same shaped D.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from collaborative_gan_sampling_torch.ops.nn import batch_stats_group
from collaborative_gan_sampling_torch.parallel.mesh import (
    all_gather,
    all_reduce_mean,
    shard_batch,
    sum_gradients,
    world_size,
)
from collaborative_gan_sampling_torch.training.gan import (
    nonsaturating_d_loss,
    real_pass,
)
from collaborative_gan_sampling_torch.utils.profiling import count


@dataclass
class ShapingState:
    d: nn.Module  # the shaped discriminator (a copy of the one given)
    opt: torch.optim.Adam
    step: int = 0  # updates applied


def class_weights(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-sample inverse-frequency weights with mean 1 over the classes
    present: a class with cnt of the B samples, among C_present classes,
    weighs B / (C_present * cnt); a balanced batch weighs all ones."""
    cnt = torch.bincount(labels, minlength=num_classes).float()
    present = (cnt > 0).sum().clamp_min(1)
    w = torch.where(cnt > 0, 1.0 / cnt.clamp_min(1.0), 0.0)[labels]
    return w * (labels.shape[0] / present)


class ShapingStep:
    """``step(state, x_real, x_refined) -> (state, d_loss)``: one D update on
    a (real, refined) pair; ``init(d)`` makes the matching state.

    * ``decay`` != 1: update n (counted before it) runs at lr * decay**n.
    * ``target`` > 0: the update is skipped, leaving params, Adam state and
      BN statistics as they were, unless D's mean real-vs-refined logit
      separation is above ``target`` (a read of the device: one of
      ``utils/profiling.py``'s ``host_syncs``).
    * ``anchor`` > 0: adds 0.5 * anchor * ||p - p_anchor||^2 (L2-SP) over
      all D params.
    * ``r1_gamma`` > 0: adds 0.5 * r1_gamma * E||grad_x D(x_real)||^2.
    * ``freeze_embed``: the gradients of every parameter whose name holds
      "embed" (the projection D's ``proj_embed``) are set to zero, after
      the anchor and R1 terms; Adam still steps them, as optax does.
    * ``class_weight``: with both label sets given, each term of the loss
      is the mean of ``class_weights`` times the per-sample loss, so each
      class present weighs the same.
    * ``group``: data-parallel; the step takes the rank's slices of the
      pair (and labels), and the returned loss is the global one.
    """

    def __init__(self, bundle, lr: float, decay: float = 1.0,
                 target: float = 0.0, anchor: float = 0.0,
                 r1_gamma: float = 0.0, freeze_embed: bool = False,
                 class_weight: bool = False, group=None):
        self.bundle, self.lr, self.decay = bundle, lr, decay
        self.target, self.anchor, self.r1_gamma = target, anchor, r1_gamma
        self.freeze_embed, self.class_weight = freeze_embed, class_weight
        self.group = group

    def init(self, d: nn.Module) -> ShapingState:
        d = copy.deepcopy(d)
        opt = torch.optim.Adam(d.parameters(), lr=self.lr, betas=(0.5, 0.999),
                               eps=1e-8)
        return ShapingState(d=d, opt=opt)

    def __call__(self, state: ShapingState, x_real: torch.Tensor,
                 x_refined: torch.Tensor, labels_r=None, labels_f=None,
                 anchor_params: list[torch.Tensor] | None = None):
        with batch_stats_group(self.group):
            return self._step(state, x_real, x_refined, labels_r, labels_f,
                              anchor_params)

    def _weights(self, labels: torch.Tensor) -> torch.Tensor:
        """``class_weights`` over the group's whole batch, the rank's
        slice of them."""
        full = all_gather(self.group, labels)
        return shard_batch(self.group,
                           class_weights(full, self.bundle.num_classes))

    def _step(self, state, x_real, x_refined, labels_r, labels_f,
              anchor_params):
        d, bundle, group = state.d, self.bundle, self.group
        stats = ([b.detach().clone() for b in d.buffers()]
                 if self.target > 0 else None)
        # Real pass first; the fake pass updates BN statistics on top of it.
        lr_real, r1 = real_pass(bundle, d, x_real, labels_r, self.r1_gamma)
        lr_fake = bundle.discriminate(d, x_refined.detach(), labels_f,
                                      train=True)
        if (self.class_weight and labels_r is not None
                and labels_f is not None):
            w_r, w_f = self._weights(labels_r), self._weights(labels_f)
            loss = ((w_r * F.softplus(-lr_real)).mean()
                    + (w_f * F.softplus(lr_fake)).mean())
        else:
            loss = nonsaturating_d_loss(lr_real, lr_fake)
        if self.anchor > 0 and anchor_params is not None:
            sq = sum(torch.sum(torch.square(p.float() - p0.float()))
                     for p, p0 in zip(d.parameters(), anchor_params))
            loss = loss + 0.5 * self.anchor * sq
        if r1 is not None:
            loss = loss + 0.5 * self.r1_gamma * r1
        reported = all_reduce_mean(group, loss.detach())
        if self.target > 0:
            sep = all_reduce_mean(group, (lr_real.mean()
                                          - lr_fake.mean()).detach())
            count("host_syncs")
            if not bool(sep > self.target):
                with torch.no_grad():
                    for b, saved in zip(d.buffers(), stats):
                        b.copy_(saved)
                return state, reported
        state.opt.zero_grad(set_to_none=True)
        if group is None:
            loss.backward()
        else:
            params = list(d.parameters())
            grads = torch.autograd.grad(loss / world_size(group), params,
                                        allow_unused=True)
            for p, g in zip(params, sum_gradients(group, grads)):
                p.grad = g
        if self.freeze_embed:
            for name, p in d.named_parameters():
                if "embed" in name.lower():
                    p.grad = torch.zeros_like(p)
        for group in state.opt.param_groups:
            group["lr"] = self.lr * self.decay ** state.step
        state.opt.step()
        state.step += 1
        return state, reported
