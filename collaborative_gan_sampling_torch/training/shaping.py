"""Discriminator shaping: the 'collaborative' half of collab sampling.

Counterpart of ``collaborative_gan_sampling_tpu/training/shaping.py``. D is
fine-tuned on (real, refined) batches with the non-saturating D loss and its
own Adam (b1 = 0.5, eps 1e-8) at ``shaping_lr``; G stays frozen. The JAX
options that act only on class-conditional models (``freeze_embed``,
``class_weight``) are not ported yet; on an unconditional model they change
nothing.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
from torch import nn

from collaborative_gan_sampling_torch.training.gan import (
    nonsaturating_d_loss,
    real_pass,
)


@dataclass
class ShapingState:
    d: nn.Module  # the shaped discriminator (a copy of the one given)
    opt: torch.optim.Adam
    step: int = 0  # updates applied


class ShapingStep:
    """``step(state, x_real, x_refined) -> (state, d_loss)``: one D update on
    a (real, refined) pair; ``init(d)`` makes the matching state.

    * ``decay`` != 1: update n (counted before it) runs at lr * decay**n.
    * ``target`` > 0: the update is skipped, leaving params, Adam state and
      BN statistics as they were, unless D's mean real-vs-refined logit
      separation is above ``target``.
    * ``anchor`` > 0: adds 0.5 * anchor * ||p - p_anchor||^2 (L2-SP) over
      all D params.
    * ``r1_gamma`` > 0: adds 0.5 * r1_gamma * E||grad_x D(x_real)||^2.
    """

    def __init__(self, bundle, lr: float, decay: float = 1.0,
                 target: float = 0.0, anchor: float = 0.0,
                 r1_gamma: float = 0.0):
        self.bundle, self.lr, self.decay = bundle, lr, decay
        self.target, self.anchor, self.r1_gamma = target, anchor, r1_gamma

    def init(self, d: nn.Module) -> ShapingState:
        d = copy.deepcopy(d)
        opt = torch.optim.Adam(d.parameters(), lr=self.lr, betas=(0.5, 0.999),
                               eps=1e-8)
        return ShapingState(d=d, opt=opt)

    def __call__(self, state: ShapingState, x_real: torch.Tensor,
                 x_refined: torch.Tensor, labels_r=None, labels_f=None,
                 anchor_params: list[torch.Tensor] | None = None):
        d, bundle = state.d, self.bundle
        stats = ([b.detach().clone() for b in d.buffers()]
                 if self.target > 0 else None)
        # Real pass first; the fake pass updates BN statistics on top of it.
        lr_real, r1 = real_pass(bundle, d, x_real, labels_r, self.r1_gamma)
        lr_fake = bundle.discriminate(d, x_refined.detach(), labels_f,
                                      train=True)
        loss = nonsaturating_d_loss(lr_real, lr_fake)
        if self.anchor > 0 and anchor_params is not None:
            sq = sum(torch.sum(torch.square(p.float() - p0.float()))
                     for p, p0 in zip(d.parameters(), anchor_params))
            loss = loss + 0.5 * self.anchor * sq
        if r1 is not None:
            loss = loss + 0.5 * self.r1_gamma * r1
        if self.target > 0:
            sep = lr_real.mean() - lr_fake.mean()
            if not bool(sep > self.target):
                with torch.no_grad():
                    for b, saved in zip(d.buffers(), stats):
                        b.copy_(saved)
                return state, loss.detach()
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        for group in state.opt.param_groups:
            group["lr"] = self.lr * self.decay ** state.step
        state.opt.step()
        state.step += 1
        return state, loss.detach()
