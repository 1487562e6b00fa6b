"""Plain replay of a class-conditional ``sample(..., method='collab')`` call
from the inputs the benchmark gave the program: the seed weights, the
labelled real images (uint8) and the seed of the call's
``torch.Generator``. Imports nothing of the program.

The draw protocol, part of the sampler's interface: per batch of
candidates one ``randn((n, z_dim))`` then one ``randint(0, classes,
(n,))`` (int64 labels) from the caller's generator; one DRS key
``randint(0, 2**62)`` after them (``sampler.accept_step``); the shaping
step's real batch after that, one ``randint(0, 2**30, (n,))`` draw r per
row, row i an image of the batch's label y_i (``ClassIndex``).

The arithmetic is ``sampler.collab_call``'s, with the labels beside x
wherever D or G runs: K descent steps of softplus(-D(x, y)) in x under D
in eval mode; M the largest logit of ``burn_in // B`` refined batches,
per batch ``M <- 0.7 M + 0.3 max F`` and the DRS test against ``max(M,
max F)`` (one global M); every ``shape_every`` batches one Adam step (b1
0.5, b2 0.999, eps 1e-8) on D with the non-saturating loss, train-mode D
on the class-balanced real batch and its labels, then on the refined
batch and its labels; every class and every sample weighs the same, and
the label tables step like the other parameters.

Departures from arXiv:1902.00813 (as the repository's sampler makes
them): the DRS gamma is the batch's 80th percentile of F_hat; M is
recalibrated while D is shaped; the shaping real batch holds one image of
each refined sample's class.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cardbench.reference.cond_dcgan import discriminate, generate
from cardbench.reference.dcgan import F32
from cardbench.reference.sampler import accept_step


class ClassIndex:
    """Row c: the indices of the images of class c in ascending order; the
    draw r of a row of class c takes its entry ``r % count``. A class with
    no image gives image 0."""

    def __init__(self, labels: torch.Tensor, num_classes: int):
        labels = labels.long()
        self.order = torch.argsort(labels, stable=True)
        self.counts = torch.bincount(labels, minlength=num_classes)
        self.starts = torch.cumsum(self.counts, 0) - self.counts

    def batch(self, images: torch.Tensor, gen, y: torch.Tensor):
        """(images of classes y in [-1, 1] float32, y)."""
        r = torch.randint(0, 1 << 30, y.shape, generator=gen,
                          device=gen.device)
        count = self.counts[y]
        pos = self.starts[y] + r % count.clamp_min(1)
        idx = torch.where(count > 0, self.order[pos.clamp_max(
            self.order.numel() - 1)], 0)
        return images[idx].float() / 127.5 - 1.0, y


class Model:
    """The conditional pair's sizes and weights (``gw``, ``dw``)."""

    def __init__(self, model: dict, gw: dict, dw: dict, q=F32):
        self.size, self.z_dim = model["image_size"], model["z_dim"]
        self.channels, self.g_base = model["channels"], model["g_base_filters"]
        self.classes = model["num_classes"]
        self.gw, self.dw, self.q = gw, dw, q

    def g(self, z, y):
        with torch.no_grad():
            return generate(self.gw, z, y, self.size, self.channels,
                            self.g_base, self.q)

    def d(self, x, y, dw=None, train=False):
        return discriminate(self.dw if dw is None else dw, x, y, self.size,
                            self.q, train)

    def draw(self, gen, n):
        z = torch.randn((n, self.z_dim), generator=gen, device=gen.device)
        y = torch.randint(0, self.classes, (n,), generator=gen,
                          device=gen.device)
        return z, y

    def refine(self, x0, y, steps, rate, dw=None):
        """(x_K, D(x_K, y)) of K descent steps of softplus(-D(x, y))."""
        x = x0.detach()
        for _ in range(steps):
            with torch.enable_grad():
                xg = x.requires_grad_(True)
                loss = F.softplus(-self.d(xg, y, dw)).sum()
                (grad,) = torch.autograd.grad(loss, xg)
            x = (x.detach() - rate * grad).detach()
        with torch.no_grad():
            return x, self.d(x, y, dw)


def collab_call(model: Model, images: torch.Tensor, index: ClassIndex, gen,
                rc: dict, judged=()) -> dict:
    """One conditional collab call. Returns the samples, labels, accept
    mask, logits, the shaping steps' losses and the shaped D (``dw``). For
    each output in ``judged`` (a dict with 'samples'), ``gains`` holds
    D(x) - D(x0) of each of its rows under the reference's D of the row's
    batch and the reference's labels, x0 the reference's G(z, y);
    ``gain_ref`` the same of the reference's rows. For each judged output
    with a shaped D (``'dw'``), ``shaped_logits`` holds that D's logits,
    and ``shaped_ref`` the reference's shaped D's, on the last batch's
    refined rows and a class-balanced real batch of their labels drawn
    after the call."""
    b = rc["batch_size"]
    dw = {k: v.detach().clone() for k, v in model.dw.items()}
    params = {k: v for k, v in dw.items() if "running" not in k}
    for v in params.values():
        v.requires_grad_(True)
    opt = torch.optim.Adam(list(params.values()), lr=rc["shaping_lr"],
                           betas=(0.5, 0.999), eps=1e-8)
    m = torch.tensor(float("-inf"), device=gen.device)
    for _ in range(max(1, rc["burn_in"] // b)):
        z, y = model.draw(gen, b)
        _, lg = model.refine(model.g(z, y), y, rc["steps"], rc["rate"], dw)
        m = torch.maximum(m, lg.max())
    xs, ys, logits, accepted, losses = [], [], [], [], []
    gains = [[] for _ in judged]
    gain_ref = []
    shaping_on = rc["shape_every"] > 0
    for i in range(rc["num_batches"]):
        z, y = model.draw(gen, b)
        x0 = model.g(z, y)
        x, lg = model.refine(x0, y, rc["steps"], rc["rate"], dw)
        with torch.no_grad():
            base = model.d(x0, y, dw)
            gain_ref.append(lg - base)
            for j, out in enumerate(judged):
                rows = out["samples"][i * b:(i + 1) * b].to(x.device)
                gains[j].append(model.d(rows, y, dw) - base)
        m_eff = m
        if shaping_on:
            m = 0.7 * m + 0.3 * lg.max()
            m_eff = torch.maximum(m, lg.max())
        accepted.append(accept_step(gen, lg, m_eff, rc))
        if shaping_on and i % rc["shape_every"] == 0:
            for _ in range(rc["shaping_steps"]):
                x_real, y_real = index.batch(images, gen, y)
                with torch.enable_grad():
                    loss = (F.softplus(-model.d(x_real, y_real, dw,
                                                True)).mean()
                            + F.softplus(model.d(x, y, dw, True)).mean())
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                opt.step()
                losses.append(float(loss.detach()))
        xs.append(x)
        ys.append(y)
        logits.append(lg)
    for v in params.values():
        v.requires_grad_(False)
    x_real, _ = index.batch(images, gen, y)
    probe, probe_y = torch.cat([x, x_real]), torch.cat([y, y])
    with torch.no_grad():
        shaped = [model.d(probe, probe_y, {k: v.to(probe.device)
                                           for k, v in out["dw"].items()})
                  if "dw" in out else None for out in judged]
        shaped_ref = model.d(probe, probe_y, dw)
    return {"samples": torch.cat(xs), "labels": torch.cat(ys),
            "accepted": torch.cat(accepted), "logits": torch.cat(logits),
            "losses": losses, "dw": dw,
            "gains": [torch.cat(g) for g in gains],
            "gain_ref": torch.cat(gain_ref), "shaped_logits": shaped,
            "shaped_ref": shaped_ref}
