"""Plain replays of the three entries the cells drive, from the inputs the
benchmark gave the program: the seed weights, the real images, and the
seed of each call's ``torch.Generator``. Imports nothing of the program.

They follow the sampler's draw protocol, which is part of its interface:
z ~ N(0, I) as one ``randn((n, z_dim))`` from the caller's generator per
batch of candidates; one DRS key ``randint(0, 2**62)`` (int64) per batch
after its z; the shaping step's real batch from ``inputs.real_batch`` after
that; u of candidate i is ``philox.uniforms(key)[i]``.

The arithmetic, in float32 (TF32 off) or under ``Precision('fp8')``:

* refinement, K steps in x: ``x <- x - rate * grad_x sum softplus(-D(x))``
  under D in eval mode, then the logits D(x_K);
* DRS (arXiv:1810.06758): ``f = min(F - M, -eps)``, ``F_hat = f - log(1 -
  exp(f - eps))``, gamma plus the batch's ``gamma_percentile`` of F_hat
  (linear interpolation), accept where ``u < sigmoid(F_hat - gamma)``;
  the step itself in float64;
* collab (arXiv:1902.00813): M the largest logit of ``burn_in // B``
  refined batches; per batch, refine, ``M <- 0.7 M + 0.3 max F`` and the
  test against ``max(M, max F)``; every ``shape_every`` batches one Adam
  step (b1 0.5, b2 0.999, eps 1e-8) on D with the non-saturating loss,
  train-mode D on the real batch, then on the refined one;
* serving: M from ``burn_in // B`` refined batches, held; per round
  ``num_batches`` batches; each round keeps its first ``cap`` accepted
  rows, ``cap = min(round, max(64, int(round * (1.3 r0 + 0.05))))`` with
  r0 the first round's accept rate, until n rows; images as uint8,
  ``round((x + 1) * 127.5)`` (half to even) clipped to [0, 255].
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from cardbench.inputs import real_batch
from cardbench.reference import philox
from cardbench.reference.dcgan import F32, discriminate, generate


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and cuDNN convolutions within."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Model:
    """The pair's sizes and its weights: ``gw``, ``dw`` dicts of tensors."""

    def __init__(self, model: dict, gw: dict, dw: dict, q=F32):
        self.size, self.z_dim = model["image_size"], model["z_dim"]
        self.channels, self.g_base = model["channels"], model["g_base_filters"]
        self.gw, self.dw, self.q = gw, dw, q

    def g(self, z):
        with torch.no_grad():
            return generate(self.gw, z, self.size, self.channels, self.g_base,
                            self.q)

    def d(self, x, dw=None, train=False):
        return discriminate(self.dw if dw is None else dw, x, self.size,
                            self.q, train)

    def draw(self, gen, n):
        return torch.randn((n, self.z_dim), generator=gen, device=gen.device)

    def refine(self, x0, steps, rate, dw=None):
        """(x_K, D(x_K)) of K descent steps of softplus(-D) from x0."""
        x = x0.detach()
        for _ in range(steps):
            with torch.enable_grad():
                xg = x.requires_grad_(True)
                loss = F.softplus(-self.d(xg, dw)).sum()
                (grad,) = torch.autograd.grad(loss, xg)
            x = (x.detach() - rate * grad).detach()
        with torch.no_grad():
            return x, self.d(x, dw)


def percentile(v: torch.Tensor, pct: float) -> torch.Tensor:
    """Linear-interpolation percentile of a 1-D tensor."""
    s = torch.sort(v).values
    pos = (s.numel() - 1) * pct / 100.0
    lo = int(pos)
    hi = min(lo + 1, s.numel() - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def drs_accept(u, logits, m, rc: dict) -> torch.Tensor:
    f = torch.clamp(logits.double() - torch.as_tensor(m).double(),
                    max=-rc["eps_drs"])
    f_hat = f - torch.log(-torch.expm1(f - rc["eps_drs"]))
    gamma = torch.as_tensor(rc["gamma"], dtype=torch.float64,
                            device=logits.device)
    if rc["gamma_percentile"] > 0:
        gamma = gamma + percentile(f_hat, rc["gamma_percentile"])
    return u.double() < torch.sigmoid(f_hat - gamma)


def accept_step(gen, logits, m, rc):
    key = torch.randint(0, 1 << 62, (1,), generator=gen, device=gen.device,
                        dtype=torch.int64)
    u = philox.uniforms(key, logits.shape[0], logits.device)
    return drs_accept(u, logits, m, rc)


def burn_in_max(model: Model, gen, rc: dict, dw=None) -> torch.Tensor:
    b = rc["batch_size"]
    m = torch.tensor(float("-inf"), device=gen.device)
    for _ in range(max(1, rc["burn_in"] // b)):
        _, logits = model.refine(model.g(model.draw(gen, b)), rc["steps"],
                                 rc["rate"], dw)
        m = torch.maximum(m, logits.max())
    return m


def collab_call(model: Model, images, gen, rc: dict, judged=()) -> dict:
    """One ``sample(..., method='collab')`` call. Returns the samples,
    accept mask, logits, the shaping steps' losses and the shaped D
    (``dw``, BatchNorm averages included). For each output in
    ``judged`` (a dict with 'samples'), ``gains`` holds D(x) - D(x0) of each
    of its rows under the reference's D of the row's batch, x0 the
    reference's G(z); ``gain_ref`` the same of the reference's rows. For
    each judged output that has a shaped D (``'dw'``), ``shaped_logits``
    holds that D's logits, and ``shaped_ref`` the reference's shaped D's,
    on the last batch's refined rows and one real batch after the call."""
    b = rc["batch_size"]
    dw = {k: v.detach().clone() for k, v in model.dw.items()}
    params = {k: v for k, v in dw.items() if "running" not in k}
    for v in params.values():
        v.requires_grad_(True)
    opt = torch.optim.Adam(list(params.values()), lr=rc["shaping_lr"],
                           betas=(0.5, 0.999), eps=1e-8)
    m = burn_in_max(model, gen, rc, dw)
    xs, logits, accepted, losses = [], [], [], []
    gains = [[] for _ in judged]
    gain_ref = []
    shaping_on = rc["shape_every"] > 0
    for i in range(rc["num_batches"]):
        x0 = model.g(model.draw(gen, b))
        x, lg = model.refine(x0, rc["steps"], rc["rate"], dw)
        with torch.no_grad():
            base = model.d(x0, dw)
            gain_ref.append(lg - base)
            for j, out in enumerate(judged):
                rows = out["samples"][i * b:(i + 1) * b].to(x.device)
                gains[j].append(model.d(rows, dw) - base)
        m_eff = m
        if shaping_on:
            m = 0.7 * m + 0.3 * lg.max()
            m_eff = torch.maximum(m, lg.max())
        accepted.append(accept_step(gen, lg, m_eff, rc))
        if shaping_on and i % rc["shape_every"] == 0:
            for _ in range(rc["shaping_steps"]):
                x_real = real_batch(images, gen, b)
                with torch.enable_grad():
                    loss = (F.softplus(-model.d(x_real, dw, True)).mean()
                            + F.softplus(model.d(x, dw, True)).mean())
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                opt.step()
                losses.append(float(loss.detach()))
        xs.append(x)
        logits.append(lg)
    for v in params.values():
        v.requires_grad_(False)
    probe = torch.cat([x, real_batch(images, gen, b)])
    with torch.no_grad():
        shaped = [model.d(probe, {k: v.to(probe.device)
                                  for k, v in out["dw"].items()})
                  if "dw" in out else None for out in judged]
        shaped_ref = model.d(probe, dw)
    return {"samples": torch.cat(xs), "accepted": torch.cat(accepted),
            "logits": torch.cat(logits), "losses": losses,
            "dw": dw, "gains": [torch.cat(g) for g in gains],
            "gain_ref": torch.cat(gain_ref), "shaped_logits": shaped,
            "shaped_ref": shaped_ref}


def refine_round(model: Model, gen, batch: int, rc: dict, round_index: int,
                 judged=()) -> dict:
    """Batch ``round_index`` of a draw-refine call whose generator is gen
    (the earlier batches' z drawn and dropped): x_K, logits, and for each
    judged output (a dict with 'samples') D(x) - D(x0) of each row."""
    for _ in range(round_index):
        model.draw(gen, batch)
    x0 = model.g(model.draw(gen, batch))
    x, lg = model.refine(x0, rc["steps"], rc["rate"])
    with torch.no_grad():
        base = model.d(x0)
        gains = [model.d(out["samples"].to(x.device)) - base
                 for out in judged]
    return {"samples": x, "logits": lg, "gains": gains, "gain_ref": lg - base}


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round((x + 1.0) * 127.5), 0, 255).to(torch.uint8)


def serve_candidates(model: Model, dw: dict, gen, rc: dict,
                     rounds: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Every candidate of a request's first ``rounds`` rounds under the
    shaped D ``dw``: uint8 images (rounds * num_batches * B, H, W, C) and
    the accept mask."""
    b = rc["batch_size"]
    m = burn_in_max(model, gen, rc, dw)
    images, accepted = [], []
    for _ in range(rounds * rc["num_batches"]):
        x, lg = model.refine(model.g(model.draw(gen, b)), rc["steps"],
                             rc["rate"], dw)
        accepted.append(accept_step(gen, lg, m, rc))
        images.append(to_uint8(x))
    return torch.cat(images), torch.cat(accepted)


def serve_request(model: Model, dw: dict, gen, rc: dict, n: int,
                  max_rounds: int = 1000) -> dict:
    """One ``generate(n)`` request as the serving sampler answers it: the
    first n rows kept (uint8, on the host) and the rounds it took."""
    per_round = rc["num_batches"] * rc["batch_size"]
    kept, total, rounds, cap = [], 0, 0, None
    b = rc["batch_size"]
    m = burn_in_max(model, gen, rc, dw)
    while total < n or rounds == 0:
        if rounds >= max_rounds:
            raise RuntimeError(f"{total}/{n} accepted after {rounds} rounds")
        xs, accs = [], []
        for _ in range(rc["num_batches"]):
            x, lg = model.refine(model.g(model.draw(gen, b)), rc["steps"],
                                 rc["rate"], dw)
            accs.append(accept_step(gen, lg, m, rc))
            xs.append(x)
        acc = torch.cat(accs)
        if cap is None:
            rate0 = float(acc.float().mean())
            cap = min(per_round, max(64, int(per_round * (1.3 * rate0
                                                          + 0.05))))
        idx = torch.nonzero(acc)[:cap, 0]
        kept.append(to_uint8(torch.cat(xs)[idx]).cpu())
        total += int(idx.shape[0])
        rounds += 1
    return {"samples": torch.cat(kept)[:n], "rounds": rounds}
