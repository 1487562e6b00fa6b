#!/usr/bin/env python3
"""The bf16 conv refine kernel on trained weights, against its plain version
and against the JAX package's own bf16 kernel.

    python3 bf16_trained.py dump      # on the card
    python bf16_trained.py compare    # on the CPU, beside the JAX package

``dump`` trains the mnist preset as ``chip_smoke.py``'s phase 5t does (500
iterations, bf16), restores it, runs one collab pass, and refines 256
samples of the trained G (K = 10, rate 0.02) under the trained and the
shaped D with the bf16 kernel, the f32 kernel and the plain bf16 version.
It writes the two Ds (Flax variables), x0 and every output to ``--data``
(MessagePack, about 7 MB).

``compare`` reads that file and runs the JAX package's
``fused_refine_conv28_v2`` (interpret mode, bf16 and f32 matmuls) and the
port's plain versions on the CPU, and prints, for each pair of
implementations, how many samples differ beyond the bf16 check's bounds
(1e-5 on x, 1e-4 on logits) and the largest differences. It also holds the
logits of D(x0) from both bf16 versions (K = 0) against the same function
evaluated in float64: the bf16-rounded operands (x, h1, w0, w1) with exact
sums, which says which of the two strays.

Then, per D, it finds where lrelu' flips. ``dump`` also writes the plain
bf16 version's trajectory x_0 .. x_{K-1} on the card and one step of the
bf16 kernel from each x_t. ``compare`` takes one step of the JAX package's
v2 kernel (bf16) and of the port's plain bf16 version from the same x_t,
and holds each against the float64 step with the same bf16-rounded operands
(``step64``). A flip is a pre-activation that lies within a version's
float32 rounding of 0 and takes the other sign there: it swaps lrelu'
between 1 and 0.2 at one unit. ``flip_attribution`` tries, for each sample,
the CANDIDATES units whose pre-activations lie nearest 0 (relative to the
sum of their terms' magnitudes) one at a time, and calls the step a flip at
that unit when the float64 step with that lrelu' flipped is EXPLAINS times
nearer the version's step than the unflipped one. It prints, per version,
the samples that flip at each step, each sample's first flip step, and the
median error of the steps that did not flip, as a share of what bf16
rounding itself does to the step (the float64 bf16-operand step against
the float64 float32 one): an operand rounded where JAX keeps float32 would
raise that share on every sample, where a sum in another order does not.
A control shows by how much: the float64 step with the dense head's h2
rounded to bf16 as well.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
X_BOUND, LOGIT_BOUND = 1e-5, 1e-4
STEPS, RATE, BATCH = 10, 0.02, 256
CANDIDATES = 4  # units per sample and step tried as the one that flipped
EXPLAINS = 4.0  # a flip brings the step this many times nearer, at least


def dump(path: str) -> None:
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke
    from collaborative_gan_sampling_torch.ops.conv_refine import (
        fused_refine_conv28,
        fused_refine_conv28_bf16,
    )
    from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
        fold_dcgan_d,
        refine_conv28_plain_bf16,
    )
    from collaborative_gan_sampling_torch.training.gan import sampling_g
    from collaborative_gan_sampling_torch.utils import msgpack
    from collaborative_gan_sampling_torch.utils.weights import (
        to_jax_variables,
    )

    if not torch.cuda.is_available():
        raise SystemExit("bf16_trained.py dump: no CUDA device available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    exp = chip_smoke.mnist_train(dev)
    exp.train()
    state = exp.load_state()
    shaped = exp.sample(state, method="collab").aux["shaped_d"]
    gen = torch.Generator(device=dev).manual_seed(21)
    with torch.no_grad():
        x0 = exp.bundle.generate(sampling_g(state),
                                 exp.bundle.sample_z(gen, BATCH))
    out = {"x0": x0.cpu().numpy()}
    for label, d in (("trained", state.d), ("shaped", shaped)):
        p = fold_dcgan_d(d)
        xk, lk = fused_refine_conv28_bf16(p, x0, STEPS, RATE)
        x32, l32 = fused_refine_conv28(p, x0, STEPS, RATE)
        with torch.backends.cudnn.flags(enabled=False):
            xp, lp = refine_conv28_plain_bf16(p, x0, STEPS, RATE)
        # The plain version's trajectory and one kernel step from each x_t.
        xs, ys, x = [], [], x0
        for _ in range(STEPS):
            xs.append(x)
            ys.append(fused_refine_conv28_bf16(p, x, 1, RATE)[0])
            with torch.backends.cudnn.flags(enabled=False):
                x = refine_conv28_plain_bf16(p, x, 1, RATE)[0]
        outs = dict(xk=xk, lk=lk, x32=x32, l32=l32, xp=xp, lp=lp,
                    xs=torch.stack(xs), ys=torch.stack(ys))
        out[label] = {"vars": to_jax_variables(d),
                      **{k: v.cpu().numpy() for k, v in outs.items()}}
        print(f"{label} D: bn1 running variance "
              f"{float(d.bn1.running_var.min()):.3e} to "
              f"{float(d.bn1.running_var.max()):.3e}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(msgpack.packb(out))
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


def _differ(a, b):
    """(samples beyond the bounds, max |dx|, max |dlogit|, median |dx|)."""
    import numpy as np

    (xa, la), (xb, lb) = a, b
    dx = np.abs(xa - xb).reshape(len(xa), -1).max(1)
    dl = np.abs(la - lb)
    beyond = int(((dx > X_BOUND) | (dl > LOGIT_BOUND)).sum())
    return beyond, float(dx.max()), float(dl.max()), float(np.median(dx))


def forward_f64(params, x0):
    """Logits of the folded D with the bf16 version's rounded operands (x,
    w0, the post-lrelu h1, w1) and every sum in float64: (B,)."""
    import torch
    import torch.nn.functional as F

    def bf16(t):
        return t.float().to(torch.bfloat16).double()

    def lrelu(t):
        return torch.where(t > 0, t, 0.2 * t)

    def conv(h, w, b):  # XLA's SAME for a stride-2 5x5 conv: pad (1, 2)
        return F.conv2d(F.pad(h, (1, 2, 1, 2)), bf16(w).permute(3, 2, 0, 1),
                        b.double(), stride=2)

    x = bf16(torch.from_numpy(x0).permute(0, 3, 1, 2))
    h1 = bf16(lrelu(conv(x, params.w0, params.b0)))
    h2 = lrelu(conv(h1, params.w1, params.b1))
    wd = params.wd.double().reshape(7, 7, 128).permute(2, 0, 1)
    return ((h2 * wd).sum((1, 2, 3)) + params.bd.double()).numpy()


def _bf16(t):
    import torch

    return t.to(torch.bfloat16).double()


def step64(params, x, flips=None, round_head=False):
    """One refinement step of the bf16-operand function in float64 from x
    (N, 28, 28, 1): what ``refine_conv28_plain_bf16`` computes at ``dtype``
    float64, with lrelu' flipped where ``flips`` = (f0 (N, 64, 14, 14), f1
    (N, 128, 7, 7)) is true; with ``round_head``, the dense head's operand
    h2 is rounded to bf16 too (the control: an operand that JAX keeps in
    float32, rounded). Returns (x' (N, 28, 28, 1), a0, a1, s0, s1):
    the new x, conv0's and conv1's pre-activations, and for each the sum of
    its terms' magnitudes (bias included)."""
    import torch
    import torch.nn.functional as F

    from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
        preactivations_bf16,
    )

    xn = x.double().permute(0, 3, 1, 2)
    w0 = _bf16(params.w0).permute(3, 2, 0, 1)
    w1 = _bf16(params.w1).permute(3, 2, 0, 1)
    wd = params.wd.double().reshape(7, 7, 128).permute(2, 0, 1)
    a0, a1 = preactivations_bf16(params, xn, torch.float64)
    h1 = F.leaky_relu(a0, 0.2)
    s0 = F.conv2d(F.pad(_bf16(xn).abs(), (1, 2, 1, 2)), w0.abs(),
                  params.b0.double().abs(), stride=2)
    s1 = F.conv2d(F.pad(_bf16(h1).abs(), (1, 2, 1, 2)), w1.abs(),
                  params.b1.double().abs(), stride=2)
    m0, m1 = a0 > 0, a1 > 0
    if flips is not None:
        m0, m1 = m0 ^ flips[0], m1 ^ flips[1]
    h2 = F.leaky_relu(a1, 0.2)
    logit = ((_bf16(h2) if round_head else h2) * wd).sum((1, 2, 3)) \
        + params.bd.double()
    dh2 = -torch.sigmoid(-logit)[:, None, None, None] * wd
    dz2 = _bf16(torch.where(m1, dh2, 0.2 * dh2))
    dh1 = F.conv_transpose2d(dz2, w1, stride=2)[:, :, 1:15, 1:15]
    dz1 = _bf16(torch.where(m0, dh1, 0.2 * dh1))
    dx = F.conv_transpose2d(dz1, w0, stride=2)[:, :, 1:29, 1:29]
    return (xn - RATE * dx).permute(0, 2, 3, 1), a0, a1, s0, s1


def flip_candidates(params, x):
    """(y64, idx, yc): the float64 step from x (N, 28, 28, 1), the
    CANDIDATES units (N, C) whose pre-activations lie nearest 0 relative to
    their terms' magnitudes (conv0's 12,544 units first, then conv1's
    6,272), and the float64 step with each one's lrelu' flipped (N, C, 28,
    28, 1)."""
    import torch

    y64, a0, a1, s0, s1 = step64(params, x)
    n, c = x.shape[0], CANDIDATES
    near = torch.cat([(a0.abs() / s0).flatten(1), (a1.abs() / s1).flatten(1)],
                     1)
    idx = near.topk(c, dim=1, largest=False).indices
    flips = torch.zeros(n * c, near.shape[1], dtype=torch.bool)
    flips[torch.arange(n * c), idx.flatten()] = True
    n0 = a0[0].numel()
    yc = step64(params, x.repeat_interleave(c, 0), (
        flips[:, :n0].reshape(n * c, *a0.shape[1:]),
        flips[:, n0:].reshape(n * c, *a1.shape[1:])))[0]
    return y64, idx, yc.reshape(n, c, *x.shape[1:])


def flip_attribution(y, y64, idx, yc):
    """Per sample of one step whose output is y (N, 28, 28, 1): (layer (N,)
    0 or 1 where the step flipped lrelu' at one of the candidates, -1
    where it did not; err (N,) its largest |error| against the float64
    step y64)."""
    import torch

    y = y.double()
    err = (y - y64).abs().flatten(1).amax(1)
    to_c = (y[:, None] - yc).abs().flatten(2).amax(2)
    best, which = to_c.min(1)
    unit = idx.gather(1, which[:, None])[:, 0]
    layer = (unit >= 64 * 14 * 14).long()
    return torch.where(best * EXPLAINS < err, layer, -1), err


def flips_report(params, xs, runs):
    """Print, for each version in ``runs`` (name -> one step (STEPS, N, 28,
    28, 1) from each x_t of ``xs``), where its lrelu' flipped and the
    median error of the steps that did not, against the float64 step."""
    import torch

    from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
        refine_conv28_plain,
    )

    n = xs.shape[1]
    layers = {name: [] for name in runs}
    medians = {name: [] for name in runs}
    effect = []
    for t in range(STEPS):
        y64, idx, yc = flip_candidates(params, xs[t])
        f32 = refine_conv28_plain(params, xs[t], 1, RATE,
                                  dtype=torch.float64)[0]
        effect.append(float((f32 - y64).abs().flatten(1).amax(1).median()))
        for name, ys in runs.items():
            layer, err = flip_attribution(ys[t], y64, idx, yc)
            layers[name].append(layer)
            kept = err[layer < 0]
            medians[name].append(float(kept.median()) if len(kept) else 0.0)
    print("  bf16 rounding's own median |dx| a step (float64 bf16-operand "
          "step against float64 f32): " + ", ".join(f"{e:.3e}"
                                                     for e in effect))
    for name in runs:
        lay = torch.stack(layers[name])  # (STEPS, N)
        flipped = lay >= 0
        first = torch.where(flipped.any(0), flipped.int().argmax(0), -1)
        by_first = [int((first == t).sum()) for t in range(STEPS)]
        share = max(m / e for m, e in zip(medians[name], effect))
        print(f"  {name}: lrelu' flipped at {int(flipped.sum())} (sample, "
              f"step) pairs, {int((lay == 0).sum())} in conv0 and "
              f"{int((lay == 1).sum())} in conv1; by step "
              f"{[int(c) for c in flipped.sum(1)]}")
        print(f"    first flip by step {by_first}, never {int((first < 0).sum())}"
              f" of {n}; median |dx| of the unflipped steps "
              + ", ".join(f"{m:.3e}" for m in medians[name])
              + f", at most {share:.4f} of bf16 rounding's own")


def compare(path: str, n: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from collaborative_gan_sampling_torch.config import get_preset
    from collaborative_gan_sampling_torch.models import make_bundle
    from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
        fold_dcgan_d,
        refine_conv28_plain,
        refine_conv28_plain_bf16,
    )
    from collaborative_gan_sampling_torch.utils import msgpack
    from collaborative_gan_sampling_torch.utils.weights import (
        load_jax_variables,
    )
    from collaborative_gan_sampling_tpu.ops.conv_refine_pallas import (
        fused_refine_conv28_v2,
    )

    jax.config.update("jax_platforms", "cpu")
    with open(path, "rb") as fh:
        data = msgpack.unpackb(fh.read())
    x0 = data["x0"][:n]
    bundle = make_bundle(get_preset("mnist").model, device="cpu")
    print(f"{n} samples, K = {STEPS}, rate {RATE}; beyond = samples whose "
          f"|dx| > {X_BOUND:g} or |dlogit| > {LOGIT_BOUND:g}")
    for label in ("trained", "shaped"):
        r = data[label]
        _, d = bundle.init(torch.Generator().manual_seed(0))
        params = fold_dcgan_d(load_jax_variables(d, r["vars"]))
        jvars = jax.tree.map(jnp.asarray, r["vars"])
        runs = {"card: bf16 kernel": (r["xk"][:n], r["lk"][:n]),
                "card: plain bf16": (r["xp"][:n], r["lp"][:n]),
                "card: f32 kernel": (r["x32"][:n], r["l32"][:n])}
        for bf16 in (True, False):
            x, lg = fused_refine_conv28_v2(jvars, jnp.asarray(x0), STEPS,
                                           RATE, interpret=True, bf16=bf16)
            runs[f"JAX v2 {'bf16' if bf16 else 'f32'}"] = (np.asarray(x),
                                                           np.asarray(lg))
        for name, fn in (("CPU: plain bf16", refine_conv28_plain_bf16),
                         ("CPU: plain f32", refine_conv28_plain)):
            x, lg = fn(params, torch.from_numpy(x0), STEPS, RATE)
            runs[name] = (x.numpy(), lg.numpy())
        exact = forward_f64(params, x0)
        for name, lg in (
                ("JAX v2 bf16", fused_refine_conv28_v2(
                    jvars, jnp.asarray(x0), 0, RATE, interpret=True,
                    bf16=True)[1]),
                ("CPU: plain bf16", refine_conv28_plain_bf16(
                    params, torch.from_numpy(x0), 0, RATE)[1])):
            err = np.asarray(lg, np.float64) - exact
            print(f"{label} D, D(x0) of {name} against float64: mean "
                  f"{err.mean():.3e}, max |.| {np.abs(err).max():.3e}")
        moved = float(np.abs(runs["card: plain bf16"][0] - x0).max())
        print(f"{label} D (the plain bf16 refinement moves x by up to "
              f"{moved:.3e}):")
        for a, b in (("card: bf16 kernel", "card: plain bf16"),
                     ("JAX v2 bf16", "card: plain bf16"),
                     ("JAX v2 bf16", "card: bf16 kernel"),
                     ("JAX v2 bf16", "CPU: plain bf16"),
                     ("CPU: plain bf16", "card: plain bf16"),
                     ("JAX v2 f32", "CPU: plain f32"),
                     ("JAX v2 f32", "card: f32 kernel"),
                     ("JAX v2 bf16", "JAX v2 f32")):
            beyond, ex, el, med = _differ(runs[a], runs[b])
            print(f"  {a} vs {b}: {beyond} of {n} beyond; max |dx| "
                  f"{ex:.3e}, max |dlogit| {el:.3e}, median |dx| {med:.3e}")
        xs = torch.from_numpy(np.array(r["xs"][:, :n]))
        steps = {"card: bf16 kernel": torch.from_numpy(
                     np.array(r["ys"][:, :n])),
                 "JAX v2 bf16": torch.stack([torch.from_numpy(np.array(
                     fused_refine_conv28_v2(jvars, jnp.asarray(x.numpy()), 1,
                                            RATE, interpret=True,
                                            bf16=True)[0])) for x in xs]),
                 "CPU: plain bf16": torch.stack([refine_conv28_plain_bf16(
                     params, x, 1, RATE)[0] for x in xs]),
                 "control, the dense head's h2 in bf16": torch.stack([
                     step64(params, x, round_head=True)[0] for x in xs])}
        print(f"{label} D, one step from each x_t (t < {STEPS}) of the card's "
              "plain bf16 trajectory against the float64 step:")
        flips_report(params, xs, steps)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["dump", "compare"])
    ap.add_argument("--data", default=os.path.join(
        REPO, "runs", "bf16_trained.msgpack"))
    ap.add_argument("-n", type=int, default=BATCH,
                    help="samples to compare (compare)")
    args = ap.parse_args()
    if args.mode == "dump":
        dump(args.data)
    else:
        compare(args.data, args.n)


if __name__ == "__main__":
    main()
