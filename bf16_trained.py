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
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
X_BOUND, LOGIT_BOUND = 1e-5, 1e-4
STEPS, RATE, BATCH = 10, 0.02, 256


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
        outs = dict(xk=xk, lk=lk, x32=x32, l32=l32, xp=xp, lp=lp)
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
