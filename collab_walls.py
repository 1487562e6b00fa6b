#!/usr/bin/env python3
"""Wall time of a collab path, warm, and its device share.

    python3 collab_walls.py [--root DIR] [--path {f32,bf16,toy2d}]

Runs one of ``chip_smoke.py``'s collab runs (each run's shape is stated
there, and taken from this checkout's ``chip_smoke.py``): ``f32_collab``
(mnist at f32, the default), ``bf16_collab`` (mnist at the preset's bf16,
the main path) or ``toy2d_collab`` (the full toy2d preset), on the package
under ``--root`` (default: this checkout), so that two trees, such as an
unpacked parent commit and this one, can be compared in turns in one call
on one card. One warm-up run, then RUNS timed runs (wall up to a
synchronize) and one run under ``torch.profiler``: its wall, the device's
busy time and share, the host's kernel launches, the calls at which the
host may wait for the card (synchronizations and copies), and the refine
and accept kernels' device time and launches.

With ``--path toy2d`` it also times the toy2d path's two kernels through
the package's own entry points, which both trees share: the MLP refinement
(``sampling/refine.py::make_refine_fn`` at B = 256 and 65,536: device ms per
kernel launch, ms per call by CUDA events, host launches per call) and one
DRS step (``chip_smoke.py::accept_call_launches``). Needs a card.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import chip_smoke as cs

RUNS = 5
PATHS = ("f32", "bf16", "toy2d")


def collab_run(torch, dev, path):
    """run(seed) of the chosen collab run."""
    from collaborative_gan_sampling_torch.config import get_preset

    if path == "toy2d":
        return cs.toy2d_collab(torch, dev)[2]
    _, data_fn = cs.image_data_fn(dev, get_preset("mnist").data)
    if path == "f32":
        return cs.f32_collab(torch, dev, data_fn)[1]
    return cs.bf16_collab(torch, dev, data_fn)[1]


def toy2d_kernels(torch, dev, root):
    from collaborative_gan_sampling_torch.config import get_preset
    from collaborative_gan_sampling_torch.models import make_bundle
    from collaborative_gan_sampling_torch.sampling.refine import (
        make_refine_fn,
    )

    cfg = get_preset("toy2d")
    bundle = make_bundle(cfg.model)
    gen = torch.Generator(device=dev).manual_seed(4)
    _, d = bundle.init(gen)
    refine = make_refine_fn(bundle, cfg.refine)
    for n in (cs.BATCH, 65536):
        x0 = torch.randn(n, 2, device=dev, generator=gen) * 2.0

        def call(x0=x0):
            return refine(d, x0)

        device = cs.device_ms_per_launch(torch, call, "refine_kernel")
        events = cs.time_ms(call)
        _, _, averages = cs.profiled(torch, call)
        print(f"   {root}: toy2d refine B={n}: {device:.4f} ms per kernel "
              f"launch on the device, {events:.4f} ms per call by events, "
              f"{cs.host_launches(averages)} host launches per call")
    for pct, (host, kern, ms, ev, waits) in cs.accept_call_launches(
            torch, dev).items():
        print(f"   {root}: DRS step B={cs.BATCH} percentile {pct:g}: "
              f"{host:g} host launches, {kern:g} device kernels, "
              f"{ms:.4f} device ms, {ev:.4f} ms by events per call; host "
              f"waits in 5 calls: {waits}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--path", choices=PATHS, default="f32")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("collab_walls: no CUDA device available")
    import collaborative_gan_sampling_torch as pkg
    from collaborative_gan_sampling_torch.ops import _build

    if os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))) != root:
        raise SystemExit(f"collab_walls: imported {pkg.__file__}, not "
                         f"the package under {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build()
    run = collab_run(torch, dev, args.path)

    run(1)
    torch.cuda.synchronize()
    walls = []
    for i in range(RUNS):
        t0 = time.perf_counter()
        run(2 + i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"   {root}: {args.path} collab walls "
          f"{['%.1f' % w for w in walls]} ms, median "
          f"{statistics.median(walls):.1f} ms")
    wall, kernels, averages = cs.profiled(torch, lambda: run(9))
    busy = sum(ms for ms, _ in kernels.values())
    parts = []
    for label, keys in (("refine", ("refine",)),
                        ("accept", ("accept", "drs_step"))):
        ms = sum(t for k, (t, _) in kernels.items()
                 if any(key in k for key in keys))
        n = sum(c for k, (_, c) in kernels.items()
                if any(key in k for key in keys))
        parts.append(f"{label} kernel {ms:.2f} ms over {n} launches")
    print(f"   {root}: profiled {wall * 1e3:.1f} ms wall, device busy "
          f"{busy:.2f} ms ({100 * busy / (wall * 1e3):.1f}%), "
          f"{cs.host_launches(averages)} host launches; " + "; ".join(parts))
    cs.print_profile(f"{args.path} collab", wall, kernels, averages)
    if args.path == "toy2d":
        toy2d_kernels(torch, dev, root)


if __name__ == "__main__":
    main()
