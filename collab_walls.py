#!/usr/bin/env python3
"""Wall time of the mnist collab path at f32, warm, and its device share.

    python3 collab_walls.py [--root DIR]

Runs ``chip_smoke.py``'s f32 mnist collab run (``f32_collab``: the run's
shape is stated there, and taken from this checkout's ``chip_smoke.py``)
on the package under ``--root`` (default: this checkout), so that two
trees, such as an unpacked parent commit and this one, can be compared in
turns in one call on one card. One warm-up run, then RUNS timed runs (wall
up to a synchronize) and one run under ``torch.profiler``: its wall, the
device's busy time and share, and the f32 refine kernel's device time and
launches. Needs a card.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import chip_smoke as cs

RUNS = 5


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("collab_walls: no CUDA device available")
    import collaborative_gan_sampling_torch as pkg
    from collaborative_gan_sampling_torch.config import get_preset
    from collaborative_gan_sampling_torch.ops import _build

    if os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))) != root:
        raise SystemExit(f"collab_walls: imported {pkg.__file__}, not "
                         f"the package under {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build()
    _, data_fn = cs.image_data_fn(dev, get_preset("mnist").data)
    _, run = cs.f32_collab(torch, dev, data_fn)

    run(1)
    torch.cuda.synchronize()
    walls = []
    for i in range(RUNS):
        t0 = time.perf_counter()
        run(2 + i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"   {root}: f32 mnist collab walls "
          f"{['%.1f' % w for w in walls]} ms, median "
          f"{statistics.median(walls):.1f} ms")
    wall, kernels, averages = cs.profiled(torch, lambda: run(9))
    busy = sum(ms for ms, _ in kernels.values())
    ms = sum(t for name, (t, _) in kernels.items() if "refine_kernel" in name)
    n = sum(c for name, (_, c) in kernels.items() if "refine_kernel" in name)
    print(f"   {root}: profiled {wall * 1e3:.1f} ms wall, device busy "
          f"{busy:.2f} ms ({100 * busy / (wall * 1e3):.1f}%), f32 refine "
          f"kernel {ms:.2f} ms over {n} launches")
    cs.print_profile("f32 mnist collab", wall, kernels, averages)


if __name__ == "__main__":
    main()
