#!/usr/bin/env python3
"""Where the bf16 conv refine kernel spends its time, phase by phase.

    python3 conv_refine_phases.py [--source path/to/conv_refine28_bf16.cu]

Builds the kernel source (by default
``collaborative_gan_sampling_torch/csrc/conv_refine28_bf16.cu``) twice with
``nvcc``, with the flags of ``ops/_build.py``: once as it is, once with
``-DCGS_PHASE_CLOCKS``, under which the kernel adds ``clock64()`` cycles per
phase into device counters that the library's ``cgs_phase_clocks`` entry
copies out. Runs both through the wrapper's launch helper at the main path's
shape (B = 256, K = 10, the D of ``chip_smoke.py``) on the weights that
``pack_bf16_refine_weights`` packs, times the plain build with CUDA events,
and prints each phase's share of the counted cycles and that share of the
kernel's time. ``--source`` takes a variant of the kernel with the same C
entry, to compare it with the kernel in one run.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parent
KERNEL = REPO / "collaborative_gan_sampling_torch/csrc/conv_refine28_bf16.cu"
PHASES = ("conv0 forward", "conv1 forward", "dense head and dz2",
          "conv1 VJP", "conv0 VJP (GEMM)", "col2im and update",
          "of which: waiting for conv1 weight tiles")
# Counters that are a part of the others, left out of the total.
OVERLAPPING = (6,)


def build(source: Path, out_dir: Path) -> dict[str, Path]:
    """Two libraries of ``source``: 'plain' and 'counted'
    (-DCGS_PHASE_CLOCKS), compiled at once. Prints ptxas's lines."""
    from collaborative_gan_sampling_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = {}, {}
    for kind, extra in (("plain", []), ("counted", ["-DCGS_PHASE_CLOCKS"])):
        libs[kind] = out_dir / f"lib{source.stem}-{kind}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o",
               str(libs[kind]), str(source)]
        procs[kind] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for kind, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({kind}):\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"   {kind}: {line.strip()}")
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=KERNEL)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from collaborative_gan_sampling_torch.ops import _build, conv_refine
    from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
        fold_dcgan_d,
    )

    if not torch.cuda.is_available():
        raise SystemExit("conv_refine_phases: no CUDA device available")
    libs = build(args.source, REPO / "build" / "phases")
    dev = torch.device("cuda")
    d, gen = cs.refine_d(torch, dev)
    params = fold_dcgan_d(d)
    x0 = torch.randn(cs.BATCH, 28, 28, 1, device=dev, generator=gen) * 0.5
    weights = conv_refine.pack_bf16_refine_weights(params, dev)
    results = {}
    for kind, path in libs.items():
        lib = _build.open_lib(path)

        def run():
            return conv_refine._launch("conv_refine28_bf16", x0, weights,
                                       cs.STEPS, cs.RATE, lib=lib)

        ms = cs.time_ms(run)
        results[kind] = (ms, *run())
        if kind == "counted":
            sums = (ctypes.c_ulonglong * 8)()
            _build.check(lib, lib.cgs_phase_clocks(sums, 1), "counters")
            run()
            torch.cuda.synchronize()
            _build.check(lib, lib.cgs_phase_clocks(sums, 1), "counters")
    ms, xk, lk = results["plain"]
    same = bool(torch.equal(xk, results["counted"][1])
                and torch.equal(lk, results["counted"][2]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"== kernel from {args.source}: {ms:.4f} ms per call at "
          f"B={cs.BATCH}, K={cs.STEPS} (CUDA events; with the counters "
          f"{results['counted'][0]:.4f} ms; same outputs: {same}) on {smi}")
    total = sum(int(sums[i]) for i in range(len(PHASES))
                if i not in OVERLAPPING)
    for i, name in enumerate(PHASES):
        share = int(sums[i]) / total
        print(f"   {name}: {100 * share:.1f}% of the counted cycles, "
              f"{share * ms:.4f} ms of the plain build's time "
              f"({int(sums[i])} cycles over the recording threads)")


if __name__ == "__main__":
    main()
