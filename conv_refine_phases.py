#!/usr/bin/env python3
"""Where a refine kernel spends its time, phase by phase.

    python3 conv_refine_phases.py [--kernel {bf16,f32,mlp}] [--source file.cu]
                                  [--batch B] [--tile T]

Builds the kernel's source (by default ``collaborative_gan_sampling_torch/
csrc/conv_refine28_bf16.cu`` for ``--kernel bf16``, ``conv_refine28.cu`` for
``--kernel f32``, ``refine_mlp.cu`` for ``--kernel mlp``) twice with
``nvcc``, with the flags of ``ops/_build.py``: once as it is, once with
``-DCGS_PHASE_CLOCKS``, under which the kernel adds ``clock64()`` cycles per
phase into device counters that the library's ``cgs_phase_clocks`` entry
copies out. Runs both through the wrapper's launch helper on the D of
``chip_smoke.py``: a conv kernel at the main path's shape (B = 256, K = 10)
on the weights that its packer (``pack_bf16_refine_weights`` or
``pack_f32_refine_weights``) packs; the MLP kernel at ``--batch`` samples
(default 256, K = 10, the toy2d rate) on ``--tile`` (2 or 8; default: the
wrapper's ``launch_plan``), on D's own weights. Times the plain build with
CUDA events, and prints each phase's share of the counted cycles and that
share of the kernel's time; for the MLP kernel also the counted cycles per
tile. ``--source`` takes a
variant of the kernel with the same C entry and arguments (it may include
the headers of ``csrc/``), to compare it with the kernel in one run.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parent
CSRC = REPO / "collaborative_gan_sampling_torch/csrc"
# Per kernel: its source, C entry, weight packer (in ops/conv_refine.py) and
# its phases by counter index. "of which" counters are a part of the others
# and left out of the total.
KERNELS = {
    "bf16": dict(
        source=CSRC / "conv_refine28_bf16.cu", entry="conv_refine28_bf16",
        pack="pack_bf16_refine_weights",
        phases={0: "conv0 forward", 1: "conv1 forward",
                2: "dense head and dz2", 3: "conv1 VJP",
                4: "conv0 VJP (GEMM)", 5: "col2im and update",
                6: "of which: waiting for conv1 weight tiles"}),
    "f32": dict(
        source=CSRC / "conv_refine28.cu", entry="conv_refine28",
        pack="pack_f32_refine_weights",
        phases={0: "conv0 forward", 1: "conv1 forward",
                2: "dense head and dz2", 3: "conv1 VJP",
                4: "conv0 VJP and update",
                6: "of which: waiting for conv1 weight tiles"}),
    "mlp": dict(
        source=CSRC / "refine_mlp.cu",
        phases={0: "layer 0 forward", 1: "hidden layers' forwards",
                2: "head and top gradient", 3: "hidden layers' input-VJPs",
                4: "x update", 5: "copies issued, a tile's x in and out",
                6: "waiting for the weights to land"}),
}
NCOUNTERS = 8


def build(source: Path, out_dir: Path) -> dict[str, Path]:
    """Two libraries of ``source``: 'plain' and 'counted'
    (-DCGS_PHASE_CLOCKS), compiled at once. Prints ptxas's lines."""
    from collaborative_gan_sampling_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = {}, {}
    for kind, extra in (("plain", []), ("counted", ["-DCGS_PHASE_CLOCKS"])):
        libs[kind] = out_dir / f"lib{source.stem}-{kind}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-I",
               str(CSRC), "-o", str(libs[kind]), str(source)]
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


def measure(source: Path, launch, phases: dict[int, str], out_dir: Path,
            label: str, tiles: int | None = None) -> None:
    """Build ``source`` plain and counted, run ``launch(lib) -> (x, logits)``
    on both and print the time and the split; with ``tiles``, also the
    counted cycles per tile."""
    import torch

    import chip_smoke as cs
    from collaborative_gan_sampling_torch.ops import _build
    from collaborative_gan_sampling_torch.utils.profiling import card_line

    libs = build(source, out_dir)
    results = {}
    sums = (ctypes.c_ulonglong * NCOUNTERS)()
    for kind, path in libs.items():
        lib = _build.open_lib(path)

        def run():
            return launch(lib)

        ms = cs.time_ms(run)
        results[kind] = (ms, *run())
        if kind == "counted":
            _build.check(lib, lib.cgs_phase_clocks(sums, 1), "counters")
            run()
            torch.cuda.synchronize()
            _build.check(lib, lib.cgs_phase_clocks(sums, 1), "counters")
    ms, xk, lk = results["plain"]
    same = bool(torch.equal(xk, results["counted"][1])
                and torch.equal(lk, results["counted"][2]))
    print(f"== kernel from {source}: {ms:.4f} ms per call at {label} (CUDA "
          f"events; with the counters {results['counted'][0]:.4f} ms; same "
          f"outputs: {same}) on {card_line(xk.device)}")
    total = sum(int(sums[i]) for i, name in phases.items()
                if not name.startswith("of which"))
    for i, name in phases.items():
        share = int(sums[i]) / total
        print(f"   {name}: {100 * share:.1f}% of the counted cycles, "
              f"{share * ms:.4f} ms of the plain build's time "
              f"({int(sums[i])} cycles over the recording threads)")
    if tiles:
        print(f"   {total / tiles:.0f} counted cycles per tile")


def conv_launch(spec):
    """The conv kernel's launch at the main path's shape."""
    import torch

    import chip_smoke as cs
    from collaborative_gan_sampling_torch.ops import conv_refine
    from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
        fold_dcgan_d,
    )

    dev = torch.device("cuda")
    d, gen = cs.refine_d(torch, dev)
    params = fold_dcgan_d(d)
    x0 = torch.randn(cs.BATCH, 28, 28, 1, device=dev, generator=gen) * 0.5
    weights = getattr(conv_refine, spec["pack"])(params, dev)

    def launch(lib):
        return conv_refine._launch(spec["entry"], x0, weights, cs.STEPS,
                                   cs.RATE, lib=lib)

    return launch, f"B={cs.BATCH}, K={cs.STEPS}", None


def mlp_launch(batch: int, tile: int | None):
    """The MLP kernel's launch on the toy2d D at ``batch`` samples."""
    import torch

    import chip_smoke as cs
    from collaborative_gan_sampling_torch.ops import refine_mlp as R

    dev = torch.device("cuda")
    d, gen = cs.mlp_d(torch, dev)
    layers = R.mlp_layers(d)
    x0 = torch.randn(batch, 2, device=dev, generator=gen) * 2.0
    hidden, relu = R.check_layers(layers, x0)
    plan = R.launch_plan(batch, 2, hidden, relu,
                         R._sms(torch.cuda.current_device()), tile=tile)

    def launch(lib):
        return R._launch(layers, x0, cs.MLP_STEPS, cs.MLP_RATE, plan,
                         lib=lib)

    return (launch, f"B={batch}, K={cs.MLP_STEPS}, tile {plan.tile}, "
            f"{plan.grid} blocks", -(-batch // plan.tile))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="bf16")
    ap.add_argument("--source", type=Path)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--tile", type=int)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("conv_refine_phases: no CUDA device available")
    spec = KERNELS[args.kernel]
    launch, label, tiles = (mlp_launch(args.batch, args.tile)
                            if args.kernel == "mlp" else conv_launch(spec))
    measure(args.source or spec["source"], launch, spec["phases"],
            REPO / "build" / "phases", label, tiles)


if __name__ == "__main__":
    main()
