"""Run one cell of the port's benchmark once, on the card, and print one JSON
line as the last line of standard output.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``. With ``--trace 0``
the line holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones, read under ``torch.profiler``. Every run judges the outputs
it kept against the plain reference after the window (``correct``) and
prints each compared number beside its limit, on standard error and under
``check``, the line's last key. Without a card, or with fewer cards than
the cell asks for, it prints no result and exits 1. Caches go to fixed
directories under ``build/`` in the checkout; the port builds its kernels
into ``build/kernels/``.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "cuda"}
# One CPU thread for torch's own pool: the cells are bound by the host's
# launch stream, which other threads would slow unevenly.
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(REPO / "build" / "cardbench" / sub)
    os.environ.update(THREADS)
    sys.path.insert(0, str(REPO))
    import torch

    torch.set_num_threads(1)

    from cardbench import harness
    from cardbench.card import card_line

    spec = harness.Spec()
    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cardbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    try:
        print(f"card: {card_line(0)}", file=sys.stderr)
    except (OSError, subprocess.CalledProcessError, RuntimeError) as e:
        print(f"card: nvidia-smi gave no line ({e})", file=sys.stderr)
    result = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                              bool(args.trace), T_PROCESS)
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        print(f"cardbench: the run loaded {loaded}", file=sys.stderr)
        return 1
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
