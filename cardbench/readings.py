"""Readings for the output check's limits, on the card: the program's
compared numbers on each of ``--seeds`` and, on ``--control`` seeds, the
control's too (the plain reference in fp8 in the program's place), each
from a short window at the cell's own load. One JSON line per seed.

    python3 cardbench/readings.py --workload mnist.collab --seeds 1,2,3 \
        --control 1 --seconds 3
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch

    from cardbench import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 1
    spec = harness.Spec()
    control = {int(s) for s in args.control.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(spec, args.workload, seed, args.seconds, False,
                             t0, control=seed in control)
        row = {"workload": args.workload, "seed": seed,
               "correct": r["correct"], "attempted": r["attempted"],
               "program": r["_numbers"]}
        if r["_control"]:
            row["control"] = r["_control"]
        row["metrics"] = {k: v["value"] for k, v in r["metrics"].items()}
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
