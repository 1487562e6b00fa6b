"""Tiny sizes of the cells for the CPU tests: every width as published, the
batches, rounds, burn-in and request sizes cut."""

from __future__ import annotations

import time

import torch

from cardbench import harness

TINY = {"refine": {"batch_size": 8, "num_batches": 5, "burn_in": 16},
        "mix": {"real_images": 64, "check": 1, "check_from": 1, "batch": 8,
                "rounds": 2, "n_min": 4, "n_max": 32, "sizes": 4}}
# celeba's D at 64x64x3 on the CPU: batches of 8, one shaping event.
TINY_CELEBA = {"refine": {"batch_size": 8, "num_batches": 2, "burn_in": 8,
                          "shape_every": 2},
               "mix": {"real_images": 16, "check": 1, "check_from": 1}}


def run(workload: str, seed: int = 2 ** 31 + 11, control: bool = False,
        spec: harness.Spec | None = None) -> dict:
    tiny = TINY_CELEBA if workload.startswith("celeba") else TINY
    return harness.run_cell(spec or harness.Spec(), workload, seed, 0.2,
                            False, time.perf_counter(),
                            device=torch.device("cpu"), overrides=tiny,
                            control=control)
