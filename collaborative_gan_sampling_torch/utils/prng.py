"""Random-stream discipline: one generator per (seed, step, role).

Counterpart of ``collaborative_gan_sampling_tpu/utils/prng.py``. Every
consumer of randomness derives its stream from (the run's seed, a step
index, a role tag), so a run restored from a checkpoint at step s draws the
same streams from step s on as the run that wrote it. torch's Philox never
reproduces JAX's threefry, so the streams are the port's own; parity tests
inject the JAX package's draws instead (``training/gan.py::TrainDraws``).
"""

from __future__ import annotations

import hashlib

import torch

# Stable role tags so independent consumers at the same step decorrelate
# (the JAX package's table).
ROLES = {
    "data": 0,
    "z": 1,
    "refine": 2,
    "accept": 3,
    "mh": 4,
    "shape": 5,
    "init_g": 6,
    "init_d": 7,
    "eval": 8,
}


def step_seed(seed: int, step: int, role: str) -> int:
    """The 64-bit seed of (seed, step, role): the first 8 bytes, little
    endian, of sha256 over the ASCII text ``"{seed}:{ROLES[role]}:{step}"``.
    Fixed so that checkpoints written by one version resume in another."""
    text = f"{int(seed)}:{ROLES[role]}:{int(step)}".encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little")


def step_generator(seed: int, step: int, role: str = "z",
                   device: str | torch.device = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for ``role`` at ``step``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(seed, step, role))
    return gen


def fold_generator(generator: torch.Generator, i: int) -> torch.Generator:
    """The ``i``-th substream of ``generator`` (the port's ``fold_in``): a
    new generator on the same device, seeded from the parent's initial seed
    and ``i``, so it does not depend on what the parent has drawn."""
    text = f"{generator.initial_seed()}/{int(i)}".encode()
    gen = torch.Generator(device=generator.device)
    gen.manual_seed(int.from_bytes(hashlib.sha256(text).digest()[:8],
                                   "little"))
    return gen
