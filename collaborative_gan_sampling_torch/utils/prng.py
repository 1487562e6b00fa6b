"""Random-stream discipline: one generator per (seed, step, role).

Counterpart of ``collaborative_gan_sampling_tpu/utils/prng.py``. Every
consumer of randomness derives its stream from (the run's seed, a step
index, a role tag), so a run restored from a checkpoint at step s draws the
same streams from step s on as the run that wrote it. torch's Philox never
reproduces JAX's threefry, so the streams are the port's own; parity tests
inject the JAX package's draws instead (``training/gan.py::TrainDraws``).

The exported serving round (``sampling/export.py``) cannot take a
``torch.Generator``: its draws come from one int64 seed tensor, through
counter-based Philox4x32-10 on tensor ops (``philox_keys``,
``philox_normal``, ``philox_randint``), so that the traced program holds
them and no global-RNG op.
"""

from __future__ import annotations

import hashlib

import math

import torch

from collaborative_gan_sampling_torch.ops.accept import (
    bits_to_uniform,
    philox4x32_plain,
)

_MASK32 = 0xFFFFFFFF

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


def _philox_words(key: torch.Tensor, n: int, c2: int = 0, c3: int = 0):
    """The four 32-bit words (int64 tensors of n) of Philox4x32-10 at
    counters (i, 0..n-1 high word, c2, c3) under the 64-bit ``key``."""
    key = key.reshape(()).to(torch.int64)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    counter = (idx & _MASK32, idx >> 32, torch.full_like(idx, c2 & _MASK32),
               torch.full_like(idx, c3 & _MASK32))
    return philox4x32_plain(counter, (key & _MASK32, (key >> 32) & _MASK32))


def philox_keys(seed: torch.Tensor, n: int, stream: int = 0) -> torch.Tensor:
    """n 62-bit keys (int64, (n,)) derived from ``seed`` for ``stream``:
    words 0 and 1 of Philox at counters (0..n-1, stream)."""
    w0, w1, _, _ = _philox_words(seed, n, stream)
    return w0 | ((w1 & 0x3FFFFFFF) << 32)


def philox_normal(key: torch.Tensor, n: int, c2: int = 0,
                  c3: int = 0) -> torch.Tensor:
    """n standard normals (float32, (n,)) by Box-Muller from Philox words 0
    and 1 at counters (0..ceil(n/2)-1, c2, c3): u1 in (0, 1] and u2 in
    [0, 1) from the top 24 bits, r cos(2 pi u2) and r sin(2 pi u2)."""
    w0, w1, _, _ = _philox_words(key, (n + 1) // 2, c2, c3)
    u1 = ((w0 >> 8) + 1).to(torch.float32) * (1.0 / 16777216.0)
    theta = (2.0 * math.pi) * bits_to_uniform(w1)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)],
                       1).reshape(-1)[:n]


def philox_randint(key: torch.Tensor, n: int, high: int) -> torch.Tensor:
    """n integers (int64, (n,)) in [0, high): Philox word 0 at counters
    0..n-1 modulo ``high``."""
    return _philox_words(key, n)[0] % high


class PhiloxNormals:
    """A noise source for the refinement steps (``sampling/refine.py``):
    each call returns normals of its argument's shape and dtype, call k
    from counters (.., stream, k) under ``key``."""

    def __init__(self, key: torch.Tensor, stream: int):
        self.key, self.stream, self.calls = key, stream, 0

    def __call__(self, like: torch.Tensor) -> torch.Tensor:
        z = philox_normal(self.key, like.numel(), self.stream, self.calls)
        self.calls += 1
        return z.reshape(like.shape).to(like.dtype)
