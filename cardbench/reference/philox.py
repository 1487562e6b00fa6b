"""Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding 32-bit
words, and the uniforms of the DRS accept step drawn from it: word 0 at
counter (i, 0, 0, 0) under the 64-bit key split into two words, its top 24
bits over 2**24."""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
MULTIPLIERS = (0xD2511F53, 0xCD9E8D57)
KEY_STEPS = (0x9E3779B9, 0xBB67AE85)
ROUNDS = 10


def _mul_hi_lo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of the 64-bit product of the constant a
    and b, from two 48-bit partial products (no int64 overflow)."""
    lo_part = b * (a & 0xFFFF)
    hi_part = b * (a >> 16)
    low = lo_part + ((hi_part & 0xFFFF) << 16)
    return ((hi_part >> 16) + (low >> 32)) & MASK32, low & MASK32


def philox_word0(key: int | torch.Tensor, n: int,
                 device: torch.device) -> torch.Tensor:
    """Word 0 of Philox4x32-10 at counters 0 .. n-1, as int64."""
    key = torch.as_tensor(key, dtype=torch.int64, device=device).reshape(())
    k0, k1 = key & MASK32, (key >> 32) & MASK32
    idx = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    c0, c1, c2, c3 = idx & MASK32, idx >> 32, zero, zero
    for _ in range(ROUNDS):
        hi0, lo0 = _mul_hi_lo(MULTIPLIERS[0], c0)
        hi1, lo1 = _mul_hi_lo(MULTIPLIERS[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + KEY_STEPS[0]) & MASK32
        k1 = (k1 + KEY_STEPS[1]) & MASK32
    return c0


def uniforms(key, n: int, device: torch.device) -> torch.Tensor:
    """u in [0, 1) as float32: the top 24 of 32 bits over 2**24."""
    return (philox_word0(key, n, device) >> 8).to(torch.float32) / 16777216.0
