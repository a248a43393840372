"""Seeded torch.Generators for the training run's random draws.

JAX derives a step's keys by folding integers into a PRNGKey
(`jax.random.fold_in`); the port folds the same integers into one 63-bit
seed (SplitMix64 steps) and seeds a `torch.Generator` with it. The draws
are not JAX's bits, only a function of the same integers: a run resumed
at step k draws what an uninterrupted one draws there, and every
data-parallel rank draws alike.
"""

from __future__ import annotations

import zlib

import torch

_MASK = (1 << 64) - 1


def _mix(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def fold_seed(*parts) -> int:
    """One 63-bit seed from integers and strings (a string by its CRC-32),
    in order: fold_seed(a, b) != fold_seed(b, a)."""
    z = 0
    for p in parts:
        if isinstance(p, str):
            p = zlib.crc32(p.encode())
        z = _mix(z ^ (int(p) & _MASK))
    return z >> 1


def generator(*parts, device: str | torch.device = "cpu") -> torch.Generator:
    """A torch.Generator on `device` seeded with fold_seed(*parts)."""
    g = torch.Generator(device=device)
    g.manual_seed(fold_seed(*parts))
    return g
