"""Frozen copy of the port's Threefry-2x32 bits
(`pointclouds_tpu_torch/utils/threefry.py`): the reference replays the
RANSAC hypothesis stream from it, so the plane it works out is drawn from
the same seed as the program's.
`portbench/tests/test_portbench_copies.py` checks that the copy still gives
the original's bits.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2)
    under the key (k1, k2); int64 tensors holding uint32 values."""
    ks = (k1 & _MASK, k2 & _MASK, (k1 ^ k2 ^ 0x1BD11BDA) & _MASK)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a non-negative int32 seed."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed must be a non-negative int32, got {seed}")
    return (seed >> 32) & _MASK, seed & _MASK


def random_bits64(seed: int, shape, device=None):
    """``jax.random.bits(jax.random.PRNGKey(seed), shape)`` under 64-bit
    mode (the JAX package enables x64, so its bits are uint64): returns the
    (high, low) 32-bit words as int64 tensors of ``shape``."""
    k1, k2 = prng_key(seed)
    n = math.prod(shape)
    # Partitionable counters: the flat iota split into hi/lo 32-bit words.
    iota = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, iota >> 32, iota & _MASK)
    return b1.reshape(shape), b2.reshape(shape)


def mod_u64(hi: torch.Tensor, lo: torch.Tensor, m) -> torch.Tensor:
    """(hi * 2^32 + lo) mod m for 0 < m < 2^31, exact in int64."""
    m = torch.as_tensor(m, dtype=torch.int64, device=hi.device)
    return ((hi % m) * ((1 << 32) % m) + lo % m) % m
