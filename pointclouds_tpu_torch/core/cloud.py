"""Padded fixed-shape point clouds as torch tensors.

Counterpart of `pointclouds_tpu/core/cloud.py`: points live in a padded
``f32[N, 3]`` tensor plus a ``bool[N]`` validity mask, with N drawn from
the same power-of-two bucket ladder, so both packages pad a cloud to the
same capacity with the same mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MIN_BUCKET = 8


def bucket_size(n: int) -> int:
    """Smallest power-of-two capacity >= n (minimum MIN_BUCKET)."""
    if n <= MIN_BUCKET:
        return MIN_BUCKET
    return 1 << (n - 1).bit_length()


class CloudTensors(NamedTuple):
    xyz: torch.Tensor  # f32[N, 3]
    valid: torch.Tensor  # bool[N]


def make_cloud_arrays(xyz, device=None, capacity: int | None = None
                      ) -> CloudTensors:
    """Pad a host ``[n, 3]`` array up to its bucket capacity and move it to
    ``device`` (default: the CPU)."""
    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    cap = bucket_size(n) if capacity is None else capacity
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} points")
    out = np.zeros((cap, 3), np.float32)
    out[:n] = xyz
    valid = np.zeros((cap,), bool)
    valid[:n] = True
    return CloudTensors(
        xyz=torch.from_numpy(out).to(device),
        valid=torch.from_numpy(valid).to(device),
    )


def stable_argsort(key: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort (the port's `jax.lax.sort(..., is_stable=True)`
    with the payloads gathered by the returned permutation)."""
    return torch.sort(key, stable=True).indices


def compaction_order(valid: torch.Tensor) -> torch.Tensor:
    """Permutation placing valid rows first, preserving relative order."""
    return stable_argsort((~valid).to(torch.int32))
