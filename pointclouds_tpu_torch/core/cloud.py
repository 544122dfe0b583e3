"""Padded fixed-shape point clouds as torch tensors.

Counterpart of `pointclouds_tpu/core/cloud.py`: points live in a padded
``f32[N, 3]`` tensor plus a ``bool[N]`` validity mask, with N drawn from
the same power-of-two bucket ladder, so both packages pad a cloud to the
same capacity with the same mask. Optional normals, colours and intensity
ride along as the JAX package's ``CloudArrays`` fields do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

MIN_BUCKET = 8
# Where clouds are made unless the caller names a device: the card. A
# machine without one raises rather than running on the CPU.
DEFAULT_DEVICE = "cuda"


def bucket_size(n: int) -> int:
    """Smallest power-of-two capacity >= n (minimum MIN_BUCKET)."""
    if n <= MIN_BUCKET:
        return MIN_BUCKET
    return 1 << (n - 1).bit_length()


class CloudTensors(NamedTuple):
    xyz: torch.Tensor  # f32[N, 3]
    valid: torch.Tensor  # bool[N]
    normals: Optional[torch.Tensor] = None  # f32[N, 3]
    colors: Optional[torch.Tensor] = None  # uint8[N, 3]
    intensity: Optional[torch.Tensor] = None  # f32[N]

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


def make_cloud_arrays(xyz, device=None, capacity: int | None = None, *,
                      normals=None, colors=None, intensity=None
                      ) -> CloudTensors:
    """Pad host arrays up to their bucket capacity and move them to
    ``device`` (default: `DEFAULT_DEVICE`, the card)."""
    device = DEFAULT_DEVICE if device is None else device
    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    cap = bucket_size(n) if capacity is None else capacity
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} points")

    def pad(a, dtype, width):
        out = np.zeros((cap,) + width, dtype)
        out[:n] = np.asarray(a, dtype).reshape((n,) + width)
        return torch.from_numpy(out).to(device)

    valid = np.zeros((cap,), bool)
    valid[:n] = True
    return CloudTensors(
        xyz=pad(xyz, np.float32, (3,)),
        valid=torch.from_numpy(valid).to(device),
        normals=None if normals is None else pad(normals, np.float32, (3,)),
        colors=None if colors is None else pad(colors, np.uint8, (3,)),
        intensity=None if intensity is None else pad(intensity, np.float32,
                                                     ()),
    )


def stable_argsort(key: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort (the port's `jax.lax.sort(..., is_stable=True)`
    with the payloads gathered by the returned permutation)."""
    return torch.sort(key, stable=True).indices


def compaction_order(valid: torch.Tensor) -> torch.Tensor:
    """Permutation placing valid rows first, preserving relative order."""
    return stable_argsort((~valid).to(torch.int32))


def count(arrs: CloudTensors) -> torch.Tensor:
    """Number of valid points (int64 0-d tensor)."""
    return arrs.valid.sum()


def _map_rows(arrs: CloudTensors, fn, valid) -> CloudTensors:
    """``fn`` applied to every per-row attribute, with ``valid`` as the new
    mask."""
    def opt(a):
        return None if a is None else fn(a)

    return CloudTensors(fn(arrs.xyz), valid, opt(arrs.normals),
                        opt(arrs.colors), opt(arrs.intensity))


def compact(arrs: CloudTensors) -> CloudTensors:
    """Valid rows to the front, in their order (a stable partition, as the
    JAX package's payload sort on the 0/1 key); the tail keeps the invalid
    rows in their order, masked out."""
    order = compaction_order(arrs.valid)
    return _map_rows(arrs, lambda a: a[order], arrs.valid[order])


def mask_cloud(arrs: CloudTensors, keep: torch.Tensor) -> CloudTensors:
    """Restrict validity to ``keep`` (no reordering)."""
    return arrs._replace(valid=arrs.valid & keep)


def gather_cloud(arrs: CloudTensors, indices: torch.Tensor,
                 valid: torch.Tensor) -> CloudTensors:
    """Rows by index, every attribute riding along; ``valid`` is the new
    mask (indices clipped into the capacity)."""
    idx = torch.clamp(indices.long(), 0, arrs.capacity - 1)
    return _map_rows(arrs, lambda a: a[idx], valid)


def aabb(xyz: torch.Tensor, valid: torch.Tensor):
    """Masked axis-aligned bounding box over the valid, finite points
    (non-finite points are skipped). Returns (min f32[3], max f32[3],
    is_empty bool[]); an empty box is (+inf, -inf, True)."""
    use = (valid & torch.isfinite(xyz).all(dim=-1))[:, None]
    mn = torch.where(use, xyz, torch.inf).amin(dim=0)
    mx = torch.where(use, xyz, -torch.inf).amax(dim=0)
    return mn, mx, ~use.any()


def apply_rigid(xyz: torch.Tensor, rotation: torch.Tensor,
                translation: torch.Tensor) -> torch.Tensor:
    """R @ p + t for every point, with each coordinate's dot product in
    the form XLA's CPU backend gives the JAX package's f32 ``[N, 3] x
    [3, 3]`` product, fma(z, r2, fma(y, r1, x * r0)), then + t."""
    from ..spatial.kernels import fma_f32

    x, y, z = xyz[:, 0:1], xyz[:, 1:2], xyz[:, 2:3]
    r = rotation.T  # [3 (input axis), 3 (output axis)]
    dot = fma_f32(z, r[2][None, :], fma_f32(y, r[1][None, :],
                                            x * r[0][None, :]))
    return dot + translation[None, :]
