"""The int64-keyed grid-hash index (`pointclouds_tpu/spatial/grid.py`):
cell coordinates, packed cell keys, and the points sorted by key with
their 27-cell candidate ranges found by binary search.

Points are bucketed into cubic cells and sorted by a packed 63-bit cell
key; a query gathers at most M points from each of the 27 cells around its
own, and reports whether some cell held more (``overflow``), so that the
callers (`knn.py`'s grid queries, `engine.py`) retry with a larger cap.
Unlike the sweep kernels' f32 positions, the int64 keys and positions serve
clouds of any size. All of it is torch ops on the input tensors' device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BITS = 21
BIAS = 1 << 20
# Largest int64 key: sorts after every real cell key, so invalid points land
# at the tail of the sorted order.
INVALID_KEY = (1 << 63) - 1

# The 27-cell neighbourhood's offsets, lexicographic.
NEIGHBOR_OFFSETS = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=np.int32,
)


def scalar_like(value, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``value`` as a 0-d tensor on ``like``'s device. Dividing by a tensor
    (not a Python number) keeps division IEEE-exact on CUDA, where a host
    scalar divisor is applied as a multiply by its reciprocal."""
    return torch.as_tensor(value, dtype=dtype, device=like.device)


def cell_coords(xyz: torch.Tensor, cell_size) -> torch.Tensor:
    """floor(p / cell) as int32, clamped to the packable range; NaN gives 0,
    as XLA converts it."""
    c = torch.floor(xyz / scalar_like(cell_size, xyz))
    c = torch.clamp(c, float(-BIAS), float(BIAS - 1))
    return torch.nan_to_num(c, nan=0.0).to(torch.int32)


def pack_cell_key(coords: torch.Tensor) -> torch.Tensor:
    """Pack int32[..., 3] cell coords into one int64 key whose numeric order
    is the lexicographic (ix, iy, iz) order."""
    c = coords.to(torch.int64) + BIAS
    return (c[..., 0] << (2 * BITS)) | (c[..., 1] << BITS) | c[..., 2]


class GridHash(NamedTuple):
    """Points sorted by packed cell key; invalid points sort to the tail."""

    sorted_keys: torch.Tensor  # i64[N]
    sorted_xyz: torch.Tensor  # f32[N, 3]
    sorted_idx: torch.Tensor  # i32[N] original row of each sorted point
    cell_size: torch.Tensor  # f32 0-d
    num_valid: torch.Tensor  # i32 0-d


def build_grid(xyz: torch.Tensor, valid: torch.Tensor, cell_size) -> GridHash:
    """Sort the points by cell key (stable). Non-finite points count as
    invalid."""
    use = valid & torch.isfinite(xyz).all(dim=-1)
    cell = scalar_like(cell_size, xyz)
    keys = torch.where(use, pack_cell_key(cell_coords(xyz, cell)),
                       INVALID_KEY)
    sorted_keys, order = torch.sort(keys, stable=True)
    return GridHash(sorted_keys=sorted_keys, sorted_xyz=xyz[order],
                    sorted_idx=order.to(torch.int32), cell_size=cell,
                    num_valid=use.sum().to(torch.int32))


def candidate_ranges(grid: GridHash, qxyz: torch.Tensor):
    """[Q, 27] start and end positions in the sorted arrays of each query's
    27 neighbour cells."""
    qc = cell_coords(qxyz, grid.cell_size)
    off = torch.as_tensor(NEIGHBOR_OFFSETS, device=qxyz.device)
    nkeys = pack_cell_key(qc[:, None, :] + off[None, :, :])
    starts = torch.searchsorted(grid.sorted_keys, nkeys, side="left")
    ends = torch.searchsorted(grid.sorted_keys, nkeys, side="right")
    return starts, ends


def gather_candidates(grid: GridHash, qxyz: torch.Tensor, q_use: torch.Tensor,
                      m_per_cell: int):
    """At most ``m_per_cell`` points from each of the 27 neighbour cells.

    Returns (cand_idx i32[Q, 27M] original rows, d2 f32[Q, 27M] with +inf
    where invalid, cand_valid bool[Q, 27M], overflow bool 0-d: some cell
    of a used query held more than M points). d2 is fma(dz, dz, fma(dy,
    dy, dx*dx)), the form XLA's CPU backend gives the JAX package's
    ``jnp.sum(diff * diff, -1)``."""
    from .knn import _d2_sum

    n = grid.sorted_xyz.shape[0]
    starts, ends = candidate_ranges(grid, qxyz)
    overflow = (q_use[:, None] & ((ends - starts) > m_per_cell)).any()
    idx = starts[..., None] + torch.arange(m_per_cell, device=qxyz.device)
    cand_valid = (idx < ends[..., None]).reshape(idx.shape[0], -1)
    cand_valid &= q_use[:, None]
    idx = torch.clamp(idx, 0, n - 1).reshape(idx.shape[0], -1)
    d2 = _d2_sum(grid.sorted_xyz[idx], qxyz[:, None, :])
    d2 = torch.where(cand_valid, d2, torch.inf)
    return grid.sorted_idx[idx], d2, cand_valid, overflow
