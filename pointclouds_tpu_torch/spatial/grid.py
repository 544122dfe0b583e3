"""Cell coordinates of the grid-hash index (`pointclouds_tpu/spatial/grid.py`)."""

from __future__ import annotations

import torch

BIAS = 1 << 20


def scalar_like(value, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``value`` as a 0-d tensor on ``like``'s device. Dividing by a tensor
    (not a Python number) keeps division IEEE-exact on CUDA, where a host
    scalar divisor is applied as a multiply by its reciprocal."""
    return torch.as_tensor(value, dtype=dtype, device=like.device)


def cell_coords(xyz: torch.Tensor, cell_size) -> torch.Tensor:
    """floor(p / cell) as int32, clamped to the packable range."""
    c = torch.floor(xyz / scalar_like(cell_size, xyz))
    c = torch.clamp(c, float(-BIAS), float(BIAS - 1))
    return c.to(torch.int32)
