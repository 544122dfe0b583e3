"""Registration helpers: the counterpart of the part of
`pointclouds_tpu/ops/registration.py` the ported paths use (the planar
packing of a cloud for the kernels)."""

from __future__ import annotations

import torch


def _to_planar(xyz, use):
    """Pack [N, 3] + validity into the kernels' [NR, 4, 128] planar layout
    (channels x/y/z/w, w = 0/1 validity; tail padded with w = 0)."""
    n = xyz.shape[0]
    nr = max(-(-n // 128), 1)
    pad = nr * 128 - n
    x = torch.cat([xyz, torch.zeros((pad, 3), dtype=xyz.dtype,
                                    device=xyz.device)])
    w = torch.cat([use.to(torch.float32),
                   torch.zeros(pad, dtype=torch.float32, device=xyz.device)])
    arr = torch.cat([x, w[:, None]], dim=1)  # [nr*128, 4]
    return arr.reshape(nr, 128, 4).permute(0, 2, 1).contiguous()
