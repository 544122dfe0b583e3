"""RANSAC ground-plane fit: the counterpart of
`pointclouds_tpu/ops/segmentation.py::ransac_plane_masked` on the KITTI
pipeline's tournament path.

Hypotheses come from the threefry port, so the same seed draws the same
three points per iteration as the JAX package; every hypothesis is scored
on an evenly spaced subsample of the valid points, the top ``rescore_top``
are rescored over the full cloud, and the first maximum wins.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.cloud import compaction_order
from ..utils.threefry import mod_u64, random_bits64


def _sample_three_distinct(seed: int, iterations: int, cnt):
    """[iterations, 3] distinct positions in [0, cnt): one threefry draw,
    then shrinking-range modulo and shifts past the chosen values."""
    cnt = torch.clamp(torch.as_tensor(cnt).to(torch.int64), min=3)
    hi, lo = random_bits64(seed, (3, iterations), device=cnt.device)
    a = mod_u64(hi[0], lo[0], cnt)
    b = mod_u64(hi[1], lo[1], cnt - 1)
    b = b + (b >= a)
    lo_ab = torch.minimum(a, b)
    hi_ab = torch.maximum(a, b)
    c = mod_u64(hi[2], lo[2], cnt - 2)
    c = c + (c >= lo_ab)
    c = c + (c >= hi_ab)
    return torch.stack([a, b, c], dim=1)


def _inlier_counts(xyz, use_pt, normal, d, threshold):
    """Inliers of each hypothesis (columns of ``normal``/``d``): a plain f32
    matrix product, TF32 off (TF32 keeps ~3 digits: centimetres at 10 m)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dist = torch.abs(xyz @ normal.T + d[None, :])
    return (use_pt[:, None] & (dist <= threshold)).sum(dim=0)


def ransac_plane_masked(xyz, valid, threshold, seed, iterations: int, *,
                        score_subsample: int | None = None,
                        rescore_top: int = 8, position_rows=None):
    """Batched RANSAC plane fit on a masked cloud with tournament scoring.

    Returns (normal f32[3], d f32, inlier_mask bool[N]); fewer than 3 valid
    points give normal (0, 0, 1), d = 0 and no inliers. ``position_rows``
    maps sample position p to the row holding the p-th valid point (default:
    the stable compaction order). ``threshold`` is taken as float32."""
    if score_subsample is None or iterations <= rescore_top:
        raise NotImplementedError(
            "ransac_plane_masked: full scoring needs the ransac_score_counts "
            "kernel and _ransac_sequential_scan, the next slice "
            "(ROADMAP.md, queue 2 item 5); pass score_subsample")
    threshold = float(np.float32(threshold))
    dev = xyz.device
    cnt = valid.sum()
    samples = _sample_three_distinct(seed, iterations, cnt)
    order = (compaction_order(valid) if position_rows is None
             else position_rows.long())
    idx = order[samples.reshape(-1)]
    p = xyz[idx].reshape(iterations, 3, 3)

    v1 = p[:, 1] - p[:, 0]
    v2 = p[:, 2] - p[:, 0]
    nrm = torch.stack([
        v1[:, 1] * v2[:, 2] - v1[:, 2] * v2[:, 1],
        v1[:, 2] * v2[:, 0] - v1[:, 0] * v2[:, 2],
        v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0],
    ], dim=1)
    length = torch.sqrt(nrm[:, 0] * nrm[:, 0] + nrm[:, 1] * nrm[:, 1]
                        + nrm[:, 2] * nrm[:, 2])
    degenerate = length < 1e-10
    safe_len = torch.where(degenerate, 1.0, length)
    normal = nrm / safe_len[:, None]
    q = normal * p[:, 0]
    d = -(q[:, 0] + q[:, 1] + q[:, 2])

    use_pt = valid & torch.isfinite(xyz).all(dim=-1)
    m = score_subsample
    ar = torch.arange(m, dtype=torch.int64, device=dev)
    pos = ar * (cnt // m) + (ar * (cnt % m)) // m
    distinct = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          pos[1:] != pos[:-1]])
    sub_rows = order[pos]
    sub_use = use_pt[sub_rows] & distinct
    sub_counts = _inlier_counts(xyz[sub_rows], sub_use, normal, d, threshold)
    sub_counts = torch.where(degenerate, -1, sub_counts)
    # Leaders, ties toward the EARLIER hypothesis (first-max reduce).
    ii = torch.arange(iterations, dtype=torch.int64, device=dev)
    top_idx = torch.topk(sub_counts * iterations + (iterations - 1 - ii),
                         rescore_top).indices
    full_counts = _inlier_counts(xyz, use_pt, normal[top_idx], d[top_idx],
                                 threshold)
    full_counts = torch.where(degenerate[top_idx], -1, full_counts)
    mx = full_counts.max()
    best = torch.where(full_counts == mx, top_idx, iterations).min()

    ok_model = (mx > 0) & (cnt >= 3)
    best_c = torch.clamp(best, max=iterations - 1)
    best_normal = torch.where(ok_model, normal[best_c],
                              torch.tensor([0.0, 0.0, 1.0], device=dev))
    best_d = torch.where(ok_model, d[best_c], 0.0)
    # The reference evaluates the final inlier test in float64 (its model
    # normal is promoted there); so does the port.
    x64, n64 = xyz.to(torch.float64), best_normal.to(torch.float64)
    dist = torch.abs(x64[:, 0] * n64[0] + x64[:, 1] * n64[1]
                     + x64[:, 2] * n64[2] + best_d.to(torch.float64))
    inlier_mask = valid & (dist <= threshold) & (cnt >= 3)
    return best_normal, best_d, inlier_mask
