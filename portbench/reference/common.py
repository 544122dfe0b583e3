"""The judging steps the KITTI and the aerial references share: the voxel
set and its centroids, the ground plane and its inliers, the obstacle
slots, the cluster partition and the overflow flags.

The voxel step (and the KITTI SOR step) works from the frame's points
alone. The steps after it follow the judged side's own state (its
centroids, its cleaned set, its plane, its obstacle slots): each of those
states is judged by a step of its own, and each rests on decisions at a
threshold that float32 and float64 may take either way, one of which
reorders every RANSAC sample after it. Where such a decision is compared
directly, decisions within a narrow band of the threshold go either way.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry as geo

F64 = torch.float64


def positional(cfg) -> dict:
    """The configuration's positional pipeline arguments by name."""
    return {name: value for name, value in cfg["args"]}


# Decisions at a threshold that float32 and float64 may take either way:
# a keep decision whose reference mean lies within this share of the SOR
# threshold, a pair whose reference distance lies within this share of the
# cluster radius (squared).
SOR_BAND = 1e-4
RADIUS_BAND = 1e-5


class Voxels:
    """The reference's voxels of a frame, and the judged voxel rows matched
    to them by key."""

    def __init__(self, xyz32, out, voxel: float, ds_cap: int,
                 ds_overflow: bool):
        self.keys, self.cent = geo.voxel_centroids(xyz32, voxel, F64)
        valid = out["downsampled_valid"]
        self.rows = valid.nonzero().flatten()
        cen = out["centroids"][self.rows]
        self.row_keys = geo.voxel_keys(cen.to(torch.float32), voxel, F64)
        self.pos = pos = torch.searchsorted(self.keys, self.row_keys).clamp(
            max=self.keys.numel() - 1)
        self.hit = self.keys[pos] == self.row_keys
        mismatch = int((~self.hit).sum()) + (
            self.row_keys.numel() - torch.unique(self.row_keys).numel())
        over = self.keys.numel() > ds_cap
        if not over:
            mismatch += self.keys.numel() - torch.unique(pos[self.hit]).numel()
        mismatch += int(bool(ds_overflow) != over)
        gap = (cen[self.hit].to(F64) - self.cent[pos[self.hit]]).norm(dim=1)
        self.numbers = {
            "voxel_mismatch": mismatch,
            "centroid_gap_m": (float(gap.max()) if gap.numel()
                               else float("inf")),
        }

    def key_of_rows(self, n: int):
        """int64[n]: each judged row's voxel key (invalid rows last)."""
        k = torch.full((n,), torch.iinfo(torch.int64).max,
                       dtype=torch.int64, device=self.keys.device)
        k[self.rows] = self.row_keys
        return k


def plane_numbers(c64, cl_rows, order_rows, out, cfg, seed: int):
    """The plane check: the reference's tournament, replayed from the seed
    over the judged side's cleaned points in its sample order
    (``order_rows``), against the judged plane: the largest difference of
    the two planes' signed distances over those points, in metres. Then
    the judged inlier mask against the judged plane, in float64."""
    a, kw = positional(cfg), cfg["kwargs"]
    thr = float(np.float32(a["ransac_thresh"]))
    n_r, d_r = geo.ransac_tournament(c64[order_rows], int(seed),
                                     kw["ransac_iters"], thr,
                                     kw["ransac_subsample"])
    n_p = out["plane_normal"].to(F64)
    d_p = out["plane_d"].to(F64)
    pts = c64[cl_rows]
    dp = (pts @ n_p + d_p)
    dr = (pts @ n_r + d_r)
    gap = min(float((dp - dr).abs().max()), float((dp + dr).abs().max()))
    cleaned = torch.zeros_like(out["inlier_mask"])
    cleaned[cl_rows] = True
    dist = geo.plane_distances(c64, n_p[:, None], d_p)[:, 0]
    expect = cleaned & (dist <= thr) & (cl_rows.numel() >= 3)
    return {
        "plane_gap_m": gap if pts.shape[0] else 0.0,
        "inlier_flips": int((expect != out["inlier_mask"]).sum()),
    }


def obstacle_numbers(c64, ob_rows_in_order, out, cfg):
    """The judged obstacle slots (and overflow flag) against the obstacle
    rows in the pipeline's order, cut to the cap; then its cluster labels
    over those slots against the components within ``cluster_r``."""
    a, kw = positional(cfg), cfg["kwargs"]
    cap = kw["obstacle_cap"]
    expect = ob_rows_in_order[:cap]
    got = out["obstacle_src"][out["obstacle_valid"]].to(torch.int64)
    if got.numel() == expect.numel():
        wrong = int((got != expect).sum())
    else:
        wrong = max(got.numel(), expect.numel())
    overflow = bool(out["obstacle_overflow"])
    wrong += int(overflow != (ob_rows_in_order.numel() > cap))
    slots = out["obstacle_valid"].nonzero().flatten()
    pts = c64[out["obstacle_src"][slots].long()]
    r32 = float(np.float32(a["cluster_r"]))
    gap = geo.partition_gap(out["labels"][slots].to(torch.int64), pts,
                            r32 * r32, RADIUS_BAND)
    return {"obstacle_mismatch": wrong, "cluster_gap": gap}


# ── The reference in the program's place (the control) ─────────────────────


def padded(rows_values, length: int, fill=0):
    """``rows_values`` [V, ...] in the leading rows of a [length, ...]
    tensor filled with ``fill``."""
    shape = (length, *rows_values.shape[1:])
    out = torch.full(shape, fill, dtype=rows_values.dtype,
                     device=rows_values.device)
    n = min(length, rows_values.shape[0])
    out[:n] = rows_values[:n]
    return out


def run_tail(cen, cleaned, cl_order, cfg, seed: int, dtype, ob_key):
    """Plane, inliers, obstacles and clusters of the reference pipeline, in
    ``dtype``: ``cen`` [N, 3] centroids (dtype), ``cleaned`` bool[N],
    ``cl_order`` the cleaned rows in sample order, ``ob_key`` the key the
    obstacle rows are ordered by."""
    a, kw = positional(cfg), cfg["kwargs"]
    dev = cen.device
    thr = float(np.float32(a["ransac_thresh"]))
    n, d = geo.ransac_tournament(cen[cl_order], int(seed), kw["ransac_iters"],
                                 thr, kw["ransac_subsample"])
    dist = geo.plane_distances(cen, n[:, None], d)[:, 0]
    inl = cleaned & (dist <= thr) & (int(cleaned.sum()) >= 3)
    obst = cleaned & ~inl
    rows = obst.nonzero().flatten()
    rows = rows[torch.argsort(ob_key[rows], stable=True)]
    cap = kw["obstacle_cap"]
    src = padded(rows, cap)
    ovalid = torch.arange(cap, device=dev) < min(rows.numel(), cap)
    pts = cen[src[ovalid]]
    r32 = float(np.float32(a["cluster_r"]))
    lab = geo.components(pts.shape[0],
                         geo.radius_pairs(pts, r32 * r32)[0])
    labels = torch.arange(cap, dtype=torch.int32, device=dev)
    labels[ovalid] = lab.to(torch.int32)
    return dict(plane_normal=n.to(torch.float32), plane_d=d.to(torch.float32),
                inlier_mask=inl, obstacle_src=src.to(torch.int32),
                obstacle_valid=ovalid, labels=labels,
                obstacle_overflow=torch.tensor(rows.numel() > cap,
                                               device=dev))
