"""Reference of `aerial_pipeline` with the fused voxel->sweep front end and
the RANSAC tournament: voxel centroids, PCA normals of the k nearest
(self included) facing the viewpoint, the ground plane over the leading
valid rows, the obstacles in row order, and their clusters.

`judge` compares a pipeline output with the reference in float64 and
returns the numbers `correct` is decided on; `run` computes the whole
pipeline as the reference does, in a given dtype, in the program's output
format (the control, in bfloat16).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import common
from . import geometry as geo

F64 = torch.float64
# The normals neighbour search's grid cell, in voxels.
NORMALS_CELL_VOXELS = 3
# Rows compared: the middle eigenvalue at least this many times the
# smallest, so that the normal is defined to well within the angle below.
CONDITION = 4.0
ANGLE_RAD = math.radians(1.0)


def normals(cen, k: int, voxel: float, viewpoint):
    """Unit normals of the k nearest rows' covariance (self included),
    facing ``viewpoint``; with whether the k-th neighbour is tie-free and
    the covariance's middle-to-smallest eigenvalue ratio."""
    d2, idx = geo.knn(cen, k + 1, NORMALS_CELL_VOXELS * voxel)
    tie_free = d2[:, k - 1] < d2[:, k]
    nb = cen[idx[:, :k].clamp(min=0)]
    use = (idx[:, :k] >= 0)[:, :, None]
    cnt = use.sum(1).clamp(min=1)
    mu = torch.where(use, nb, 0.0).sum(1) / cnt
    dd = torch.where(use, nb - mu[:, None, :], 0.0)
    cov = torch.einsum("nki,nkj->nij", dd, dd)
    solve = F64 if cen.dtype == F64 else torch.float32
    vec, ratio = geo.smallest_eigvec(cov.to(solve))
    vec = vec.to(cen.dtype)
    vp = torch.as_tensor(viewpoint, dtype=cen.dtype, device=cen.device)
    flip = ((vp - cen) * vec).sum(1) < 0
    return torch.where(flip[:, None], -vec, vec), tie_free, ratio


def judge(xyz32, out, cfg, seed: int) -> dict:
    a, kw = common.positional(cfg), cfg["kwargs"]
    voxel = float(np.float32(a["voxel_size"]))
    vox = common.Voxels(xyz32, out, voxel, kw["ds_cap"],
                        bool(out["ds_overflow"]))
    numbers = dict(vox.numbers)
    rows = vox.rows
    c64 = out["centroids"].to(F64)

    ref, tie_free, ratio = normals(c64[rows], kw["normals_k"], voxel,
                                   a["viewpoint"])
    got = out["normals"][rows].to(F64)
    cos = (got * ref).sum(1).abs().clamp(max=1.0)
    # Rows whose normal the reference defines: a tie-free k-th neighbour,
    # a well-conditioned covariance. Those the program certifies are
    # compared; the share it leaves uncertified is held to a limit.
    defined = tie_free & (ratio >= CONDITION)
    ok = out["normals_ok"][rows]
    cmp = ok & defined
    off = (torch.arccos(cos) > ANGLE_RAD) & cmp
    numbers["normals_off_pct"] = 100.0 * int(off.sum()) / max(int(cmp.sum()),
                                                             1)
    numbers["normals_uncertified_pct"] = 100.0 * int(
        (defined & ~ok).sum()) / max(int(defined.sum()), 1)
    # The reference's partition is exact, as the clustering's flag has to
    # say.
    numbers["flag_mismatch"] = int(not bool(out["cluster_exact"]))

    valid = out["downsampled_valid"]
    # The tournament samples positions among the leading valid rows.
    numbers.update(common.plane_numbers(c64, rows, rows, out, cfg, seed))
    obst = (valid & ~out["inlier_mask"]).nonzero().flatten()
    numbers.update(common.obstacle_numbers(c64, obst, out, cfg))
    return numbers


def run(xyz32, cfg, seed: int, dtype) -> dict:
    a, kw = common.positional(cfg), cfg["kwargs"]
    voxel = float(np.float32(a["voxel_size"]))
    keys, cen = geo.voxel_centroids(xyz32, voxel, dtype)
    cap = min(kw["ds_cap"], xyz32.shape[0])
    dev = xyz32.device
    v = min(keys.numel(), cap)
    valid = torch.arange(cap, device=dev) < v
    cen = common.padded(cen, cap)
    nrm = torch.zeros((cap, 3), dtype=dtype, device=dev)
    nrm[:, 2] = 1.0
    nrm[:v] = normals(cen[:v], kw["normals_k"], voxel, a["viewpoint"])[0]
    rank = torch.arange(cap, device=dev)
    tail = common.run_tail(cen, valid, valid.nonzero().flatten(), cfg, seed,
                           dtype, rank)
    return dict(centroids=cen.to(torch.float32), downsampled_valid=valid,
                normals=nrm.to(torch.float32), normals_ok=valid.clone(),
                cluster_exact=torch.tensor(True, device=dev),
                ds_overflow=torch.tensor(keys.numel() > cap, device=dev),
                **tail)
