"""Reference of `kitti_obstacle_pipeline` with the sweep SOR backend and the
RANSAC tournament: voxel centroids, SOR over the k nearest, the ground
plane, the obstacles in canonical voxel order, and their clusters.

`judge` compares a pipeline output with the reference in float64 and
returns the numbers `correct` is decided on; `run` computes the whole
pipeline as the reference does, in a given dtype, in the program's output
format: run in bfloat16 it is the control that the comparison has to
refuse.
"""

from __future__ import annotations

import numpy as np
import torch

from . import common
from . import geometry as geo

F64 = torch.float64
# The SOR neighbour search's grid cell, in voxels: at 0.15 m voxels its
# 0.6 m reach holds the 21 nearest of almost every ground row.
SOR_CELL_VOXELS = 4


def sor_means(cen, k: int, voxel: float):
    """Mean distance of each row to its k nearest other rows."""
    d2, idx = geo.knn(cen, k + 1, SOR_CELL_VOXELS * voxel)
    own = idx == torch.arange(cen.shape[0], device=cen.device)[:, None]
    dist = torch.where(own, torch.inf, torch.sqrt(d2))
    dist = torch.sort(dist, dim=1).values[:, :k]
    found = torch.isfinite(dist)
    total = torch.where(found, dist, 0.0).sum(1)
    count = found.sum(1)
    return torch.where(count > 0, total / count.clamp(min=1), torch.inf)


def sor_threshold(means, std_mul: float):
    """The mean plus ``std_mul`` population deviations of the finite
    means: rows at or under it are kept."""
    m = means[torch.isfinite(means)]
    return m.mean() + std_mul * torch.sqrt(((m - m.mean()) ** 2).mean())


def judge(xyz32, out, cfg, seed: int) -> dict:
    a, kw = common.positional(cfg), cfg["kwargs"]
    voxel = float(np.float32(a["voxel_size"]))
    vox = common.Voxels(xyz32, out, voxel, kw["ds_cap"],
                        bool(out["grid_flags"][4]))
    numbers = dict(vox.numbers)
    c64 = out["centroids"].to(F64)

    # SOR on the reference's own centroids; the kept voxels as sets of
    # keys, leaving out those the reference decides within the band.
    means = sor_means(vox.cent, kw["sor_k"], voxel)
    thr = sor_threshold(means, float(np.float32(a["sor_std"])))
    near = vox.keys[(means - thr).abs() <= common.SOR_BAND * thr]
    ref_kept = vox.keys[means <= thr]
    cleaned = out["cleaned_valid"]
    key_of_row = vox.key_of_rows(c64.shape[0])
    kept = key_of_row[cleaned & out["downsampled_valid"]]
    extra = kept[~torch.isin(kept, ref_kept) & ~torch.isin(kept, near)]
    lost = ref_kept[~torch.isin(ref_kept, kept) & ~torch.isin(ref_kept, near)]
    flips = (extra.numel() + lost.numel()
             + int((cleaned & ~out["downsampled_valid"]).sum()))
    # A frame the program certifies has each keep decision certified
    # against its own threshold, into which rows out of the rescue's reach
    # enter by their bounds: that threshold moves by ~2e-4 of itself, and a
    # row between it and the exact one may flip. A frame it flags may
    # differ more. Each is held to a limit of its own.
    certified = bool(out["sor_certified"])
    numbers["sor_flips_certified"] = flips if certified else 0
    numbers["sor_flips_flagged"] = 0 if certified else flips
    # The sweep path builds no cell grid, so its overflow flags (0, 1, 3)
    # have no cause, and the reference's partition is exact, as flag 2
    # (clustering not exact) has to say.
    numbers["flag_mismatch"] = int(out["grid_flags"][:4].sum())

    cl_rows = cleaned.nonzero().flatten()
    canon = cl_rows[torch.argsort(key_of_row[cl_rows], stable=True)]
    numbers.update(common.plane_numbers(c64, cl_rows, canon, out, cfg, seed))
    obst = (cleaned & ~out["inlier_mask"]).nonzero().flatten()
    obst = obst[torch.argsort(key_of_row[obst], stable=True)]
    numbers.update(common.obstacle_numbers(c64, obst, out, cfg))
    return numbers


def run(xyz32, cfg, seed: int, dtype) -> dict:
    a, kw = common.positional(cfg), cfg["kwargs"]
    voxel = float(np.float32(a["voxel_size"]))
    keys, cen = geo.voxel_centroids(xyz32, voxel, dtype)
    cap = kw["ds_cap"]
    dev = xyz32.device
    v = min(keys.numel(), cap)
    valid = torch.arange(cap, device=dev) < v
    cen = common.padded(cen, cap)
    means = torch.full((cap,), torch.inf, dtype=dtype, device=dev)
    means[:v] = sor_means(cen[:v], kw["sor_k"], voxel)
    cleaned = valid & (means <= sor_threshold(
        means, float(np.float32(a["sor_std"]))))
    rank = torch.arange(cap, device=dev)  # rows are in canonical order
    tail = common.run_tail(cen, cleaned, cleaned.nonzero().flatten(), cfg,
                           seed, dtype, rank)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    flags = torch.stack([false, false, false, false,
                         torch.tensor(keys.numel() > cap, device=dev)])
    return dict(centroids=cen.to(torch.float32), downsampled_valid=valid,
                cleaned_valid=cleaned, grid_flags=flags,
                sor_certified=~false, **tail)
