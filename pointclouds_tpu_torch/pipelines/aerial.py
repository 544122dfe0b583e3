"""Aerial LiDAR on torch tensors: voxel downsample -> kNN-moment normals ->
RANSAC ground plane -> ground removal -> euclidean clustering.

Counterpart of `pointclouds_tpu/pipelines/aerial.py` (its sweep backend).
Same positional arguments, keyword names and defaults; scalar arguments
are taken as float32, as the JAX pipeline receives them. Runs on the device
of ``xyz``: CUDA tensors go through the hand-written kernels, CPU tensors
through their plain torch versions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.cloud import compaction_order
from ..ops.filters import voxel_downsample_masked, voxel_downsample_sweep_fused
from ..ops.normals import normals_from_moment_rows
from ..ops.segmentation import ransac_plane_masked
from ..spatial.grid import scalar_like
from ..spatial.sweep import (
    structure_from_sorted,
    sweep_cluster_labels,
    sweep_knn_moments_rows,
    sweep_moments_two_pass_rows,
)


class AerialPipelineOutput(NamedTuple):
    centroids: torch.Tensor  # f32[N, 3] voxel centroids (padded)
    downsampled_valid: torch.Tensor  # bool[N]
    normals: torch.Tensor  # f32[N, 3] per-centroid PCA normals
    normals_ok: torch.Tensor  # bool[N] moments certified exact
    plane_normal: torch.Tensor  # f32[3]
    plane_d: torch.Tensor  # f32
    inlier_mask: torch.Tensor  # bool[N]
    obstacle_src: torch.Tensor  # i32[CAP]
    obstacle_valid: torch.Tensor  # bool[CAP]
    labels: torch.Tensor  # i32[CAP]
    obstacle_overflow: torch.Tensor  # bool
    cluster_exact: torch.Tensor  # bool
    ds_overflow: torch.Tensor  # bool


def aerial_pipeline(
    xyz,
    valid,
    voxel_size,
    normals_cell,
    ransac_thresh,
    seed,
    cluster_r,
    viewpoint,
    *,
    normals_k: int = 15,
    ransac_iters: int = 300,
    obstacle_cap: int = 262_144,
    cluster_wr: int = 12,
    backend: str = "auto",
    ds_cap: int | None = None,
    normals_rescue: bool = False,
    normals_fix_cap: int = 16384,
    ransac_subsample: int | None = None,
    normals_cell_factor: int | None = None,
    cluster_sweeps: int = 12,
):
    """Voxel -> sweep normals -> RANSAC -> ground removal -> sweep cluster,
    on ``xyz`` f32[N, 3] / ``valid`` bool[N].

    ``normals_cell`` is the kNN certification radius of the normals sweep
    (ignored when ``normals_cell_factor`` gives it as a whole number of
    voxels: the voxel output is then emitted in sweep order and the
    moments sweep reuses that sort). ``normals_rescue`` re-resolves the
    uncertified rows by the exact pruned rescue. ``backend`` is dispatched
    as the JAX package's: "auto", "sweep" and "sweep_xla" run as one (the
    port has no kernel/XLA-mirror split: tensors on the card run the
    kernels, CPU tensors their plain versions) and may take the fused
    voxel front end; any other string takes the plain voxel front end.
    """
    fused_front = backend in ("auto", "sweep", "sweep_xla")
    voxel = scalar_like(np.float32(voxel_size), xyz)
    if ds_cap is None:
        ds_cap = xyz.shape[0]
    ds_cap = min(ds_cap, xyz.shape[0])

    # ── Step 1: voxel downsample ──
    prebuilt = None
    if (fused_front and normals_cell_factor is not None
            and not normals_rescue and ds_cap % 128 == 0):
        fe = voxel_downsample_sweep_fused(xyz, valid, voxel,
                                          factor=normals_cell_factor,
                                          ds_cap=ds_cap)
        centroids, ds_valid = fe["centroids"], fe["out_valid"]
        ds_overflow = fe["ds_overflow"]
        prebuilt = structure_from_sorted(
            centroids, ds_valid, fe["slin"], fe["extent"], fe["hi_cells"],
            fe["table_overflow"], wr=4)
        cell = voxel * float(normals_cell_factor)
    else:
        centroids_full, ds_valid_full = voxel_downsample_masked(xyz, valid,
                                                                voxel)
        centroids = centroids_full[:ds_cap]
        ds_valid = ds_valid_full[:ds_cap]
        ds_overflow = ds_valid_full[ds_cap:].any()
        cell = scalar_like(np.float32(normals_cell), xyz)

    # ── Step 2: PCA normals from kNN moments, in row layout ──
    if normals_rescue:
        m1r, m2r, cnt, nok = sweep_moments_two_pass_rows(
            centroids, ds_valid, cell, k=normals_k, fix_cap=normals_fix_cap)
    else:
        m1r, m2r, cnt, nok = sweep_knn_moments_rows(
            centroids, ds_valid, cell, k=normals_k, prebuilt=prebuilt)
    normals = normals_from_moment_rows(m1r, m2r, cnt, centroids, viewpoint)

    # ── Step 3: RANSAC ground plane (voxel rows are leading-compact) ──
    pnormal, d, inlier_mask = ransac_plane_masked(
        centroids, ds_valid, ransac_thresh, int(seed), ransac_iters,
        assume_compact=True, score_subsample=ransac_subsample,
        adaptive=(ransac_subsample is None))

    # ── Step 4+5: ground removal + clustering over the nine windows ──
    obstacle_mask = ds_valid & ~inlier_mask
    order = compaction_order(obstacle_mask)
    obs_src = order[:obstacle_cap]
    obs_valid = obstacle_mask[obs_src]
    obs_xyz = centroids[obs_src]
    overflow = obstacle_mask.sum() > obstacle_cap
    labels, cluster_exact = sweep_cluster_labels(
        obs_xyz, obs_valid, np.float32(cluster_r), wr=cluster_wr,
        rep_labels=False, row_cap=None, sweeps=cluster_sweeps)

    return AerialPipelineOutput(
        centroids=centroids,
        downsampled_valid=ds_valid,
        normals=normals,
        normals_ok=nok,
        plane_normal=pnormal,
        plane_d=d,
        inlier_mask=inlier_mask,
        obstacle_src=obs_src.to(torch.int32),
        obstacle_valid=obs_valid,
        labels=labels,
        obstacle_overflow=overflow,
        cluster_exact=cluster_exact,
        ds_overflow=ds_overflow,
    )


def extract_clusters(out: AerialPipelineOutput, min_size: int,
                     max_size: int):
    """Host-side cluster extraction, canonical ordering (size desc,
    lexicographic tiebreak); members are obstacle slot indices."""
    labels = out.labels.cpu().numpy()
    obs_valid = out.obstacle_valid.cpu().numpy()
    valid_slots = np.nonzero(obs_valid)[0]
    lab = labels[valid_slots]
    order = np.argsort(lab, kind="stable")
    sl = lab[order]
    boundaries = np.nonzero(np.concatenate([[True], sl[1:] != sl[:-1]]))[0]
    clusters = []
    for i, b in enumerate(boundaries):
        e = boundaries[i + 1] if i + 1 < len(boundaries) else len(sl)
        members = valid_slots[order[b:e]]
        if min_size <= len(members) <= max_size:
            clusters.append(sorted(int(m) for m in members))
    clusters.sort(key=lambda c: (-len(c), c))
    return clusters
