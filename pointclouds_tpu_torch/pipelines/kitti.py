"""KITTI obstacle detection on torch tensors: voxel downsample -> SOR ->
RANSAC ground plane -> ground removal -> euclidean clustering.

Counterpart of `pointclouds_tpu/pipelines/kitti.py` (its sweep backend with
the fused voxel->sweep front end). Same positional arguments, keyword
names and defaults; scalar arguments are taken as float32, as the JAX
pipeline receives them from its callers (numpy float32). Runs on the
device of ``xyz``: CUDA tensors go through the hand-written kernels, CPU
tensors through their plain torch versions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.cloud import stable_argsort
from ..ops.filters import sor_keep_mask_thr, voxel_downsample_sweep_fused
from ..ops.segmentation import ransac_plane_masked
from ..spatial.grid import scalar_like
from ..spatial.sweep import (
    structure_from_sorted,
    sweep_cluster_labels,
    sweep_sor_two_pass,
)

_INVALID32 = 2**31 - 1


class KittiPipelineOutput(NamedTuple):
    centroids: torch.Tensor  # f32[N, 3] voxel centroids (padded)
    downsampled_valid: torch.Tensor  # bool[N]
    cleaned_valid: torch.Tensor  # bool[N] after SOR
    plane_normal: torch.Tensor  # f32[3]
    plane_d: torch.Tensor  # f32
    inlier_mask: torch.Tensor  # bool[N] ground-plane inliers (of cleaned)
    obstacle_src: torch.Tensor  # i32[CAP] rows into centroids for obstacles
    obstacle_valid: torch.Tensor  # bool[CAP]
    labels: torch.Tensor  # i32[CAP] cluster labels over obstacle slots
    obstacle_overflow: torch.Tensor  # bool: more obstacles than CAP
    sor_certified: torch.Tensor  # bool: every SOR keep decision certified
    grid_flags: torch.Tensor  # bool[5]: sor/cluster/downsample overflows


def _canonical_order(mask, canon):
    """Rows holding ``mask``-ed entries first, in canonical voxel order."""
    return stable_argsort(torch.where(mask, canon, _INVALID32))


def kitti_obstacle_pipeline(
    xyz,
    valid,
    voxel_size,
    sor_std,
    ransac_thresh,
    seed,
    cluster_r,
    *,
    sor_k: int = 20,
    ransac_iters: int = 500,
    obstacle_cap: int = 16384,
    sor_m: int = 56,
    cluster_m: int = 24,
    sor_cell_cap: int = 16384,
    cluster_cell_cap: int = 8192,
    sor_fix_cap: int = 4096,
    sor_backend: str = "auto",
    ds_cap: int | None = None,
    ransac_subsample: int | None = None,
    sor_cell_factor: float = 3.0,
    sor_per_seg: int = 2,
    cluster_wr: int = 12,
    sor_row_cap: int | None = 12,
    cluster_row_cap: int | None = 32,
    cluster_sweeps: int = 12,
):
    """The fused KITTI pipeline on ``xyz`` f32[N, 3] / ``valid`` bool[N].

    Only the sweep backend is ported: ``sor_backend`` must be "auto" or
    "sweep". ``sor_m``, ``cluster_m``, ``sor_cell_cap`` and
    ``cluster_cell_cap`` size the cell-grid backends and are unused here;
    ``sor_per_seg`` and ``cluster_sweeps`` tune the TPU kernels' lane
    certificate and sweep budget, which the exact CUDA selection and the
    converge-until-fixpoint cluster rounds do not need.
    """
    if sor_backend not in ("auto", "sweep"):
        raise NotImplementedError(
            f"sor_backend={sor_backend!r}: only the sweep backend is ported")
    if ds_cap is None:
        ds_cap = xyz.shape[0]
    if not float(sor_cell_factor).is_integer() or ds_cap % 128:
        raise NotImplementedError(
            "only the fused voxel->sweep front end is ported (integer "
            "sor_cell_factor, ds_cap % 128 == 0)")
    voxel = scalar_like(np.float32(voxel_size), xyz)
    factor = int(sor_cell_factor)

    # ── Step 1: voxel downsample, rows emitted in sweep order ──────────────
    fe = voxel_downsample_sweep_fused(xyz, valid, voxel, factor=factor,
                                      ds_cap=ds_cap)
    centroids, ds_valid, canon = fe["centroids"], fe["out_valid"], fe["canon"]
    prebuilt = structure_from_sorted(
        centroids, ds_valid, fe["slin"], fe["extent"], fe["hi_cells"],
        fe["table_overflow"], wr=4,
        grid_origin=(fe["mn_v"], float(np.float32(voxel_size)), factor),
    )

    # ── Step 2: statistical outlier removal (two-pass sweep) ──────────────
    sor_cell = voxel * sor_cell_factor
    mean_dists, point_ok, _, mean_lb = sweep_sor_two_pass(
        centroids, ds_valid, sor_cell, k=sor_k, fix_cap=sor_fix_cap,
        rescue_cells=8.0, prebuilt=prebuilt, row_cap=sor_row_cap,
    )
    cleaned_valid, sor_thr = sor_keep_mask_thr(mean_dists, ds_valid,
                                               np.float32(sor_std))
    # Keep-DECISION certificate: exact mean, or an upper bound that passes,
    # or a proven lower bound above the threshold.
    decision_ok = point_ok | cleaned_valid | (mean_lb.to(torch.float64)
                                              > sor_thr)
    sor_certified = (decision_ok | ~ds_valid).all()

    # ── Step 3: RANSAC ground plane ────────────────────────────────────────
    # Canonical mini-sort: position p -> the row holding the p-th cleaned
    # centroid in canonical voxel order (the JAX package's sample order).
    position_rows = _canonical_order(cleaned_valid, canon)
    normal, d, inlier_mask = ransac_plane_masked(
        centroids, cleaned_valid, ransac_thresh, int(seed), ransac_iters,
        score_subsample=ransac_subsample, position_rows=position_rows,
    )

    # ── Step 4: ground removal + canonical-order obstacle compaction ───────
    obstacle_mask = cleaned_valid & ~inlier_mask
    order = _canonical_order(obstacle_mask, canon)
    obs_src = order[:obstacle_cap]
    obs_valid = obstacle_mask[obs_src]
    obs_xyz = centroids[obs_src]
    overflow = obstacle_mask.sum() > obstacle_cap

    # ── Step 5: euclidean clustering ───────────────────────────────────────
    labels, cluster_exact = sweep_cluster_labels(
        obs_xyz, obs_valid, np.float32(cluster_r), wr=cluster_wr,
        row_cap=cluster_row_cap,
    )
    false = torch.zeros((), dtype=torch.bool, device=xyz.device)
    return KittiPipelineOutput(
        centroids=centroids,
        downsampled_valid=ds_valid,
        cleaned_valid=cleaned_valid,
        plane_normal=normal,
        plane_d=d,
        inlier_mask=inlier_mask,
        obstacle_src=obs_src.to(torch.int32),
        obstacle_valid=obs_valid,
        labels=labels,
        obstacle_overflow=overflow,
        sor_certified=sor_certified,
        grid_flags=torch.stack([false, false, ~cluster_exact, false,
                                fe["ds_overflow"]]),
    )


def extract_clusters(out: KittiPipelineOutput, min_size: int, max_size: int):
    """Host-side cluster extraction with the reference's canonical ordering
    (size desc, lexicographic tiebreak; ascending indices within a cluster).
    Indices refer to the obstacle sub-cloud in compacted obstacle order."""
    labels = out.labels.cpu().numpy()
    obs_valid = out.obstacle_valid.cpu().numpy()
    valid_slots = np.nonzero(obs_valid)[0]
    lab = labels[valid_slots]
    order = np.argsort(lab, kind="stable")
    sl = lab[order]
    starts = np.nonzero(np.concatenate([[True], sl[1:] != sl[:-1]]))[0]
    ends = np.concatenate([starts[1:], [len(sl)]])
    clusters = []
    slot_rank = {s: i for i, s in enumerate(valid_slots)}
    for s, e in zip(starts, ends):
        size = e - s
        if min_size <= size <= max_size:
            members = np.sort(valid_slots[order[s:e]])
            clusters.append([slot_rank[m] for m in members])
    clusters.sort(key=lambda c: (-len(c), c))
    return clusters
