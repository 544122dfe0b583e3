"""KITTI obstacle detection on torch tensors: voxel downsample -> SOR ->
RANSAC ground plane -> ground removal -> euclidean clustering.

Counterpart of `pointclouds_tpu/pipelines/kitti.py`: every SOR backend
(the sorted-window sweep and the cell-grid backends) and both voxel front
ends (fused with the sweep ordering, and plain). Same positional
arguments, keyword names and defaults; scalar arguments are taken as
float32, as the JAX pipeline receives them from its callers (numpy
float32). Runs on the
device of ``xyz``: CUDA tensors go through the hand-written kernels, CPU
tensors through their plain torch versions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.cloud import compaction_order, stable_argsort
from ..ops.filters import (
    sor_keep_mask,
    sor_keep_mask_thr,
    voxel_downsample_masked,
    voxel_downsample_sweep_fused,
)
from ..ops.segmentation import ransac_plane_masked
from ..spatial.cellgrid import (
    build_cellgrid,
    cell_graph_adjacency,
    cell_graph_labels,
    cell_knn_subset,
    cell_sor_mean_dists,
    point_sor_mean_dists,
)
from ..spatial.grid import scalar_like
from ..spatial.sweep import (
    structure_from_sorted,
    sweep_cluster_labels,
    sweep_sor_two_pass,
)
from ..utils import profiling

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

    ``sor_backend`` takes the reference's strings: "auto", "sweep" and
    "sweep_xla" run the sorted-window sweep (SOR and clustering); "xla"
    the point-centric cell-grid SOR (`cellgrid.point_sor_mean_dists`,
    kernel ``segmented_select``); "pallas" and "pallas_interpret" the
    cell-centric one with kernel ``sor_select``; any other string the
    cell-centric one with the chunked selection. The cell-grid backends
    resolve flagged points on a 4x coarser grid and cluster on the
    collapsed cell graph (ring 2 at ``cluster_r / 2``), sized by
    ``sor_m``, ``sor_cell_cap``, ``cluster_m`` and ``cluster_cell_cap``;
    ``grid_flags`` carries their overflow flags. The device of ``xyz``
    decides between the kernels and their plain versions. The fused
    voxel->sweep front end runs for the sweep backends at an integer
    ``sor_cell_factor`` and ``ds_cap % 128 == 0``; elsewhere the plain
    voxel downsample, cut to ``ds_cap`` rows. ``sor_per_seg`` and
    ``cluster_sweeps`` tune the TPU kernels' lane certificate and sweep
    budget, which the exact selections and the converge-until-fixpoint
    cluster rounds do not need.
    """
    if ds_cap is None:
        ds_cap = xyz.shape[0]
    sweep_backend = sor_backend in ("auto", "sweep", "sweep_xla")
    with profiling.frame("kitti", xyz.device):
        voxel = scalar_like(np.float32(voxel_size), xyz)
        false = torch.zeros((), dtype=torch.bool, device=xyz.device)

        # ── Step 1: voxel downsample ────────────────────────────────────────
        with profiling.span("frontend", card=True):
            canon = None
            prebuilt = None
            if (sweep_backend and float(sor_cell_factor).is_integer()
                    and ds_cap % 128 == 0):
                # Fused front end: rows emitted in sweep order.
                factor = int(sor_cell_factor)
                fe = voxel_downsample_sweep_fused(xyz, valid, voxel,
                                                  factor=factor,
                                                  ds_cap=ds_cap)
                centroids, ds_valid, canon = (fe["centroids"],
                                              fe["out_valid"], fe["canon"])
                ds_overflow = fe["ds_overflow"]
                prebuilt = structure_from_sorted(
                    centroids, ds_valid, fe["slin"], fe["extent"],
                    fe["hi_cells"], fe["table_overflow"], wr=4,
                    grid_origin=(fe["mn_v"], float(np.float32(voxel_size)),
                                 factor),
                )
            else:
                # Compacted centroids in ascending cell-key order, cut to
                # ds_cap.
                centroids_full, ds_valid_full = voxel_downsample_masked(
                    xyz, valid, voxel)
                centroids = centroids_full[:ds_cap]
                ds_valid = ds_valid_full[:ds_cap]
                ds_overflow = ds_valid_full[ds_cap:].any()

        # ── Step 2: statistical outlier removal ────────────────────────────
        with profiling.span("sor", card=True):
            sor_cell = voxel * sor_cell_factor
            if sweep_backend:
                mean_dists, point_ok, _, mean_lb = sweep_sor_two_pass(
                    centroids, ds_valid, sor_cell, k=sor_k,
                    fix_cap=sor_fix_cap, rescue_cells=8.0, prebuilt=prebuilt,
                    row_cap=sor_row_cap, with_lb=True,
                )
                cleaned_valid, sor_thr = sor_keep_mask_thr(
                    mean_dists, ds_valid, np.float32(sor_std))
                # Keep-DECISION certificate: exact mean, or an upper bound
                # that passes, or a proven lower bound above the threshold.
                decision_ok = point_ok | cleaned_valid | (
                    mean_lb.to(torch.float64) > sor_thr)
                sor_certified = (decision_ok | ~ds_valid).all()
                grid_flags = (false, false)
            else:
                mean_dists, sor_certified, grid_flags = _cellgrid_sor(
                    centroids, ds_valid, sor_cell, sor_k=sor_k, sor_m=sor_m,
                    sor_cell_cap=sor_cell_cap, sor_fix_cap=sor_fix_cap,
                    sor_backend=sor_backend)
                cleaned_valid = sor_keep_mask(mean_dists, ds_valid,
                                              np.float32(sor_std))

        # ── Step 3: RANSAC ground plane ────────────────────────────────────
        # Canonical mini-sort (fused front end): position p -> the row
        # holding the p-th cleaned centroid in canonical voxel order (the
        # JAX package's sample order); otherwise the rows are in that order
        # already.
        position_rows = None
        if canon is not None:
            with profiling.span("compact", card=True):
                position_rows = _canonical_order(cleaned_valid, canon)
        with profiling.span("ransac", card=True):
            normal, d, inlier_mask = ransac_plane_masked(
                centroids, cleaned_valid, ransac_thresh, int(seed),
                ransac_iters, score_subsample=ransac_subsample,
                position_rows=position_rows,
                # The reference's dispatch (sequential adaptive scan below
                # 10K valid points) wherever every hypothesis is scored.
                adaptive=(ransac_subsample is None),
            )

        # ── Step 4: ground removal + obstacle compaction ───────────────────
        with profiling.span("compact", card=True):
            obstacle_mask = cleaned_valid & ~inlier_mask
            order = (compaction_order(obstacle_mask) if canon is None
                     else _canonical_order(obstacle_mask, canon))
            obs_src = order[:obstacle_cap]
            obs_valid = obstacle_mask[obs_src]
            obs_xyz = centroids[obs_src]
            overflow = obstacle_mask.sum() > obstacle_cap

        # ── Step 5: euclidean clustering ───────────────────────────────────
        with profiling.span("cluster", card=True):
            if sweep_backend:
                labels, cluster_exact = sweep_cluster_labels(
                    obs_xyz, obs_valid, np.float32(cluster_r),
                    wr=cluster_wr, row_cap=cluster_row_cap,
                )
                cluster_flags = (~cluster_exact, false)
            else:
                # Collapsed cell graph: cell r/2, ring 2.
                r = scalar_like(np.float32(cluster_r), xyz)
                cgrid = build_cellgrid(obs_xyz, obs_valid, r * 0.5,
                                       m_per_cell=cluster_m,
                                       cell_cap=cluster_cell_cap, ring=2)
                labels = cell_graph_labels(cgrid,
                                           cell_graph_adjacency(cgrid, r))
                cluster_flags = (cgrid.overflow, cgrid.table_overflow)
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
            grid_flags=torch.stack([*grid_flags, *cluster_flags,
                                    ds_overflow]),
        )


def _cellgrid_sor(centroids, ds_valid, sor_cell, *, sor_k: int, sor_m: int,
                  sor_cell_cap: int, sor_fix_cap: int, sor_backend: str):
    """The cell-grid SOR backends: pass 1 on a grid of cell ``sor_cell``
    (point-centric for "xla", cell-centric otherwise), then the flagged
    points (at most ``sor_fix_cap``) re-queried against a 4x coarser grid.
    Returns (mean f32[N], sor_certified, (grid overflow, table overflow)):
    certified only if every flagged point was resolved and no grid dropped
    a point or a cell."""
    grid = build_cellgrid(centroids, ds_valid, sor_cell, m_per_cell=sor_m,
                          cell_cap=sor_cell_cap)
    if sor_backend == "xla":
        mean_dists, point_ok, _ = point_sor_mean_dists(
            grid, centroids, ds_valid, k=sor_k)
    else:
        mean_dists, point_ok, _ = cell_sor_mean_dists(
            grid, k=sor_k, chunk=256, backend=sor_backend)

    flagged = ds_valid & ~point_ok
    fix_rows = compaction_order(flagged)[:sor_fix_cap]
    fix_valid = flagged[fix_rows]
    coarse = build_cellgrid(centroids, ds_valid, sor_cell * 4.0,
                            m_per_cell=128, cell_cap=2048)
    fix_means, fix_ok = cell_knn_subset(coarse, centroids[fix_rows],
                                        fix_rows.to(torch.int32), fix_valid,
                                        k=sor_k)
    mean_dists = mean_dists.clone()
    mean_dists[fix_rows] = torch.where(fix_valid, fix_means,
                                       mean_dists[fix_rows])
    sor_certified = ((flagged.sum() <= sor_fix_cap)
                     & (~fix_valid | fix_ok).all()
                     & ~(grid.overflow | grid.table_overflow
                         | coarse.overflow | coarse.table_overflow))
    return mean_dists, sor_certified, (grid.overflow, grid.table_overflow)


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
