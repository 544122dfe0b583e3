"""Whole-cloud neighbour ops with exactness certified on the host: the
counterpart of `pointclouds_tpu/spatial/engine.py` (`knn`,
`radius_count`, `cluster_labels`, `sor_means`, `radius_count_sweep`,
`normals`, the single-query `radius_indices` and their helpers).

`knn` and `cluster_labels` are the API's entries; `knn` and `radius_count`
take the reference's ladder, the sweeps then the cell grid's three passes
(`cellgrid.point_knn`, `slab_knn`, `point_radius_count`) then the brute
force. The others are the exact
multi-dispatch paths that the fused API ops (`ops/fusedops.py`) fall back
to when their static rescue capacity overflows: one sweep, one host read of
its certificate or flags, then a brute-force rescue of the flagged rows, of
any number. `cluster_labels` takes the reference's cell-graph rung
(`cellgrid.py`), then its int64-keyed grid rung (`radius_neighbors` +
`segmentation.propagate_labels`). Clouds of 2^24 points or more, past the
sweep kernels' f32 positions, go to the int64-keyed grid (`grid.py`,
`knn.grid_knn`) as in the JAX package.

On the TPU the JAX package picks the Pallas kernels or their XLA mirrors
(`_kernel_preference`, VMEM gates) and degrades to the mirrors when a
kernel fails to compile (`_degrade_to_xla`). The port has one path: the
device of the input tensors decides, and a CUDA failure raises. The window
budget is the kernel branch's on both devices, so a CPU run is the card's
run with the plain kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.filters import sor_mean_dists_from_knn
from ..ops.normals import normals_from_knn, normals_from_moment_rows
from . import sweep
from .cellgrid import (
    build_cellgrid,
    cell_graph_adjacency,
    cell_graph_labels,
    point_knn,
    point_radius_count,
    slab_knn,
)
from .grid import build_grid
from .knn import (
    bruteforce_knn,
    bruteforce_radius_count,
    grid_knn,
    grid_radius_count,
    grid_radius_neighbors,
    radius_within_mask,
)
from .sweep import (
    _set_rows,
    sweep_cluster_labels,
    sweep_knn_cross_two_pass,
    sweep_knn_moments,
    sweep_radius_count,
    sweep_sor_two_pass,
)

# Below this many points the brute-force path is cheaper than a sweep (and
# exact by construction).
BRUTE_THRESHOLD = 2048
# Per-cell capacities of the grids, one per try.
M_LADDER = (16, 32, 64, 128)
# Cell sizes `_knn_int64` tries, each 1.6x the last.
MAX_TRIES = 4
# The sweep kernels and the cell grid hold positions in f32, exact below
# this many points; larger clouds go to the int64-keyed grid (`grid.py`).
CELLGRID_MAX_N = 1 << 24
# The sweep kNN kernels' top-k, as the JAX package gates them.
_SWEEP_KNN_MAX_K = 24
_RESCUE_BUCKETS = (1024, 4096, 16384, 65536, 262144)


def _extent(xyz, valid):
    """(min f32[3], max f32[3], max |coordinate|, count) over the valid
    finite points, in one 8-value host read; None for an empty cloud."""
    use = valid & torch.isfinite(xyz).all(dim=-1)
    inf = torch.tensor(torch.inf, device=xyz.device)
    stats = torch.cat([
        torch.where(use[:, None], xyz, inf).amin(dim=0),
        torch.where(use[:, None], xyz, -inf).amax(dim=0),
        torch.where(use[:, None], xyz.abs(), 0.0).amax()[None],
        use.sum().to(torch.float32)[None]]).cpu().numpy()
    if stats[7] < 1:
        return None
    return stats[0:3], stats[3:6], float(stats[6]), int(stats[7])


def estimate_cell_size(xyz, valid, k: int) -> float:
    """Initial kNN cell size ~ the expected kth-neighbour distance: the
    larger of the 3D (spacing * (3k/4pi)^(1/3)) and planar (spacing2d *
    sqrt(k/pi)) density estimates, with a 1.25x margin."""
    ext = _extent(xyz, valid)
    if ext is None:
        return 1.0
    mn, mx, _, n = ext
    span = np.maximum(mx - mn, 1e-12)
    vol = float(span[0] * span[1] * span[2])
    area = float(np.sort(span)[-2:].prod())  # the two largest extents
    s3 = (vol / n) ** (1.0 / 3.0)
    s2 = (area / n) ** 0.5
    kf = max(k, 1)
    r3 = s3 * (3.0 * kf / (4.0 * np.pi)) ** (1.0 / 3.0)
    r2 = s2 * (kf / np.pi) ** 0.5
    return float(max(r3, r2, 1e-9) * 1.25)


def _fp_safe_radius_cell(radius: float, max_abs_coord: float) -> float:
    """A cell slightly above ``radius``, so that the f32 rounding of floor(p
    / cell), which grows with |coordinate| / cell, never puts a neighbour
    within the radius outside the 27-cell neighbourhood."""
    return radius * (1.0 + 1e-5) + max_abs_coord * 6e-7


def _sweep_wr(n: int) -> int:
    """Window-row budget of the 4-channel sweeps: the JAX package's kernel
    branch (the kernels' window loops have data-dependent bounds, so a
    wide budget only certifies more blocks), on both devices."""
    return min(max(-(-n // 128), 1), 16)


def _rescue_cap(count: int, n: int) -> int:
    """Rescue capacity bucket for ``count`` flagged rows (never below the
    count, so the engine paths below rescue every flagged row)."""
    for b in _RESCUE_BUCKETS:
        if count <= b:
            return min(b, n)
    return n


def _pad_rows(rows, n: int):
    """Row indices i64 padded to a `_rescue_cap` bucket with n, the
    scatter's drop slot (the reference pads with row 0, so that a flagged
    row 0 could take its unpatched row back): (rows i64[cap], sub_valid
    bool[cap])."""
    cap = _rescue_cap(rows.numel(), n)
    sub = torch.full((cap,), n, dtype=torch.int64, device=rows.device)
    sub[: rows.numel()] = rows
    return sub, torch.arange(cap, device=rows.device) < rows.numel()


def _flagged_subset(residual, n: int):
    """The rows of ``residual`` (one host read), padded by `_pad_rows`."""
    return _pad_rows(residual.nonzero(as_tuple=True)[0], n)


def _residual(xyz, valid, point_ok):
    return valid & torch.isfinite(xyz).all(dim=-1) & ~point_ok


def sor_means(xyz, valid, k: int):
    """Exact mean distance to the k nearest non-self neighbours per point
    (+inf for isolated / invalid points): the windows sweep (kernels
    `sweep_select` and `rescue_select`), then a brute-force rescue of
    whatever it could not certify."""
    n = xyz.shape[0]
    if n <= BRUTE_THRESHOLD:
        return _brute_sor_means(xyz, valid, k)
    cell = estimate_cell_size(xyz, valid, k + 1)
    mean, point_ok, certified = sweep_sor_two_pass(
        xyz, valid, np.float32(cell), k=k, wr=_sweep_wr(n))
    if bool(certified):  # host read: the sweep's certificate
        return mean
    sub, sub_valid = _flagged_subset(_residual(xyz, valid, point_ok), n)
    sub_means = _brute_sor_means_subset(
        xyz, valid, torch.clamp(sub, max=n - 1), sub_valid, k)
    return _set_rows(mean, sub, sub_means)


def _brute_sor_means(xyz, valid, k: int):
    dists, _, nvalid = bruteforce_knn(xyz, valid, xyz, valid, k + 1)
    return sor_mean_dists_from_knn(dists, nvalid,
                                   torch.isfinite(xyz).all(dim=-1))


def _brute_sor_means_subset(xyz, valid, sub_rows, sub_valid, k: int):
    qxyz = xyz[sub_rows]
    dists, _, nvalid = bruteforce_knn(xyz, valid, qxyz, sub_valid, k + 1)
    return sor_mean_dists_from_knn(dists, nvalid,
                                   torch.isfinite(qxyz).all(dim=-1))


def radius_count_sweep(pxyz, pvalid, radius: float):
    """Exact within-radius counts (self included, inclusive) of every point
    of one cloud: the windows sweep (kernel `count_within`), then a
    brute-force count of the rows whose windows overflowed."""
    n = pxyz.shape[0]
    if radius <= 0 or not np.isfinite(radius) or n <= BRUTE_THRESHOLD:
        return bruteforce_radius_count(pxyz, pvalid, pxyz, pvalid, radius)
    counts, point_ok = sweep_radius_count(pxyz, pvalid, np.float32(radius),
                                          wr=_sweep_wr(n))
    residual = _residual(pxyz, pvalid, point_ok)
    if not bool(residual.any()):  # host read: any flagged row
        return counts
    sub, sub_valid = _flagged_subset(residual, n)
    sub_counts = bruteforce_radius_count(
        pxyz, pvalid, pxyz[torch.clamp(sub, max=n - 1)], sub_valid, radius)
    return _set_rows(counts, sub, sub_counts)


def normals(xyz, valid, k: int, viewpoint):
    """Exact oriented PCA normals (k nearest including self): the kNN
    moments sweep (kernel `sweep_moments`), then a brute-force kNN rescue
    of the rows it could not certify."""
    n = xyz.shape[0]
    vp = torch.as_tensor(viewpoint, dtype=torch.float32, device=xyz.device)
    if n <= BRUTE_THRESHOLD or k >= n:
        _, idx, nvalid = bruteforce_knn(xyz, valid, xyz, valid,
                                        min(k, max(n, 1)))
        return normals_from_knn(xyz, idx, nvalid, vp)
    cell = estimate_cell_size(xyz, valid, k)
    m1, m2, cnt, point_ok = sweep_knn_moments(
        xyz, valid, np.float32(cell), k=k, wr=_sweep_wr(n))
    nrm = _normals_from_moments(xyz, m1, m2, cnt, vp)
    residual = _residual(xyz, valid, point_ok)
    if not bool(residual.any()):  # host read: any flagged row
        return nrm
    sub, sub_valid = _flagged_subset(residual, n)
    sub_n = _normals_rescue(xyz, valid, torch.clamp(sub, max=n - 1),
                            sub_valid, vp, k)
    return _set_rows(nrm, sub, sub_n)


def _normals_rescue(xyz, valid, sub_rows, sub_valid, vp, k: int):
    sub_xyz = xyz[sub_rows]
    _, idx, nvalid = bruteforce_knn(xyz, valid, sub_xyz, sub_valid, k)
    return normals_from_knn(xyz, idx, nvalid, vp, query_xyz=sub_xyz)


def _normals_from_moments(xyz, m1, m2, cnt, viewpoint):
    """Column-layout ([N, 3] / [N, 6]) adapter over
    `normals_from_moment_rows`."""
    return normals_from_moment_rows(m1.T, m2.T, cnt, xyz, viewpoint)


# ── kNN ──────────────────────────────────────────────────────────────────────


def knn(pxyz, pvalid, qxyz, qvalid, k: int):
    """Exact batched kNN: (dists f32[Q, k] Euclidean ascending, idx i32[Q,
    k], nvalid bool[Q, k]). A query identical to a stored point returns it
    at distance 0. Passing the point tensors themselves as the queries
    selects the same-cloud paths.

    The reference's ladder: the brute force for small clouds or k >= n,
    the int64-keyed grid from 2^24 points; for k <= 24 the same-cloud
    sweep, or the cross-cloud sweep for more than `BRUTE_THRESHOLD`
    queries, each giving up (None) where it fits badly; then the cell
    grid (`_knn_cellgrid`)."""
    n = pxyz.shape[0]
    if k <= 0:
        raise ValueError("k must be >= 1 at the engine level")
    if n <= BRUTE_THRESHOLD or k >= n:
        return bruteforce_knn(pxyz, pvalid, qxyz, qvalid, k)
    if n >= CELLGRID_MAX_N:
        return _knn_int64(pxyz, pvalid, qxyz, qvalid, k)
    same_cloud = qxyz is pxyz and qvalid is pvalid
    if k <= _SWEEP_KNN_MAX_K:
        out = None
        if same_cloud:
            out = _knn_sweep_same_cloud(pxyz, pvalid, k)
        elif qxyz.shape[0] > BRUTE_THRESHOLD:
            out = _knn_sweep_cross(pxyz, pvalid, qxyz, qvalid, k)
        if out is not None:
            return out
    return _knn_cellgrid(pxyz, pvalid, qxyz, qvalid, k, same_cloud)


def _subset_cap(count: int) -> int:
    """The reference's padded size of a flagged subset, a power of two of
    at least 1024: its coarse pass runs only where this is at most the
    cloud's size."""
    return max(1024, 1 << int(np.ceil(np.log2(max(count, 1)))))


def _subset(rows, qxyz, qvalid):
    """Flagged query ``rows`` padded by `_pad_rows`: (rows, their query
    validity, their coordinates)."""
    nq = qxyz.shape[0]
    sub, sub_valid = _pad_rows(rows, nq)
    safe = torch.clamp(sub, max=nq - 1)
    return sub, qvalid[safe] & sub_valid, qxyz[safe]


def _patch_rows(out, sub, sv, patch):
    """``out`` (dists, idx, nvalid) with the ``sub`` rows replaced by
    ``patch``'s rows (``sv``: the valid ones; padding slots are dropped)."""
    sv = sv[:, None]
    d, i, v = out
    d3, i3, v3 = patch
    return (_set_rows(d, sub, torch.where(sv, d3, 0.0)),
            _set_rows(i, sub, torch.where(sv, i3, 0)),
            _set_rows(v, sub, sv & v3))


def _knn_cellgrid(pxyz, pvalid, qxyz, qvalid, k: int, same_cloud: bool):
    """The reference's three cell-grid passes. Pass 1: a grid at the
    estimated kth-neighbour cell, the per-cell capacity grown over
    `M_LADDER` from the first with 27 M >= k + 1 (the brute force where the
    table overflows or no capacity holds); the same cloud rebuilt at the
    tight cell cap for `slab_knn`, other queries through `point_knn`.
    Pass 2: the flagged rows at a 2.5x cell and the largest capacity, when
    their padded subset is no larger than the cloud. Pass 3: the brute
    force of the rows still flagged. One host read a pass: its flags."""
    n = pxyz.shape[0]
    cell = estimate_cell_size(pxyz, pvalid, k)
    cap = _cell_cap(n)
    m_i = 0
    # Enough block slots that the 27-cell slab can hold k results at all.
    while 27 * M_LADDER[min(m_i, len(M_LADDER) - 1)] < k + 1:
        m_i += 1
    grid = None
    for _ in range(MAX_TRIES):
        m = M_LADDER[min(m_i, len(M_LADDER) - 1)]
        g = build_cellgrid(pxyz, pvalid, cell, m_per_cell=m, cell_cap=cap)
        # host read: both flags
        table_over, over = torch.stack([g.table_overflow, g.overflow]
                                       ).tolist()
        if table_over:
            return bruteforce_knn(pxyz, pvalid, qxyz, qvalid, k)
        if not over:
            grid = g
            break
        m_i += 1
    if grid is None:
        return bruteforce_knn(pxyz, pvalid, qxyz, qvalid, k)

    if same_cloud:
        # A tight cell cap (the slab scales with it), then the slab pass.
        m = M_LADDER[min(m_i, len(M_LADDER) - 1)]
        tight = max(2048, 1 << int(np.ceil(np.log2(max(
            int(grid.num_cells), 1)))))  # host read: the cell count
        if tight < cap:
            grid = build_cellgrid(pxyz, pvalid, cell, m_per_cell=m,
                                  cell_cap=tight)
        dists, idx, nvalid, point_ok = slab_knn(grid, qxyz, qvalid, k=k)
    else:
        dists, idx, nvalid, point_ok = point_knn(grid, qxyz, qvalid, k=k)
    del grid
    out = (dists, idx, nvalid)
    rows = (~point_ok).nonzero(as_tuple=True)[0]  # host read: flagged rows
    if rows.numel() == 0:
        return out

    if _subset_cap(rows.numel()) <= n:  # a real subset of the cloud
        coarse = build_cellgrid(pxyz, pvalid, cell * 2.5,
                                m_per_cell=M_LADDER[-1], cell_cap=cap)
        # host read: both flags
        if not torch.stack([coarse.overflow, coarse.table_overflow]
                           ).any().item():
            sub, sv, sq = _subset(rows, qxyz, qvalid)
            d2, i2, v2, ok2 = point_knn(coarse, sq, sv, k=k)
            out = _patch_rows(out, sub, sv, (d2, i2, v2))
            rows = sub[sv & ~ok2]  # host read: the rows still flagged
    if rows.numel():
        sub, sv, sq = _subset(rows, qxyz, qvalid)
        out = _patch_rows(out, sub, sv,
                          bruteforce_knn(pxyz, pvalid, sq, sv, k))
    return out


def _knn_int64(pxyz, pvalid, qxyz, qvalid, k: int):
    """kNN over the int64-keyed grid, for clouds past the sweep kernels'
    f32 positions: at each cell size (the estimate, then 1.6x, up to
    `MAX_TRIES`), the capacities of `M_LADDER` until no cell overflows; a
    certified result returns, an insufficient one grows the cell. The
    reference's own exact brute force is the last resort."""
    cell = estimate_cell_size(pxyz, pvalid, k)
    for _ in range(MAX_TRIES):
        grid = build_grid(pxyz, pvalid, cell)
        for m in M_LADDER:
            dists, idx, nvalid, overflow, insufficient = grid_knn(
                grid, qxyz, qvalid, k, m)
            # host read: both flags
            over, insuff = torch.stack([overflow, insufficient]).tolist()
            if not (over or insuff):
                return dists, idx, nvalid
            if not over:  # no overflow: the cell is too small
                break
        cell *= 1.6
    return bruteforce_knn(pxyz, pvalid, qxyz, qvalid, k)


def _knn_sweep_same_cloud(pxyz, pvalid, k: int):
    """All-points kNN by the fused sweep (`fusedops.knn_fused`); None when
    more rows stayed flagged than its rescue holds (the sweep fits the
    cloud badly: the caller takes the cell grid)."""
    from ..ops.fusedops import fused_rescue_cap, knn_fused

    n = pxyz.shape[0]
    d, i, nv, exact = knn_fused(pxyz, pvalid, k=k, wr=_sweep_wr(n),
                                cap=fused_rescue_cap(n))
    if not bool(exact):  # host read: the rescue-cap test
        return None
    return d, i, nv


def _knn_sweep_cross(pxyz, pvalid, qxyz, qvalid, k: int):
    """Cross-cloud kNN: the point cloud sorted once, the queries sorted
    into its cell frame (`sweep.sweep_knn_cross_two_pass`), then the exact
    brute force of the queries it left flagged; None when more than
    max(Q / 4, 4096) are flagged (the caller takes the cell grid)."""
    from ..ops.fusedops import fused_rescue_cap

    n, qn = pxyz.shape[0], qxyz.shape[0]
    cell = estimate_cell_size(pxyz, pvalid, k)
    d, i, nv, ok = sweep_knn_cross_two_pass(
        pxyz, pvalid, qxyz, qvalid, np.float32(cell), k=k, wr=_sweep_wr(n),
        fix_cap=fused_rescue_cap(max(n, qn)))
    rows = _residual(qxyz, qvalid, ok).nonzero(as_tuple=True)[0]  # host read
    if rows.numel() == 0:
        return d, i, nv
    if rows.numel() > max(qn // 4, 4096):
        return None  # the sweep fits this pair badly
    sub, sv, sq = _subset(rows, qxyz, qvalid)
    return _patch_rows((d, i, nv), sub, sv,
                       bruteforce_knn(pxyz, pvalid, sq, sv, k))


def radius_count(pxyz, pvalid, qxyz, qvalid, radius: float):
    """Exact count of the points within ``radius`` (inclusive) of each
    query, int32[Q]: zeros for a radius <= 0 or not finite; the brute force
    up to `BRUTE_THRESHOLD` points; from 2^24 points the int64-keyed grid
    (`knn.grid_radius_count`); otherwise the cell grid at a cell just above
    the radius (`cellgrid.point_radius_count`), the per-cell capacity grown
    over `M_LADDER`, and the brute force where the table overflows or no
    capacity holds."""
    n = pxyz.shape[0]
    if radius <= 0 or not np.isfinite(radius):
        return torch.zeros(qxyz.shape[0], dtype=torch.int32,
                           device=qxyz.device)
    if n <= BRUTE_THRESHOLD:
        return bruteforce_radius_count(pxyz, pvalid, qxyz, qvalid, radius)
    ext = _extent(pxyz, pvalid)
    max_abs = ext[2] if ext else 0.0
    cell = _fp_safe_radius_cell(radius, max_abs)
    if n >= CELLGRID_MAX_N:
        for attempt in range(MAX_TRIES):
            m = M_LADDER[min(attempt, len(M_LADDER) - 1)]
            counts, overflow = grid_radius_count(
                build_grid(pxyz, pvalid, cell), qxyz, qvalid, radius, m)
            if not bool(overflow):  # host read: the capacity held
                return counts
        return bruteforce_radius_count(pxyz, pvalid, qxyz, qvalid, radius)
    cap = _cell_cap(n)
    for attempt in range(MAX_TRIES):
        m = M_LADDER[min(attempt, len(M_LADDER) - 1)]
        grid = build_cellgrid(pxyz, pvalid, cell, m_per_cell=m, cell_cap=cap)
        # host read: both flags
        table_over, over = torch.stack([grid.table_overflow, grid.overflow]
                                       ).tolist()
        if table_over:
            break
        if not over:
            return point_radius_count(grid, qxyz, qvalid, radius)
    return bruteforce_radius_count(pxyz, pvalid, qxyz, qvalid, radius)


# ── Euclidean clustering ─────────────────────────────────────────────────────


def _surviving_component_ranks(labels, min_size: int, max_size: int):
    """Per row, the rank of its component among the components whose size
    lies in [min_size, max_size] (ascending representative order), or -1
    for rows of the others. Returns (comp i32[N], surviving count)."""
    n = labels.shape[0]
    dev = labels.device
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    sl, sidx = torch.sort(labels, stable=True)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       sl[1:] != sl[:-1]])
    start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    is_end = torch.cat([first[1:], torch.ones(1, dtype=torch.bool,
                                              device=dev)])
    end = torch.flip(torch.cummin(torch.flip(
        torch.where(is_end, pos, n), [0]), dim=0).values, [0])
    size = end - start + 1
    ok = (size >= min_size) & (size <= max_size)
    rank = torch.cumsum((first & ok).to(torch.int64), dim=0) - 1
    comp = torch.empty(n, dtype=torch.int32, device=dev)
    comp[sidx] = torch.where(ok, rank, -1).to(torch.int32)
    return comp, rank[-1] + 1


def cluster_labels(xyz, valid, radius: float, n_valid: int | None = None,
                   size_filter: tuple | None = None):
    """Connected-component labels under inclusive distance ``radius``, as
    a host int32 array over the first ``n_valid`` rows rounded up to 128
    (all rows without ``n_valid``). Invalid and non-finite points are
    singletons.

    The reference's ladder (`pointclouds_tpu/spatial/engine.py`) on both
    devices, each rung exact or flagged: the sweep rungs
    (`sweep.sweep_cluster_labels`) -- up to `sweep.CLUSTER_RESIDENT_BYTES`
    of planar rows (2^20 points) the flat row-list walk then the nine
    windows with no row cap, above it the hop loop at window budgets 7, 14
    and 28 rows -- then the collapsed cell-graph rung (`_cell_graph_rung`),
    both below 2^24 points (`CELLGRID_MAX_N`) only; then the int64-keyed
    grid's capped neighbour lists (`radius_neighbors`) with min-label
    propagation (`segmentation.propagate_labels`), and only where no
    capacity holds every neighbour the uncapped exact all-pairs
    propagation (`segmentation.bruteforce_cluster_labels`).

    Without ``size_filter`` returns labels whose ascending order is that of
    the components' smallest rows. With ``size_filter=(min_size,
    max_size)`` returns (labels, filtered): from a sweep rung, filtered is
    True and labels are surviving-component ranks with -1 on the rows of
    components outside the band (`_surviving_component_ranks`); from the
    other rungs, (raw labels, False)."""
    from ..ops import segmentation

    n = xyz.shape[0]
    rows = n if n_valid is None else min(n, max(128, -(-int(n_valid) // 128)
                                                * 128))
    r32 = np.float32(radius)
    if BRUTE_THRESHOLD // 4 < n < CELLGRID_MAX_N:
        nrows = max(-(-n // 128), 1)
        if nrows * 8 * 128 * 4 <= sweep.CLUSTER_RESIDENT_BYTES:
            ladder = ((min(nrows, 64), 16), (min(nrows, 64), None))
        else:
            ladder = ((7, 16), (14, 16), (28, 16))
        for wr, row_cap in ladder:
            # The windows rung starts at 6 rounds a burst: its resume
            # bursts extend a run that has not converged.
            labels, exact = sweep_cluster_labels(
                xyz, valid, r32, wr=wr, row_cap=row_cap,
                sweeps=12 if row_cap is not None else 6)
            if not bool(exact):  # host read: the rung's certificate
                continue
            if size_filter is None:
                return labels[:rows].cpu().numpy()
            comp, _ = _surviving_component_ranks(labels, int(size_filter[0]),
                                                 int(size_filter[1]))
            return comp[:rows].cpu().numpy(), True
    labels = (_cell_graph_rung(xyz, valid, radius) if n < CELLGRID_MAX_N
              else None)
    if labels is None:
        nbrs = radius_neighbors(xyz, valid, radius)
        if nbrs is not None:
            labels = segmentation.propagate_labels(*nbrs, valid)
        else:
            labels = segmentation.bruteforce_cluster_labels(xyz, valid, r32)
    labels = labels[:rows].cpu().numpy()
    return labels if size_filter is None else (labels, False)


def _cell_cap(n: int) -> int:
    """Cells never outnumber points; rounded up to the chunking grain."""
    return max(2048, -(-n // 2048) * 2048)


def _cell_graph_rung(xyz, valid, radius: float):
    """The collapsed cell-graph labels (`cellgrid.cell_graph_labels`) at
    cell r/2 less the f32 margin, ring 2, growing the per-cell capacity
    over `M_LADDER`; None where the table overflows, no capacity holds
    every cell, or the cell would be empty."""
    ext = _extent(xyz, valid)
    max_abs = ext[2] if ext else 0.0
    cell = radius * 0.5 * (1.0 - 1e-5) - max_abs * 3e-7
    if cell <= 0:
        return None
    cap = _cell_cap(xyz.shape[0])
    for m in M_LADDER:
        grid = build_cellgrid(xyz, valid, cell, m_per_cell=m, cell_cap=cap,
                              ring=2)
        if bool(grid.table_overflow):  # host read: the grid's flags
            return None
        if bool(grid.overflow):
            continue
        return cell_graph_labels(
            grid, cell_graph_adjacency(grid, np.float32(radius)))
    return None


def radius_indices(pxyz, pvalid, query, radius: float):
    """Original-order indices (ascending) of the valid points within
    ``radius`` (inclusive, taken as float32 and squared in float32) of one
    query point, as a host int array. One pass over the cloud on its
    device (`knn.radius_within_mask`); only the [N] bool mask comes back
    to the host."""
    q = torch.as_tensor(np.asarray(query, np.float32), device=pxyz.device)
    mask = radius_within_mask(pxyz, pvalid, q, np.float32(radius))
    return np.nonzero(mask.cpu().numpy())[0]


def radius_neighbors(xyz, valid, radius: float):
    """Exact capped neighbour lists of every point within ``radius``
    (inclusive), for `segmentation.propagate_labels`: (idx i32[N, C],
    within bool[N, C]) from the int64-keyed grid at a cell just above the
    radius (`_fp_safe_radius_cell`), at the first capacity of (16, 32, 64,
    128, 256, 512) where no cell overflows; None where none holds every
    cell (truncated lists would break exactness: the caller takes the
    uncapped brute force)."""
    ext = _extent(xyz, valid)
    max_abs = ext[2] if ext else 0.0
    grid = build_grid(xyz, valid, _fp_safe_radius_cell(radius, max_abs))
    for m in (*M_LADDER, M_LADDER[-1] * 2, M_LADDER[-1] * 4):
        idx, within, overflow = grid_radius_neighbors(grid, xyz, valid,
                                                      radius, m)
        if not bool(overflow):  # host read: the capacity held
            return idx, within
        del idx, within
    return None
