"""Whole-cloud neighbour ops with exactness certified on the host: the
counterpart of the sweep-backed part of `pointclouds_tpu/spatial/engine.py`
(`knn`, `cluster_labels`, `sor_means`, `radius_count_sweep`, `normals` and
their helpers).

`knn` and `cluster_labels` are the API's entries; the others are the exact
multi-dispatch paths that the fused API ops (`ops/fusedops.py`) fall back
to when their static rescue capacity overflows: one sweep, one host read of
its certificate or flags, then a brute-force rescue of the flagged rows, of
any number. `cluster_labels` takes the reference's cell-graph rung
(`cellgrid.py`), then its int64-keyed grid rung (`radius_neighbors` +
`segmentation.propagate_labels`). Clouds of 2^24 points or more, past the
sweep kernels' f32 positions, go to the int64-keyed grid (`grid.py`,
`knn.grid_knn`) as in the JAX package. Where the JAX package's `knn` and
radius counts take their cell-grid rungs (not ported) the port takes the
exact brute force.

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
from .cellgrid import build_cellgrid, cell_graph_adjacency, cell_graph_labels
from .grid import build_grid
from .knn import (
    bruteforce_knn,
    bruteforce_radius_count,
    grid_knn,
    grid_radius_neighbors,
)
from .sweep import (
    _set_rows,
    sweep_cluster_labels,
    sweep_knn_cross_two_pass,
    sweep_knn_moments,
    sweep_knn_two_pass,
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


def _flagged_subset(residual, n: int):
    """Rows of ``residual`` padded to a `_rescue_cap` bucket: (rows i64[cap]
    with padding = n, the scatter's drop slot; sub_valid bool[cap])."""
    rows = residual.nonzero(as_tuple=True)[0]  # host read: the flagged rows
    cap = _rescue_cap(rows.numel(), n)
    sub = torch.full((cap,), n, dtype=torch.int64, device=residual.device)
    sub[: rows.numel()] = rows
    return sub, torch.arange(cap, device=residual.device) < rows.numel()


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
    selects the same-cloud sweep."""
    n = pxyz.shape[0]
    if k <= 0:
        raise ValueError("k must be >= 1 at the engine level")
    if n <= BRUTE_THRESHOLD or k >= n:
        return bruteforce_knn(pxyz, pvalid, qxyz, qvalid, k)
    if n >= CELLGRID_MAX_N:
        return _knn_int64(pxyz, pvalid, qxyz, qvalid, k)
    if k <= _SWEEP_KNN_MAX_K:
        if qxyz is pxyz and qvalid is pvalid:
            return _knn_sweep_same_cloud(pxyz, pvalid, k)
        if qxyz.shape[0] > BRUTE_THRESHOLD:
            return _knn_sweep_cross(pxyz, pvalid, qxyz, qvalid, k)
    return bruteforce_knn(pxyz, pvalid, qxyz, qvalid, k)


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


def _brute_flagged(pxyz, pvalid, qxyz, knn_out, residual, k: int):
    """``knn_out`` with the ``residual`` query rows replaced by their exact
    brute-force kNN (one host read: the flagged rows)."""
    if not bool(residual.any()):  # host read: any flagged row
        return knn_out
    nq = qxyz.shape[0]
    sub, sub_valid = _flagged_subset(residual, nq)
    d3, i3, v3 = bruteforce_knn(pxyz, pvalid, qxyz[torch.clamp(sub, max=nq - 1)],
                                sub_valid, k)
    sv = sub_valid[:, None]
    d, i, v = knn_out
    return (_set_rows(d, sub, torch.where(sv, d3, 0.0)),
            _set_rows(i, sub, torch.where(sv, i3, 0)),
            _set_rows(v, sub, sv & v3))


def _knn_sweep_same_cloud(pxyz, pvalid, k: int):
    """All-points kNN by the fused sweep (`fusedops.knn_fused`); on its
    rescue-cap overflow, the sweep again and the exact brute force of every
    row it left flagged."""
    from ..ops.fusedops import fused_rescue_cap, knn_fused

    n = pxyz.shape[0]
    wr, cap = _sweep_wr(n), fused_rescue_cap(n)
    d, i, nv, exact = knn_fused(pxyz, pvalid, k=k, wr=wr, cap=cap)
    if bool(exact):  # host read: the rescue-cap test
        return d, i, nv
    cell = estimate_cell_size(pxyz, pvalid, k)
    d, i, nv, ok = sweep_knn_two_pass(pxyz, pvalid, np.float32(cell), k=k,
                                      fix_cap=cap, wr=wr)
    return _brute_flagged(pxyz, pvalid, pxyz, (d, i, nv),
                          _residual(pxyz, pvalid, ok), k)


def _knn_sweep_cross(pxyz, pvalid, qxyz, qvalid, k: int):
    """Cross-cloud kNN: the point cloud sorted once, the queries sorted
    into its cell frame (`sweep.sweep_knn_cross_two_pass`), then the exact
    brute force of every query it left flagged."""
    from ..ops.fusedops import fused_rescue_cap

    n, qn = pxyz.shape[0], qxyz.shape[0]
    cell = estimate_cell_size(pxyz, pvalid, k)
    d, i, nv, ok = sweep_knn_cross_two_pass(
        pxyz, pvalid, qxyz, qvalid, np.float32(cell), k=k, wr=_sweep_wr(n),
        fix_cap=fused_rescue_cap(max(n, qn)))
    return _brute_flagged(pxyz, pvalid, qxyz, (d, i, nv),
                          _residual(qxyz, qvalid, ok), k)


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
