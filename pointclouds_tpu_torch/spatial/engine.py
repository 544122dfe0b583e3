"""Whole-cloud neighbour ops with exactness certified on the host: the
counterpart of the sweep-backed part of `pointclouds_tpu/spatial/engine.py`
(`sor_means`, `radius_count_sweep`, `normals` and their helpers).

These are the exact multi-dispatch paths that the fused API ops
(`ops/fusedops.py`) fall back to when their static rescue capacity
overflows: one sweep, one host read of its certificate or flags, then a
brute-force rescue of the flagged rows, of any number.

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
from .knn import bruteforce_knn, bruteforce_radius_count
from .sweep import (
    _set_rows,
    sweep_knn_moments,
    sweep_radius_count,
    sweep_sor_two_pass,
)

# Below this many points the brute-force path is cheaper than a sweep (and
# exact by construction).
BRUTE_THRESHOLD = 2048
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
