"""The API's filter, normals and same-cloud kNN ops, each as one program with
one host read: the counterpart of `pointclouds_tpu/ops/fusedops.py`.

Each op: the grid cell estimated on the device, the sorted-window sweep
with its group-pruned rescue, the rows still flagged compacted into a
static ``cap`` buffer and resolved exactly against the whole cloud (the
brute rescue kernels `brute_knn_idx` / `brute_radius_count`), then the
op's epilogue and the output compaction. The result carries ``exact =
n_flagged <= cap``; the rare overflow makes the caller rerun the exact
multi-dispatch engine path (`spatial/engine.py`), so results are exact in
every case.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import cloud as _cloud
from ..spatial.engine import _brute_sor_means
from ..spatial.kernels import brute_knn_idx, brute_radius_count
from ..spatial.knn import bruteforce_knn, bruteforce_radius_count
from ..spatial.sweep import (
    _set_rows,
    sweep_knn_two_pass,
    sweep_moments_two_pass_rows,
    sweep_radius_count_two_pass,
    sweep_sor_two_pass,
)
from .filters import (
    passthrough_mask,
    sor_keep_mask,
    sor_mean_dists_from_knn,
    voxel_downsample_masked,
)
from .normals import normals_from_knn, normals_from_moment_rows
from .registration import _to_planar


def fused_rescue_cap(n: int) -> int:
    """Static whole-cloud rescue capacity: it costs O(cap * N) exact
    distances, so it scales with the cloud within [512, 4096] rows."""
    return min(max(512, n // 32), 4096)


def _rescue_kernel_fits(n: int, k: int) -> bool:
    """The brute rescue kernels take any cloud whose flat positions stay
    exact in f32 and k up to the JAX package's gate of 24 (its
    VMEM-residency test has no counterpart on the card)."""
    return k <= 24 and n <= 2**24


def _finite(xyz):
    return torch.isfinite(xyz).all(dim=-1)


def _rescue_knn(xyz, valid, sub_xyz, sub_valid, k: int):
    """Exact kNN of the compacted flagged queries against the whole cloud
    (kernel `brute_knn_idx`; the torch brute force past its gate). Returns
    (dists, idx, nvalid) as `bruteforce_knn`; positions of empty slots are
    clipped to row 0 with nvalid False."""
    n = xyz.shape[0]
    if _rescue_kernel_fits(n, k) and k <= n:
        out = brute_knn_idx(_to_planar(sub_xyz, sub_valid),
                            _to_planar(xyz, valid & _finite(xyz)), k=k)
        cap = sub_xyz.shape[0]
        dists = out[:k, :cap].T
        idx = torch.clamp(out[k:2 * k, :cap], 0.0, float(n - 1)).to(
            torch.int32).T
        return dists, idx, torch.isfinite(dists)
    return bruteforce_knn(xyz, valid, sub_xyz, sub_valid, k)


def _rescue_radius_count(xyz, valid, sub_xyz, sub_valid, radius):
    """Exact inclusive within-radius counts of the flagged queries against
    the whole cloud (kernel `brute_radius_count`; the torch brute force
    past its gate). ``radius``: an f32 0-d tensor."""
    n = xyz.shape[0]
    if not _rescue_kernel_fits(n, 1):
        return bruteforce_radius_count(xyz, valid, sub_xyz, sub_valid, radius)
    # r^2 rides the query w channel; -1 marks an invalid query (so radius
    # = 0 keeps inclusive coincident-point semantics, and all-padding
    # blocks are skipped in the kernel).
    r2w = torch.where(sub_valid & _finite(sub_xyz), radius * radius, -1.0)
    qp = _to_planar(sub_xyz, sub_valid)
    nq = qp.shape[0] * 128
    qp[:, 3, :] = torch.nn.functional.pad(r2w, (0, nq - r2w.shape[0]),
                                          value=-1.0).reshape(-1, 128)
    cap = sub_xyz.shape[0]
    counts = brute_radius_count(qp, _to_planar(xyz, valid & _finite(xyz)))
    return counts[:cap].to(torch.int32)


def _cell_estimate_device(xyz, valid, kf: float):
    """On-device mirror of `engine.estimate_cell_size` in f32: the larger
    of the 3D and planar kth-neighbour density estimates, 1.25x margin.
    Powers and roots go through float64 (then f32), so the card and the
    CPU agree; constants are the f32 values the JAX package's weakly
    typed Python floats become, and its divisions by constants are
    multiplies by their f32 reciprocals, as XLA folds them."""
    f32 = torch.float32
    use = valid & _finite(xyz)
    inf = torch.tensor(torch.inf, device=xyz.device)
    mn = torch.where(use[:, None], xyz, inf).amin(dim=0)
    mx = torch.where(use[:, None], xyz, -inf).amax(dim=0)
    n = use.sum().to(f32)
    nf = torch.clamp(n, min=1.0)
    span = torch.clamp(mx - mn, min=float(np.float32(1e-12)))
    vol = span[0] * span[1] * span[2]
    sspan = torch.sort(span).values
    area = sspan[1] * sspan[2]
    third = float(np.float32(1.0 / 3.0))
    kf = torch.tensor(np.float32(kf), device=xyz.device)

    def cbrt(x):
        return (x.to(torch.float64) ** third).to(f32)

    def sqrt(x):
        return torch.sqrt(x.to(torch.float64)).to(f32)

    s3 = cbrt(vol / nf)
    s2 = sqrt(area / nf)
    r3 = s3 * cbrt(3.0 * kf * float(np.float32(1.0 / np.float32(
        4.0 * math.pi))))
    r2 = s2 * sqrt(kf * float(np.float32(1.0 / np.float32(math.pi))))
    est = torch.clamp(torch.maximum(r3, r2), min=float(np.float32(1e-9)))
    return torch.where(n < 1.0, 1.0, est * 1.25)


def _flagged_rows(residual, cap: int):
    """The flagged rows compacted into a static-cap buffer: (rows i64[cap]
    (fill n, the scatter's drop slot), sub_valid bool[cap], nflag)."""
    n = residual.shape[0]
    nflag = residual.sum()
    order = _cloud.compaction_order(residual)[:cap]
    sub_valid = torch.arange(cap, device=residual.device) < nflag
    return torch.where(sub_valid, order, n), sub_valid, nflag


def _compacted(arrs, keep):
    out = _cloud.compact(_cloud.mask_cloud(arrs, keep))
    return out, _cloud.count(out)


# ── SOR ──────────────────────────────────────────────────────────────────────


def sor_fused(arrs, std_mul, *, k: int, wr: int, cap: int):
    """statistical_outlier_removal: sweep (row-list pass 1) + group-pruned
    rescue + whole-cloud rescue of up to ``cap`` rows + keep mask +
    compaction. Returns (compacted cloud, info int64[2] = [new count,
    exact]); exact = 0 when more than ``cap`` rows stayed flagged."""
    xyz, valid = arrs.xyz, arrs.valid
    n = xyz.shape[0]
    cell = _cell_estimate_device(xyz, valid, k + 1)
    mean, ok, _ = sweep_sor_two_pass(xyz, valid, cell, k=k, wr=wr,
                                     row_cap=32)
    residual = valid & _finite(xyz) & ~ok
    rows, sub_valid, nflag = _flagged_rows(residual, cap)
    sub_xyz = xyz[torch.clamp(rows, max=n - 1)]
    sd, _, sv = _rescue_knn(xyz, valid, sub_xyz, sub_valid, k + 1)
    sub_means = sor_mean_dists_from_knn(sd, sv, _finite(sub_xyz))
    mean = _set_rows(mean, rows, torch.where(sub_valid, sub_means, 0.0))
    out, cnt = _compacted(arrs, sor_keep_mask(mean, valid, std_mul))
    return out, torch.stack([cnt, (nflag <= cap).to(cnt.dtype)])


def sor_fused_small(arrs, std_mul, *, k: int):
    """Small-cloud SOR: the exact brute-force kNN."""
    mean = _brute_sor_means(arrs.xyz, arrs.valid, k)
    out, cnt = _compacted(arrs, sor_keep_mask(mean, arrs.valid, std_mul))
    return out, torch.stack([cnt, torch.ones_like(cnt)])


# ── Radius outlier removal ───────────────────────────────────────────────────


def ror_fused(arrs, radius, min_neighbors, *, wr: int, cap: int):
    """radius_outlier_removal (count includes self, inclusive boundary):
    sweep + group-pruned rescue + whole-cloud rescue of up to ``cap``
    rows + threshold + compaction. ``radius``: an f32 0-d tensor. Returns
    (compacted cloud, info [new count, exact])."""
    xyz, valid = arrs.xyz, arrs.valid
    n = xyz.shape[0]
    counts, ok = sweep_radius_count_two_pass(xyz, valid, radius, fix_cap=cap,
                                             wr=wr)
    residual = valid & _finite(xyz) & ~ok
    rows, sub_valid, nflag = _flagged_rows(residual, cap)
    sub_counts = _rescue_radius_count(
        xyz, valid, xyz[torch.clamp(rows, max=n - 1)], sub_valid, radius)
    counts = _set_rows(counts, rows, torch.where(sub_valid, sub_counts, 0))
    out, cnt = _compacted(arrs, valid & (counts >= min_neighbors))
    return out, torch.stack([cnt, (nflag <= cap).to(cnt.dtype)])


def ror_fused_small(arrs, radius, min_neighbors):
    counts = bruteforce_radius_count(arrs.xyz, arrs.valid, arrs.xyz,
                                     arrs.valid, radius)
    out, cnt = _compacted(arrs, arrs.valid & (counts >= min_neighbors))
    return out, torch.stack([cnt, torch.ones_like(cnt)])


# ── Normals ──────────────────────────────────────────────────────────────────


def normals_fused(xyz, valid, viewpoint, *, k: int, wr: int, cap: int):
    """estimate_normals: kNN-moments sweep + group-pruned rescue +
    whole-cloud rescue of up to ``cap`` rows + Cardano + orientation.
    Returns (normals f32[N, 3], exact bool 0-d tensor)."""
    n = xyz.shape[0]
    vp = torch.as_tensor(viewpoint, dtype=torch.float32, device=xyz.device)
    cell = _cell_estimate_device(xyz, valid, k)
    m1r, m2r, cnt, ok = sweep_moments_two_pass_rows(
        xyz, valid, cell, k=k, fix_cap=cap, wr=wr)
    nrm = normals_from_moment_rows(m1r, m2r, cnt, xyz, vp)
    residual = valid & _finite(xyz) & ~ok
    rows, sub_valid, nflag = _flagged_rows(residual, cap)
    sub_xyz = xyz[torch.clamp(rows, max=n - 1)]
    _, si, sv = _rescue_knn(xyz, valid, sub_xyz, sub_valid, k)
    sub_n = normals_from_knn(xyz, si, sv, vp, query_xyz=sub_xyz)
    nrm = _set_rows(nrm, rows, torch.where(sub_valid[:, None], sub_n, 0.0))
    return nrm, nflag <= cap


def normals_fused_small(xyz, valid, viewpoint, *, k: int):
    vp = torch.as_tensor(viewpoint, dtype=torch.float32, device=xyz.device)
    _, idx, nvalid = bruteforce_knn(xyz, valid, xyz, valid, k)
    return normals_from_knn(xyz, idx, nvalid, vp)


# ── Same-cloud kNN ───────────────────────────────────────────────────────────


def knn_fused(xyz, valid, *, k: int, wr: int, cap: int):
    """Whole-cloud kNN (self included): the kNN sweep with its group-pruned
    rescue, then the whole-cloud rescue of up to ``cap`` rows still
    flagged. Returns (dists f32[N, k], idx i32[N, k], nvalid bool[N, k],
    exact bool 0-d tensor); exact = False when more than ``cap`` rows
    stayed flagged."""
    n = xyz.shape[0]
    cell = _cell_estimate_device(xyz, valid, k)
    d, i, nv, ok = sweep_knn_two_pass(xyz, valid, cell, k=k, fix_cap=cap,
                                      wr=wr)
    rows, sub_valid, nflag = _flagged_rows(valid & _finite(xyz) & ~ok, cap)
    d3, i3, v3 = _rescue_knn(xyz, valid, xyz[torch.clamp(rows, max=n - 1)],
                             sub_valid, k)
    sv = sub_valid[:, None]
    return (_set_rows(d, rows, torch.where(sv, d3, 0.0)),
            _set_rows(i, rows, torch.where(sv, i3.to(i.dtype), 0)),
            _set_rows(nv, rows, sv & v3), nflag <= cap)


# ── Passthrough / voxel ──────────────────────────────────────────────────────


def passthrough_fused(arrs, axis_index: int, lo, hi):
    return _compacted(arrs, passthrough_mask(arrs.xyz, arrs.valid,
                                             axis_index, lo, hi))


def voxel_fused(xyz, valid, voxel_size):
    """Voxel centroids, already leading-compact in sorted-key order, and
    their count."""
    centroids, out_valid = voxel_downsample_masked(xyz, valid, voxel_size)
    return _cloud.CloudTensors(xyz=centroids, valid=out_valid), out_valid.sum()
