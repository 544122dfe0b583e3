"""Voxel downsample (plain, fused with the sweep SOR ordering, and the
two-sort front end with its sort into sweep order), the passthrough mask
and the SOR keep mask: the counterparts of
`pointclouds_tpu/ops/filters.py`'s `_segment_sums`,
`voxel_downsample_masked`, `voxel_scan_sor_epilogue`,
`voxel_downsample_sweep_fused`, `voxel_downsample_sweep_frontend`,
`sweep_sort_compacted`, `passthrough_mask`, `sor_keep_mask(_thr)` and
`sor_mean_dists_from_knn`.

Centroid values are bitwise equal to the JAX package's: the canonical-key
stable sort groups each voxel's points in the same order, and the
segmented scan kernel replays the reference's f32 add tree.

Dropped keyword argument: ``use_kernel`` (the device of the input tensors
picks the CUDA kernel or its plain version).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.cloud import stable_argsort
from ..spatial.grid import INVALID_KEY, cell_coords, pack_cell_key, scalar_like
from ..spatial.kernels import segmented_scan_sums

INVALID32 = 2**31 - 1


def _segment_sums(first, sx, sy, sz, scnt):
    """Per-segment inclusive sums of (x, y, z, count); only segment-END
    values are consumed downstream."""
    return segmented_scan_sums(first.to(torch.float32).contiguous(),
                               sx.contiguous(), sy.contiguous(),
                               sz.contiguous(), scnt.contiguous())


def _scan_sorted(skey, invalid, sx, sy, sz):
    """The shared scan of rows stably sorted by voxel key (``invalid`` keys
    last): coordinates zeroed on invalid rows, segment starts and ends,
    and the per-segment sums (kernel ``segmented_scan_sums``). Returns
    (suse, first, is_end, (cx, cy, cz, ccnt))."""
    suse = skey != invalid
    sx, sy, sz = (torch.where(suse, v, 0.0) for v in (sx, sy, sz))
    ones = torch.ones(1, dtype=torch.bool, device=skey.device)
    first = torch.cat([ones, skey[1:] != skey[:-1]])
    is_end = torch.cat([first[1:], ones])
    return suse, first, is_end, _segment_sums(first, sx, sy, sz,
                                              suse.to(torch.float32))


def voxel_downsample_masked(xyz, valid, voxel_size):
    """Masked voxel-grid centroid downsample. ``voxel_size`` is taken as
    float32.

    Returns (centroids f32[N, 3], out_valid bool[N]): one centroid per
    occupied voxel in the leading rows, in ascending (ix, iy, iz) cell
    order; non-finite points are skipped."""
    n = xyz.shape[0]
    use = valid & torch.isfinite(xyz).all(dim=1)
    key = torch.where(use, pack_cell_key(cell_coords(xyz, voxel_size)),
                      INVALID_KEY)
    order = stable_argsort(key)
    skey = key[order]
    _, first, is_end, (cx, cy, cz, ccnt) = _scan_sorted(
        skey, INVALID_KEY, *(xyz[order, i] for i in range(3)))

    # Segment totals to the leading rows, in ascending key order.
    ends = stable_argsort((~is_end).to(torch.int32))
    ex, ey, ez, ecnt = cx[ends], cy[ends], cz[ends], ccnt[ends]
    nseg = first.sum()
    in_range = torch.arange(n, device=xyz.device) < nseg
    counts = torch.where(in_range, ecnt, 0.0)
    denom = torch.clamp(counts, min=1.0)
    centroids = torch.stack([ex / denom, ey / denom, ez / denom], dim=1)
    return centroids, counts > 0.0


def voxel_scan_sor_epilogue(skey, sx, sy, sz, ext_v, esc, *, factor: int,
                            ds_cap: int, table_size: int):
    """Back half of `voxel_downsample_sweep_fused`: rows already stably
    sorted by canonical voxel key (``skey`` ascending, invalid rows =
    2^31-1 last). Runs the segmented per-voxel sums and the single sor-order
    compaction sort. Returns dict(centroids f32[ds_cap, 3], out_valid,
    slin i32 ascending sor ids (table_size sentinel), canon i32,
    ds_overflow bool)."""
    suse, _, is_end, (cx, cy, cz, ccnt) = _scan_sorted(skey, INVALID32, sx,
                                                       sy, sz)

    # The only post-scan sort: sor-cell id for segment ends (table_size
    # otherwise); equal sor keys keep canonical voxel order.
    live = is_end & suse
    r0 = skey // (ext_v[1] * ext_v[2])
    r1 = (skey // ext_v[2]) % torch.clamp(ext_v[1], min=1)
    r2 = skey % torch.clamp(ext_v[2], min=1)
    lin_sc = ((r0 // factor) * esc[1] + r1 // factor) * esc[2] + r2 // factor
    lin_sc = torch.clamp(lin_sc, 0, table_size - 1)
    sorkey = torch.where(live, lin_sc, table_size).to(torch.int32)
    denom = torch.clamp(ccnt, min=1.0)
    order = stable_argsort(sorkey)
    ekey = sorkey[order]
    ex, ey, ez = (cx / denom)[order], (cy / denom)[order], (cz / denom)[order]
    ecanon = torch.where(live, skey, INVALID32).to(torch.int32)[order]
    ds_overflow = live.sum() > ds_cap

    slin = ekey[:ds_cap]
    out_valid = slin != table_size
    centroids = torch.stack(
        [torch.where(out_valid, e[:ds_cap], 0.0) for e in (ex, ey, ez)], dim=1
    )
    return dict(centroids=centroids, out_valid=out_valid, slin=slin,
                canon=ecanon[:ds_cap], ds_overflow=ds_overflow)


def _canonical_sort(xyz, valid, voxel_size, factor: int, table_size: int):
    """Sort 1 of the sweep front ends: the voxel lattice's origin ``mn_v``
    and extent ``ext_v``, the sor grid's extent ``esc`` (``factor`` voxels
    a cell), whether either grid outgrows its table, and the rows stably
    sorted by canonical voxel rank (lex (ix, iy, iz), the
    `voxel_downsample_masked` order; invalid rows 2^31-1, last) as
    ``skey``, ``sx``, ``sy``, ``sz``, with ``hi_cells``, the |coord| /
    sor-cell bound of the certificate margin."""
    use = valid & torch.isfinite(xyz).all(dim=1)
    c = cell_coords(xyz, voxel_size)
    big32 = 2**30
    mn_v = torch.where(use[:, None], c, big32).amin(dim=0)
    mn_v = torch.clamp(mn_v, max=big32 - 1).to(torch.int32)
    rel = torch.clamp(c - mn_v[None, :], min=0)
    mx_rel = torch.where(use[:, None], rel, 0).amax(dim=0).to(torch.int32)
    ext_v = mx_rel + 1
    ext64 = ext_v.to(torch.int64)
    esc = mx_rel // factor + 1
    esc64 = esc.to(torch.int64)
    table_overflow = ((esc64[0] * esc64[1] * esc64[2]) > table_size) | (
        (ext64[0] * ext64[1] * ext64[2]) > 2**31 - 2)

    rel64 = rel.to(torch.int64)
    ckey64 = (rel64[:, 0] * ext64[1] + rel64[:, 1]) * ext64[2] + rel64[:, 2]
    ckey = torch.where(use, torch.clamp(ckey64, 0, 2**31 - 2),
                       INVALID32).to(torch.int32)
    # Canonical order: the same per-voxel accumulation order as the JAX
    # package, so centroids stay bitwise equal.
    order = stable_argsort(ckey)
    hi_v = torch.maximum(mn_v.abs(), (mn_v + ext_v).abs()).amax().to(
        torch.float32)
    # (hi_v + f) / f as the reference computes it: XLA folds the division
    # by the constant into a multiply by its float32 reciprocal.
    hi_cells = (hi_v + float(factor)) * scalar_like(np.float32(1.0 / factor),
                                                    hi_v)
    return dict(mn_v=mn_v, ext_v=ext_v, esc=esc,
                table_overflow=table_overflow, hi_cells=hi_cells,
                skey=ckey[order], sx=xyz[order, 0], sy=xyz[order, 1],
                sz=xyz[order, 2])


def voxel_downsample_sweep_fused(xyz, valid, voxel_size, *, factor: int,
                                 ds_cap: int, table_size: int = 1 << 21):
    """Voxel-centroid downsample emitting rows directly in sor-cell-major
    sweep order (sor cell = ``factor`` voxels). ``voxel_size`` is taken as
    float32, as the JAX pipeline receives it.

    Returns a dict: centroids f32[ds_cap, 3], out_valid bool[ds_cap], slin
    i32[ds_cap] (ascending; table_size on invalid rows), canon i32[ds_cap]
    (canonical voxel rank), ds_overflow bool, extent i32[3] (sor grid),
    hi_cells f32, table_overflow bool, mn_v i32[3] (voxel-lattice origin).
    """
    g = _canonical_sort(xyz, valid, voxel_size, factor, table_size)
    ep = voxel_scan_sor_epilogue(
        g["skey"], g["sx"], g["sy"], g["sz"], g["ext_v"], g["esc"],
        factor=factor, ds_cap=ds_cap, table_size=table_size,
    )
    return dict(ep, extent=g["esc"], hi_cells=g["hi_cells"],
                table_overflow=g["table_overflow"], mn_v=g["mn_v"])


def voxel_downsample_sweep_frontend(xyz, valid, voxel_size, *,
                                    factor: int = 3,
                                    table_size: int = 1 << 21):
    """The two-sort voxel front end: sort 1 and the segmented scan of
    `voxel_downsample_sweep_fused` (kernel ``segmented_scan_sums``), then
    sort 2, the compaction of the voxels to the leading rows in canonical
    order, the `voxel_downsample_masked` order and values (bitwise).
    `sweep_sort_compacted` is its sort 3, into sweep order.

    Returns a dict: centroids_canon f32[N, 3] and out_valid bool[N]
    (compacted, canonical order), canon i32[N] (canonical voxel rank;
    2^31-1 on invalid rows), cxm, cym, czm f32[N] (the centroids'
    columns), ext_v i32[3] (voxel grid), extent i32[3] (sor grid),
    hi_cells f32, table_overflow bool."""
    n = xyz.shape[0]
    g = _canonical_sort(xyz, valid, voxel_size, factor, table_size)
    skey = g["skey"]
    _, first, is_end, (cx, cy, cz, ccnt) = _scan_sorted(
        skey, INVALID32, g["sx"], g["sy"], g["sz"])

    # Sort 2: segment ends to the front in canonical order, the rank key
    # riding along.
    ends = stable_argsort((~is_end).to(torch.int32))
    in_range = torch.arange(n, device=xyz.device) < first.sum()
    counts = torch.where(in_range, ccnt[ends], 0.0)
    out_valid = counts > 0.0
    denom = torch.clamp(counts, min=1.0)
    cxm, cym, czm = cx[ends] / denom, cy[ends] / denom, cz[ends] / denom
    canon = torch.where(out_valid, skey[ends], INVALID32).to(torch.int32)
    return dict(centroids_canon=torch.stack([cxm, cym, czm], dim=1),
                out_valid=out_valid, canon=canon, cxm=cxm, cym=cym, czm=czm,
                ext_v=g["ext_v"], extent=g["esc"], hi_cells=g["hi_cells"],
                table_overflow=g["table_overflow"])


def sweep_sort_compacted(cxm, cym, czm, canon, out_valid, ext_v, esc, *,
                         factor: int = 3, table_size: int = 1 << 21):
    """Sort 3 of the two-sort front end: the compacted (usually
    ds_cap-sliced) voxel rows into sor-cell-major sweep order, the sor cell
    decoded from the canonical rank. Returns (centroids f32[N, 3], valid
    bool[N], slin i32[N] ascending (table_size on invalid rows, at the
    tail), canon i32[N]): `structure_from_sorted`'s input."""
    ck = torch.where(out_valid, canon, 0)
    r0 = ck // (ext_v[1] * ext_v[2])
    r1 = (ck // ext_v[2]) % ext_v[1]
    r2 = ck % ext_v[2]
    lin_sc = ((r0 // factor) * esc[1] + r1 // factor) * esc[2] + r2 // factor
    lin_sc = torch.clamp(lin_sc, 0, table_size - 1)
    sorkey = torch.where(out_valid, lin_sc, table_size).to(torch.int32)
    order = stable_argsort(sorkey)
    skey = sorkey[order]
    svalid = skey != table_size
    centroids = torch.stack([torch.where(svalid, c[order], 0.0)
                             for c in (cxm, cym, czm)], dim=1)
    scanon = torch.where(out_valid, canon, INVALID32).to(torch.int32)[order]
    return centroids, svalid, skey, scanon


def passthrough_mask(xyz, valid, axis_index: int, lo, hi):
    """Keep-mask for finite lo <= v <= hi on one axis (bounds taken as
    float32)."""
    v = xyz[:, axis_index]
    lo = scalar_like(np.float32(lo), v)
    hi = scalar_like(np.float32(hi), v)
    return valid & torch.isfinite(v) & (v >= lo) & (v <= hi)


def sor_keep_mask_thr(mean_dists, valid, std_mul):
    """SOR keep mask (mean_dist <= mean + std_mul * population std over the
    finite means) and the float64 threshold itself."""
    finite = valid & torch.isfinite(mean_dists)
    md64 = mean_dists.to(torch.float64)
    n = torch.clamp(finite.to(torch.float64).sum(), min=1.0)
    mean = torch.where(finite, md64, 0.0).sum() / n
    var = torch.where(finite, (md64 - mean) ** 2, 0.0).sum() / n
    threshold = mean + float(std_mul) * torch.sqrt(var)
    keep = valid & (md64 <= threshold)
    return keep, threshold


def sor_keep_mask(mean_dists, valid, std_mul):
    return sor_keep_mask_thr(mean_dists, valid, std_mul)[0]


def sor_mean_dists_from_knn(neighbor_dists, neighbor_valid, query_finite):
    """Mean distance to the up-to-k nearest non-self neighbours, from
    [N, k+1] kNN results whose first column is the query itself (distance
    0): that column is skipped unless it is the only result; no result or
    a non-finite query gives +inf. The distances are summed one column at
    a time from 0.0 (the reduction order of the JAX package on the CPU,
    and the sweep's ascending order), so the mean does not depend on the
    device."""
    counts = neighbor_valid.sum(dim=1)
    use = neighbor_valid.clone()
    use[:, 0] &= counts <= 1
    denom = torch.clamp(use.sum(dim=1).to(torch.float32), min=1.0)
    total = torch.zeros(neighbor_dists.shape[0], dtype=torch.float32,
                        device=neighbor_dists.device)
    for j in range(neighbor_dists.shape[1]):
        total = total + torch.where(use[:, j], neighbor_dists[:, j], 0.0)
    return torch.where(query_finite & (counts > 0), total / denom, torch.inf)
