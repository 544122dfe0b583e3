"""Voxel downsample (fused with the sweep SOR ordering) and the SOR keep
mask: the counterparts of `pointclouds_tpu/ops/filters.py`'s
`_segment_sums`, `voxel_scan_sor_epilogue`, `voxel_downsample_sweep_fused`
and `sor_keep_mask_thr`.

Centroid values are bitwise equal to the JAX package's: the canonical-key
stable sort groups each voxel's points in the same order, and the
segmented scan kernel replays the reference's f32 add tree.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.cloud import stable_argsort
from ..spatial.grid import cell_coords, scalar_like
from ..spatial.kernels import segmented_scan_sums

INVALID32 = 2**31 - 1


def _segment_sums(first, sx, sy, sz, scnt):
    """Per-segment inclusive sums of (x, y, z, count); only segment-END
    values are consumed downstream."""
    return segmented_scan_sums(first.to(torch.float32).contiguous(),
                               sx.contiguous(), sy.contiguous(),
                               sz.contiguous(), scnt.contiguous())


def voxel_scan_sor_epilogue(skey, sx, sy, sz, ext_v, esc, *, factor: int,
                            ds_cap: int, table_size: int):
    """Back half of `voxel_downsample_sweep_fused`: rows already stably
    sorted by canonical voxel key (``skey`` ascending, invalid rows =
    2^31-1 last). Runs the segmented per-voxel sums and the single sor-order
    compaction sort. Returns dict(centroids f32[ds_cap, 3], out_valid,
    slin i32 ascending sor ids (table_size sentinel), canon i32,
    ds_overflow bool)."""
    suse = skey != INVALID32
    sx = torch.where(suse, sx, 0.0)
    sy = torch.where(suse, sy, 0.0)
    sz = torch.where(suse, sz, 0.0)
    scnt = suse.to(torch.float32)
    ones = torch.ones(1, dtype=torch.bool, device=skey.device)
    first = torch.cat([ones, skey[1:] != skey[:-1]])
    is_end = torch.cat([first[1:], ones])
    cx, cy, cz, ccnt = _segment_sums(first, sx, sy, sz, scnt)

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
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
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

    # Sort 1, canonical order: the same per-voxel accumulation order as the
    # JAX package, so centroids stay bitwise equal.
    order = stable_argsort(ckey)
    ep = voxel_scan_sor_epilogue(
        ckey[order], x[order], y[order], z[order], ext_v, esc, factor=factor,
        ds_cap=ds_cap, table_size=table_size,
    )
    hi_v = torch.maximum(mn_v.abs(), (mn_v + ext_v).abs()).amax().to(
        torch.float32)
    # (hi_v + f) / f as the reference computes it: XLA folds the division
    # by the constant into a multiply by its float32 reciprocal.
    hi_cells = (hi_v + float(factor)) * scalar_like(np.float32(1.0 / factor),
                                                    hi_v)
    return dict(ep, extent=esc, hi_cells=hi_cells,
                table_overflow=table_overflow, mn_v=mn_v)


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
