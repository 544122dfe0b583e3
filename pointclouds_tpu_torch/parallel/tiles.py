"""Spatial-tile points-axis sharding with explicit halo exchange: the
counterpart of `pointclouds_tpu/parallel/tiles.py`.

Each frame's points are split over the mesh's ``points`` axis by x-slabs
aligned to sor-cell boundaries, with four kinds of collective
(`comm.py`) over ``mesh.get_group("points")``:

1. ROUTE: a quantile histogram (`psum`) picks each tile's sor-x columns,
   one stable key sort groups the rows by destination and an `all_to_all`
   sends every raw point to its tile, which merges its segments with one
   sort. A single tile (points = 1) takes one canonical sort instead.
2. TILE-LOCAL VOXEL DOWNSAMPLE on the global voxel lattice (`pmin` /
   `pmax` of the cell bounds). A tile holds whole sor cells, and a sor
   cell whole voxels, so every voxel keeps its members in canonical
   order: centroids equal the unsharded op's (to the last bit, where the
   segmented scan's add tree sits at the same array offsets).
3. HALO: `ppermute` sends the ``halo_cells``-deep boundary slab to each x
   neighbour, so the tile-local SOR (or normals) sees every candidate the
   unsharded sweep would for the rows the tile owns. The SOR keep
   threshold folds the tiles' float64 sums with `psum`.
4. TAIL: the centroids are `all_gather`ed and RANSAC (on the canonical
   position order, so the hypotheses equal the unsharded run's), obstacle
   compaction and clustering run replicated on every rank: no further
   collective.

The reference's ``use_kernel`` has no counterpart: the device of the
tensors decides (kernels on the card, their plain versions on the CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.cloud import compaction_order, stable_argsort
from ..ops.filters import voxel_scan_sor_epilogue
from ..ops.normals import normals_from_moment_rows
from ..ops.segmentation import ransac_plane_masked
from ..spatial.grid import cell_coords, scalar_like
from ..spatial.sweep import (
    structure_from_sorted,
    sweep_cluster_labels,
    sweep_knn_moments_rows,
    sweep_sor_two_pass,
)
from .comm import (
    all_gather_tiled,
    all_to_all_tiled,
    axis_index,
    pmax,
    pmin,
    ppermute,
    psum,
)
from .sharding import gather_frames, shard_of

_INVALID32 = 2**31 - 1
_NBINS = 2048


def _round128(v: int) -> int:
    return max(((int(v) + 127) // 128) * 128, 128)


def _caps(n: int, p: int, tile_slack: float):
    """(pair_cap, ds_tile_cap, halo_cap). pair_cap bounds the rows one
    source rank routes to one tile: ~n / P^2 on spatially mixed row orders
    (real scans, the scene generators); a spatially sorted input can skew
    a pair up to n / P, which the route flag reports."""
    pair_cap = (_round128(int(n // p // p * tile_slack)) if p > 1
                else _round128(n))
    return (pair_cap, _round128(p * pair_cap),
            _round128(max(n // (p * 8), 1024)))


class TiledKittiOutput(NamedTuple):
    plane_normal: torch.Tensor  # f32[B, 3]
    plane_d: torch.Tensor  # f32[B]
    centroids: torch.Tensor  # f32[B, P*DCAP, 3] gathered, tile-major order
    downsampled_valid: torch.Tensor  # bool[B, P*DCAP]
    cleaned_valid: torch.Tensor  # bool[B, P*DCAP] after SOR
    obstacle_xyz: torch.Tensor  # f32[B, CAP, 3] (tile-major gathered order)
    obstacle_valid: torch.Tensor  # bool[B, CAP]
    labels: torch.Tensor  # i32[B, CAP] cluster labels over obstacle slots
    cleaned_count: torch.Tensor  # i32[B]
    sor_certified: torch.Tensor  # bool[B]
    cluster_exact: torch.Tensor  # bool[B]
    flags: torch.Tensor  # bool[B, 4]: route/ds/halo overflow, obstacle ovf


def _lattice(xyz, valid, voxel, factor: int, table_size: int, group):
    """The global voxel lattice over the tiles (`pmin` / `pmax`): (ckey
    i32[n] canonical voxel keys, 2^31-1 on unused rows; use; mn_v; ext_v;
    esc, the sor grid's extent; table_overflow)."""
    use = valid & torch.isfinite(xyz).all(dim=1)
    c = cell_coords(xyz, voxel)
    big32 = 2**30
    mn_loc = torch.where(use[:, None], c, big32).amin(dim=0)
    mn_v = torch.clamp(pmin(mn_loc, group), max=big32 - 1)
    rel = torch.clamp(c - mn_v[None, :], min=0)
    mx_rel = pmax(torch.where(use[:, None], rel, 0).amax(dim=0), group)
    ext_v = mx_rel + 1
    ext64 = ext_v.to(torch.int64)
    esc = mx_rel // factor + 1
    esc64 = esc.to(torch.int64)
    table_overflow = ((esc64[0] * esc64[1] * esc64[2]) > table_size) | (
        (ext64[0] * ext64[1] * ext64[2]) > 2**31 - 2)
    rel64 = rel.to(torch.int64)
    ckey64 = (rel64[:, 0] * ext64[1] + rel64[:, 1]) * ext64[2] + rel64[:, 2]
    ckey = torch.where(use, torch.clamp(ckey64, 0, 2**31 - 2),
                       _INVALID32).to(torch.int32)
    return ckey, use, mn_v, ext_v, esc, table_overflow


def _route_to_tiles(ckey, xyz, use, ext_v, esc, *, p: int, factor: int,
                    pair_cap: int, group):
    """Quantile route + `all_to_all` + local merge, shared by the tiled
    pipelines. Returns (mkey, mx, my, mz, route_overflow, lo_t, hi_t): this
    tile's merged rows in canonical order and its sor-x column range [lo_t,
    hi_t)."""
    dev = ckey.device
    if p == 1:
        # One tile: one canonical sort is the merged frame.
        order = stable_argsort(ckey)
        return (ckey[order], xyz[order, 0], xyz[order, 1], xyz[order, 2],
                torch.zeros((), dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.clamp(esc[0], min=1))

    # Quantile boundaries: tiles own equal point counts. A psum'd
    # histogram over binned sor-x columns gives the global cdf; whole sor-x
    # columns fall in one bin, so tile edges stay on sor cells.
    t = axis_index(group)
    esc0 = torch.clamp(esc[0], min=1).to(torch.int64)
    eyz_v = torch.clamp(ext_v[1] * ext_v[2], min=1)

    def bin_of(keys):
        r0 = keys // eyz_v
        return torch.clamp((r0 // factor).to(torch.int64) * _NBINS // esc0,
                           0, _NBINS - 1)

    hist = torch.zeros(_NBINS, dtype=torch.int32, device=dev)
    hist.index_add_(0, torch.where(use, bin_of(ckey), _NBINS - 1),
                    use.to(torch.int32))
    hist = psum(hist, group)
    csum = torch.cumsum(hist, 0, dtype=torch.int64)
    cdf_ex = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        csum[:-1]])
    total = torch.clamp(csum[-1], min=1)
    dest_of_bin = torch.clamp(cdf_ex * p // total, 0, p - 1)  # monotone
    # Tile sor-x bounds: bin b covers sor-x [ceil(b esc0 / nbins), ...).
    lo_bin = (dest_of_bin < t).sum()
    hi_bin = (dest_of_bin <= t).sum()
    lo_t = (-((-lo_bin * esc0) // _NBINS)).to(torch.int32)
    hi_t = (-((-hi_bin * esc0) // _NBINS)).to(torch.int32)
    # One stable key sort groups rows by destination and orders each group
    # canonically: dest is non-decreasing in the sor-x column, which the
    # canonical key orders first.
    order = stable_argsort(ckey)
    skey = ckey[order]
    sxyz = xyz[order]
    sdest = torch.where(skey != _INVALID32, dest_of_bin[bin_of(skey)], p)
    cnt = (sdest[None, :] == torch.arange(p, device=dev)[:, None]).sum(dim=1)
    off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                     torch.cumsum(cnt, 0)[:-1]])
    route_overflow = (cnt > pair_cap).any()
    slot = torch.arange(p * pair_cap, device=dev)
    d_of, i_of = slot // pair_cap, slot % pair_cap
    in_seg = i_of < cnt[d_of]
    src = torch.where(in_seg, torch.clamp(off[d_of] + i_of,
                                          max=skey.shape[0] - 1), 0)
    send_key = torch.where(in_seg, skey[src], _INVALID32)
    send_xyz = torch.where(in_seg[:, None], sxyz[src], 0.0)
    rkey = all_to_all_tiled(send_key, group)
    rxyz = all_to_all_tiled(send_xyz, group)
    # Merge the P received (already sorted) segments: one local sort.
    morder = stable_argsort(rkey)
    m = rxyz[morder]
    return (rkey[morder], m[:, 0], m[:, 1], m[:, 2], route_overflow, lo_t,
            hi_t)


def _slice(v, start, size: int):
    """``v[start:start + size]`` along axis 0 for a 0-d device ``start``
    (no host read; ``lax.dynamic_slice`` with the start in range)."""
    return v[start + torch.arange(size, device=v.device)]


def _halo_merge(centroids, ds_valid, slin, esc, lo_t, hi_t, *, p: int,
                halo_cells: int, halo_cap: int, ds_tile_cap: int,
                table_size: int, group):
    """Exchange ``halo_cells``-deep boundary sor-cell slabs with the x
    neighbours and merge (left halo | own | right halo), still globally
    sorted. Returns (m_xyz, m_valid, m_slin, nli, halo_overflow): the
    merged rows (own rows from ``nli``) for a prebuilt sweep structure
    whose owned-row results match the unsharded op's.

    ``halo_overflow`` is the reference's, p == 1 included: there a single
    tile still counts its boundary slabs against ``halo_cap`` though no
    neighbour takes them, and the port reports that flag as it does."""
    dev = centroids.device
    eyz = torch.clamp(esc[1], min=1) * torch.clamp(esc[2], min=1)
    row_sx = torch.where(ds_valid, slin // eyz, _INVALID32)
    nown = ds_valid.sum()
    h = halo_cells
    slots = torch.arange(halo_cap, device=dev)

    # Rows for the LEFT neighbour: sor-x < lo_t + h, an ascending prefix.
    cl = (ds_valid & (row_sx < lo_t + h)).sum()
    lvalid = slots < torch.clamp(cl, max=halo_cap)
    lkey = torch.where(lvalid, slin[:halo_cap], table_size)
    lxyz = torch.where(lvalid[:, None], centroids[:halo_cap], 0.0)

    # Rows for the RIGHT neighbour: sor-x >= hi_t - h, a suffix of the
    # valid rows, front-aligned.
    cr = (ds_valid & (row_sx >= hi_t - h)).sum()
    rstart = torch.clamp(nown - cr, 0, ds_tile_cap - 1)
    rs = torch.clamp(rstart, max=ds_tile_cap - halo_cap)
    rrows = _slice(slin, rs, halo_cap)
    rxyz_s = _slice(centroids, rs, halo_cap)
    roff = rstart - rs  # the qualifying run starts here within the slice
    rvalid = (slots >= roff) & (slots < roff + torch.clamp(cr, max=halo_cap))
    rsel = torch.clamp(slots + roff, max=halo_cap - 1)
    rvalid_f = rvalid[rsel]
    rkey_h = torch.where(rvalid_f, rrows[rsel], table_size)
    rxyz_h = torch.where(rvalid_f[:, None], rxyz_s[rsel], 0.0)

    # One [5, halo_cap] f32 message a direction: key bits, x, y, z and the
    # validity channel; `ppermute` zero-fills a tile with no neighbour, so
    # v = 0 marks both "no neighbour" and pad slots (a key-based test
    # would mistake sor cell 0).
    def pack(key, xyz3, valid):
        return torch.cat([key.to(torch.int32).view(torch.float32)[None],
                          xyz3.T, valid.to(torch.float32)[None]])

    # left_in: the LEFT neighbour's right-going slab (ids all below mine).
    li = ppermute(pack(rkey_h, rxyz_h, rvalid_f),
                  [(i, i + 1) for i in range(p - 1)], group)
    ri = ppermute(pack(lkey, lxyz, lvalid),
                  [(i, i - 1) for i in range(1, p)], group)
    li_v, ri_v = li[4] > 0.5, ri[4] > 0.5
    li_key = torch.where(li_v, li[0].contiguous().view(torch.int32),
                         table_size)
    ri_key = torch.where(ri_v, ri[0].contiguous().view(torch.int32),
                         table_size)
    nli, nri = li_v.sum(), ri_v.sum()

    # ── Merge (left halo | own | right halo), still globally sorted ──
    mcap = halo_cap + ds_tile_cap + halo_cap
    j = torch.arange(mcap, device=dev)
    nm = nli + nown + nri
    src_m = torch.where(
        j < nli, j,
        torch.where(j < nli + nown, halo_cap + (j - nli),
                    halo_cap + ds_tile_cap
                    + torch.clamp(j - nli - nown, 0, halo_cap - 1)))
    mvalid = j < nm
    src_m = torch.where(mvalid, src_m, 0)
    all_key = torch.cat([li_key, torch.where(ds_valid, slin, table_size),
                         ri_key])
    all_xyz = torch.cat([li[1:4].T, centroids, ri[1:4].T])
    m_slin = torch.where(mvalid, all_key[src_m], table_size).to(torch.int32)
    m_xyz = torch.where(mvalid[:, None], all_xyz[src_m], 0.0)
    m_valid = mvalid & (m_slin < table_size)
    return (m_xyz, m_valid, m_slin, nli,
            (cl > halo_cap) | (cr > halo_cap))


def _merged_structure(m_xyz, m_valid, m_slin, esc, mn_v, ext_v, voxel,
                      factor: int, table_overflow, table_size: int):
    """The prebuilt sweep structure of the merged rows, on the global
    voxel lattice."""
    hi_v = torch.maximum(mn_v.abs(), (mn_v + ext_v).abs()).amax().to(
        torch.float32)
    # (hi_v + f) / f as the reference computes it: XLA folds the division
    # by the constant into a multiply by its float32 reciprocal.
    hi_cells = (hi_v + float(factor)) * scalar_like(np.float32(1.0 / factor),
                                                    hi_v)
    return structure_from_sorted(
        m_xyz, m_valid, m_slin, esc, hi_cells, table_overflow, wr=4,
        table_size=table_size, grid_origin=(mn_v, float(voxel), factor))


def _canonical_rows(canon, ds_valid, keep, group):
    """Gathered (keep, valid) and the canonical position map of the kept
    rows: position p -> the gathered row of the p-th kept centroid in
    canonical voxel order (the unsharded pipeline's RANSAC order; the keys
    live on the global lattice)."""
    packed = torch.stack([torch.where(ds_valid, canon, _INVALID32),
                          keep.to(torch.int32), ds_valid.to(torch.int32)],
                         dim=1)
    g = all_gather_tiled(packed, group)
    g_keep, g_valid = g[:, 1] > 0, g[:, 2] > 0
    position_rows = stable_argsort(torch.where(g_keep, g[:, 0], _INVALID32))
    return g_keep, g_valid, position_rows


def _obstacles(g_xyz, obstacle, obstacle_cap: int):
    order = compaction_order(obstacle)
    obs_src = order[:obstacle_cap]
    return (obstacle[obs_src], g_xyz[obs_src],
            obstacle.sum() > obstacle_cap)


class _Front(NamedTuple):
    voxel: torch.Tensor  # the voxel edge as a 0-d tensor
    ep: dict  # `voxel_scan_sor_epilogue`'s outputs on this tile
    xyz: torch.Tensor  # the merged frame (halo, owned, halo), f32[M, 3]
    valid: torch.Tensor  # bool[M]
    nli: torch.Tensor  # the owned rows' offset in the merged frame
    flags: torch.Tensor  # bool[3]: this tile's route/ds/halo overflow
    table_overflow: torch.Tensor  # the sor grid outgrew its table
    prebuilt: dict  # the merged frame's sweep structure


def _tile_front(xyz, valid, voxel, *, p: int, factor: int, pair_cap: int,
                ds_tile_cap: int, halo_cap: int, halo_cells: int,
                table_size: int, group) -> _Front:
    """The front end both tiled frames share: the global lattice, the route
    to the tiles, the tile-local voxel downsample and the halo merge, with
    the merged frame's sweep structure."""
    voxel_t = scalar_like(np.float32(voxel), xyz)
    ckey, use, mn_v, ext_v, esc, table_overflow = _lattice(
        xyz, valid, voxel_t, factor, table_size, group)
    mkey, mx, my, mz, route_overflow, lo_t, hi_t = _route_to_tiles(
        ckey, xyz, use, ext_v, esc, p=p, factor=factor, pair_cap=pair_cap,
        group=group)

    # ── Tile-local voxel downsample (global lattice) ──
    ep = voxel_scan_sor_epilogue(mkey, mx, my, mz, ext_v, esc, factor=factor,
                                 ds_cap=ds_tile_cap, table_size=table_size)

    # ── Halo exchange + merge ──
    m_xyz, m_valid, m_slin, nli, halo_ovf = _halo_merge(
        ep["centroids"], ep["out_valid"], ep["slin"], esc, lo_t, hi_t, p=p,
        halo_cells=halo_cells, halo_cap=halo_cap, ds_tile_cap=ds_tile_cap,
        table_size=table_size, group=group)
    prebuilt = _merged_structure(m_xyz, m_valid, m_slin, esc, mn_v, ext_v,
                                 np.float32(voxel), factor, table_overflow,
                                 table_size)
    return _Front(voxel_t, ep, m_xyz, m_valid, nli,
                  torch.stack([route_overflow, ep["ds_overflow"], halo_ovf]),
                  table_overflow, prebuilt)


def _tiled_frame(xyz, valid, voxel, sor_std, ransac_thresh, seed, cluster_r,
                 *, p: int, factor: int, sor_k: int, ransac_iters: int,
                 ransac_subsample, obstacle_cap: int, pair_cap: int,
                 ds_tile_cap: int, halo_cap: int, halo_cells: int,
                 table_size: int, group):
    """One KITTI frame on one tile: ``xyz`` is this rank's raw row shard
    [n/P, 3]."""
    f = _tile_front(xyz, valid, voxel, p=p, factor=factor, pair_cap=pair_cap,
                    ds_tile_cap=ds_tile_cap, halo_cap=halo_cap,
                    halo_cells=halo_cells, table_size=table_size, group=group)
    centroids, ds_valid = f.ep["centroids"], f.ep["out_valid"]

    # ── Tile-local SOR on the merged frame ──
    # The reference's ``per_seg`` (the TPU kernel's lane certificate) has no
    # counterpart: the port's selection is an exact top-k.
    means_m, ok_m, _, lb_m = sweep_sor_two_pass(
        f.xyz, f.valid, f.voxel * float(factor), k=sor_k,
        rescue_cells=float(halo_cells), prebuilt=f.prebuilt, row_cap=12,
        with_lb=True)
    means, ok_own, lb_own = (_slice(v, f.nli, ds_tile_cap)
                             for v in (means_m, ok_m, lb_m))

    # Global keep threshold: psum'd float64 mean and variance of the finite
    # mean distances (`sor_keep_mask`'s float64 accumulation).
    fin = ds_valid & torch.isfinite(means)
    m64 = means.to(torch.float64)
    s01 = psum(torch.stack([fin.to(torch.float64).sum(),
                            torch.where(fin, m64, 0.0).sum()]), group)
    n0 = torch.clamp(s01[0], min=1.0)
    gmean = s01[1] / n0
    s2 = psum(torch.where(fin, (m64 - gmean) ** 2, 0.0).sum(), group)
    thr = gmean + float(np.float32(sor_std)) * torch.sqrt(s2 / n0)
    keep = ds_valid & (m64 <= thr)
    # Keep-decision certificate: exact mean, an upper bound that keeps, or
    # a proven lower bound above the threshold.
    decision_ok = ok_own | keep | (lb_own.to(torch.float64) > thr)
    cert_loc = (decision_ok | ~ds_valid).all() & ~f.table_overflow

    # ── TAIL (replicated): gather, RANSAC, obstacles, clustering ──
    g_xyz = all_gather_tiled(centroids, group)
    g_keep, g_valid, position_rows = _canonical_rows(f.ep["canon"], ds_valid,
                                                     keep, group)
    normal, d, inlier = ransac_plane_masked(
        g_xyz, g_keep, ransac_thresh, seed, ransac_iters,
        score_subsample=ransac_subsample,
        adaptive=(ransac_subsample is None), position_rows=position_rows)
    obs_valid, obs_xyz, obs_overflow = _obstacles(g_xyz, g_keep & ~inlier,
                                                  obstacle_cap)
    labels, cluster_exact = sweep_cluster_labels(
        obs_xyz, obs_valid, np.float32(cluster_r), wr=12)

    # One pmax for the three tile flags and the certificate's pmin (as a
    # max of its negation), one psum for the kept count.
    tile_flags = pmax(torch.cat([f.flags, (~cert_loc)[None]]
                                ).to(torch.int32), group) > 0
    return TiledKittiOutput(
        plane_normal=normal,
        plane_d=d,
        centroids=g_xyz,
        downsampled_valid=g_valid,
        cleaned_valid=g_keep,
        obstacle_xyz=obs_xyz,
        obstacle_valid=obs_valid,
        labels=labels,
        cleaned_count=psum(keep.sum().to(torch.int32), group),
        sor_certified=~tile_flags[3],
        cluster_exact=cluster_exact,
        flags=torch.cat([tile_flags[:3], obs_overflow[None]]),
    )


def _points_group(mesh):
    return mesh.get_group("points"), mesh.mesh.shape[1]


def tiled_kitti_pipeline(mesh, n: int, *, sor_k: int = 20,
                         ransac_iters: int = 500,
                         ransac_subsample: int | None = 4096,
                         obstacle_cap: int = 16384, sor_cell_factor: int = 3,
                         halo_cells: int = 4, tile_slack: float = 1.3,
                         table_size: int = 1 << 21):
    """The tiled KITTI pipeline over ``mesh`` ("frames", "points"):
    (xyz [B, n, 3], valid [B, n], voxel, sor_std, ransac_thresh, seeds [B],
    cluster_r) -> `TiledKittiOutput` batched over frames. ``n`` is the
    per-frame point capacity. Every rank is given the whole batch, works
    on its block (`sharding.shard_of`) and returns the whole output."""
    group, p = _points_group(mesh)
    pair_cap, ds_tile_cap, halo_cap = _caps(n, p, tile_slack)

    def step(xyz, valid, voxel, sor_std, ransac_thresh, seeds, cluster_r):
        xs, vs = (shard_of(torch.as_tensor(a), mesh) for a in (xyz, valid))
        outs = [_tiled_frame(
            x, v, voxel, sor_std, ransac_thresh, int(s), cluster_r, p=p,
            factor=int(sor_cell_factor), sor_k=sor_k,
            ransac_iters=ransac_iters, ransac_subsample=ransac_subsample,
            obstacle_cap=obstacle_cap, pair_cap=pair_cap,
            ds_tile_cap=ds_tile_cap, halo_cap=halo_cap,
            halo_cells=halo_cells, table_size=table_size, group=group)
            for x, v, s in zip(xs, vs, shard_of(np.asarray(seeds), mesh))]
        return gather_frames(outs, mesh)

    return step


class TiledAerialOutput(NamedTuple):
    plane_normal: torch.Tensor  # f32[B, 3]
    plane_d: torch.Tensor  # f32[B]
    centroids: torch.Tensor  # f32[B, P*DCAP, 3] gathered, tile-major order
    downsampled_valid: torch.Tensor  # bool[B, P*DCAP]
    normals: torch.Tensor  # f32[B, P*DCAP, 3]
    normals_ok: torch.Tensor  # bool[B, P*DCAP]
    obstacle_xyz: torch.Tensor  # f32[B, CAP, 3]
    obstacle_valid: torch.Tensor  # bool[B, CAP]
    labels: torch.Tensor  # i32[B, CAP]
    cluster_exact: torch.Tensor  # bool[B]
    flags: torch.Tensor  # bool[B, 4]: route/ds/halo overflow, obstacle ovf


def _tiled_aerial_frame(xyz, valid, voxel, ransac_thresh, seed, cluster_r,
                        viewpoint, *, p: int, factor: int, normals_k: int,
                        ransac_iters: int, ransac_subsample,
                        obstacle_cap: int, pair_cap: int, ds_tile_cap: int,
                        halo_cap: int, halo_cells: int, table_size: int,
                        cluster_wr: int, group):
    """One aerial frame on one tile: route -> tile-local voxel -> halo ->
    tile-local kNN-moments normals -> replicated RANSAC + cluster tail. The
    moments search reaches one normals cell (``factor`` voxels), so a
    one-cell halo gives owned rows the unsharded candidate sets."""
    f = _tile_front(xyz, valid, voxel, p=p, factor=factor, pair_cap=pair_cap,
                    ds_tile_cap=ds_tile_cap, halo_cap=halo_cap,
                    halo_cells=halo_cells, table_size=table_size, group=group)
    centroids, ds_valid = f.ep["centroids"], f.ep["out_valid"]

    # ── Tile-local kNN-moments normals on the merged frame ──
    m1r, m2r, cnt, nok_m = sweep_knn_moments_rows(
        f.xyz, f.valid, f.voxel * float(factor), k=normals_k,
        prebuilt=f.prebuilt)
    cols = f.nli + torch.arange(ds_tile_cap, device=xyz.device)
    normals = normals_from_moment_rows(
        m1r[:, cols], m2r[:, cols], cnt[cols], centroids,
        torch.as_tensor(viewpoint, dtype=torch.float32, device=xyz.device))
    nok = nok_m[cols]

    # ── TAIL (replicated): gather, RANSAC, obstacles, clustering ──
    g = all_gather_tiled(torch.cat([centroids, normals], dim=1), group)
    g_xyz, g_normals = g[:, :3].contiguous(), g[:, 3:].contiguous()
    g_nok = all_gather_tiled(nok.to(torch.uint8), group).bool()
    _, g_valid, position_rows = _canonical_rows(f.ep["canon"], ds_valid,
                                                ds_valid, group)
    normal, d, inlier = ransac_plane_masked(
        g_xyz, g_valid, ransac_thresh, seed, ransac_iters,
        score_subsample=ransac_subsample,
        adaptive=(ransac_subsample is None), position_rows=position_rows)
    obs_valid, obs_xyz, obs_overflow = _obstacles(g_xyz, g_valid & ~inlier,
                                                  obstacle_cap)
    labels, cluster_exact = sweep_cluster_labels(
        obs_xyz, obs_valid, np.float32(cluster_r), wr=cluster_wr,
        rep_labels=False, row_cap=None)
    tile_flags = pmax(f.flags.to(torch.int32), group) > 0
    return TiledAerialOutput(
        plane_normal=normal,
        plane_d=d,
        centroids=g_xyz,
        downsampled_valid=g_valid,
        normals=g_normals,
        normals_ok=g_nok,
        obstacle_xyz=obs_xyz,
        obstacle_valid=obs_valid,
        labels=labels,
        cluster_exact=cluster_exact,
        flags=torch.cat([tile_flags, obs_overflow[None]]),
    )


def tiled_aerial_pipeline(mesh, n: int, *, normals_k: int = 15,
                          normals_cell_factor: int = 6,
                          ransac_iters: int = 300,
                          ransac_subsample: int | None = 4096,
                          obstacle_cap: int = 262_144, cluster_wr: int = 12,
                          halo_cells: int = 1, tile_slack: float = 1.3,
                          table_size: int = 1 << 21):
    """The tiled aerial pipeline over ``mesh`` ("frames", "points"): (xyz
    [B, n, 3], valid [B, n], voxel, ransac_thresh, seeds [B], cluster_r,
    viewpoint f32[3]) -> `TiledAerialOutput` batched over frames. The
    normals certification cell is ``normals_cell_factor`` voxels (6 x 0.5 m
    = the demo's 3.0 m)."""
    group, p = _points_group(mesh)
    pair_cap, ds_tile_cap, halo_cap = _caps(n, p, tile_slack)

    def step(xyz, valid, voxel, ransac_thresh, seeds, cluster_r, viewpoint):
        xs, vs = (shard_of(torch.as_tensor(a), mesh) for a in (xyz, valid))
        outs = [_tiled_aerial_frame(
            x, v, voxel, ransac_thresh, int(s), cluster_r, viewpoint, p=p,
            factor=int(normals_cell_factor), normals_k=normals_k,
            ransac_iters=ransac_iters, ransac_subsample=ransac_subsample,
            obstacle_cap=obstacle_cap, pair_cap=pair_cap,
            ds_tile_cap=ds_tile_cap, halo_cap=halo_cap,
            halo_cells=halo_cells, table_size=table_size,
            cluster_wr=cluster_wr, group=group)
            for x, v, s in zip(xs, vs, shard_of(np.asarray(seeds), mesh))]
        return gather_frames(outs, mesh)

    return step
