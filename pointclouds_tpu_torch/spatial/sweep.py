"""Sorted-window sweep: SOR neighbour means, radius counts, kNN moments,
kNN and cluster labels over cell-sorted planar rows.

Counterpart of `pointclouds_tpu/spatial/sweep.py`, ported for the paths of
the KITTI and aerial pipelines and of the per-op API:
the structure built on rows already sorted by sor cell
(`structure_from_sorted`) or sorted here (`_sorted_structure`), SOR pass 1
over flat per-block row lists or the nine windows (on its own:
`sweep_sor_mean_dists`), the AABB-pruned exact rescue with optional lower
bounds (`sweep_sor_two_pass`), radius counts
with and without their rescue (`sweep_radius_count(_two_pass)`), kNN
moments with and without the exact rescue (`sweep_knn_moments(_rows)`,
`sweep_moments_two_pass_rows`), the cluster labels over row lists or the
nine windows (`sweep_cluster_labels`), and the all-points and cross-cloud
kNN with their rescue (`sweep_knn`, `sweep_knn_two_pass`,
`sweep_knn_cross_two_pass`).

Points sorted by linearized cell id (z fastest) pack 128 to a planar row
``[x*128 | y*128 | z*128 | w*128]``; for a block of 128 consecutive sorted
queries the union of their 27-cell neighbourhoods is nine contiguous row
windows, flattened into one candidate row list per block. Every neighbour
query is certified exact or flagged, as in the reference.

Dropped keyword arguments: ``use_kernel`` and ``interpret`` (the device of
the input tensors picks the CUDA kernel or its plain version) and
``per_seg`` (the Pallas kernels' per-segment certificate width; the CUDA
kernels select exactly, so every segment is certified).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.cloud import compaction_order, stable_argsort
from ..utils import profiling
from .grid import scalar_like
from .kernels import (
    cluster_multisweep,
    cluster_multisweep_windows,
    cluster_propagate,
    count_within,
    fma_f32,
    rescue_knn_idx,
    rescue_radius_count_groups,
    rescue_select,
    sweep_moments,
    sweep_knn_select,
    sweep_select,
    sweep_select_rows,
)

SWEEP_TABLE_SIZE = 1 << 21
NSHIFT = 9
RESCUE_GROUP_ROWS = 8  # candidate rows (of 128 points) per prune group
# The reference's dispatch rule for clustering (its VMEM residency gate,
# `pointclouds_tpu/spatial/sweep.py`): above this many bytes of an 8-channel
# planar pack, `sweep_cluster_labels` iterates single hops (kernel
# `cluster_propagate`) instead of the propagation rounds. The card has no
# such limit; the port keeps the rule so that both packages run the same
# algorithm on the same input.
CLUSTER_RESIDENT_BYTES = 32 * 1024 * 1024  # 2^20 rows


def _shift_offsets(extent):
    """[9] linear-id offsets for the (dx, dy) in {-1,0,1}^2 shifts."""
    return torch.stack([(dx * extent[1] + dy) * extent[2]
                        for dx in (-1, 0, 1) for dy in (-1, 0, 1)])


def _window_starts(slin_p, suse_p, extent, nrows, nb, wr, table_size):
    """Per-block window pack (start, skip, length, has-valid) and the
    per-block length certificate, for the same-cloud sweep."""
    blocks = slin_p[: nb * 128].reshape(nb, 128)
    has_valid = suse_p[: nb * 128].reshape(nb, 128).any(dim=1)
    with profiling.span("windows"):
        return _window_starts_from_bounds(blocks[:, 0], blocks[:, -1],
                                          has_valid, slin_p, suse_p, extent,
                                          nrows, nb, wr, table_size)


def _window_starts_from_bounds(lo, hi, has_valid, slin_p, suse_p, extent,
                               nrows, p_nb, wr, table_size):
    """Window pack for query blocks with first/last cell ids ``lo``/``hi``
    against the cell-sorted point rows. Returns (starts_pack i32[NB, 28]:
    9 window starts, 9 dedup skips, 9 lengths, has-valid; block_ok)."""
    nb = lo.shape[0]
    dev = lo.device
    sh = _shift_offsets(extent).to(torch.int32)
    a = torch.clamp(lo[:, None] + sh[None, :] - 1, 0, table_size)
    zhi = torch.clamp(hi[:, None] + sh[None, :] + 1, 0, table_size)

    # first_row(c) = #rows with cell id < c, by binary search in the
    # cell-sorted point blocks at every size (the reference's block compare
    # and dense-table scan give the same counts). The wr padding past the
    # blocks holds sentinels only, which the clamp to the valid rows drops.
    rows = torch.searchsorted(slin_p[: p_nb * 128],
                              torch.cat([a, zhi + 1], dim=1), out_int32=True)
    first_row, last_row_raw = rows[:, :NSHIFT], rows[:, NSHIFT:]

    # Exclusive end, clamped to the valid row count.
    n_use_rows = suse_p.sum().to(torch.int32)
    last_row = torch.minimum(last_row_raw, n_use_rows)
    start = torch.clamp(first_row // 128, 0, nrows - wr)
    win_ok = (first_row >= start * 128) & (last_row <= (start + wr) * 128)
    win_ok = win_ok | (first_row >= last_row)
    block_ok = win_ok.all(dim=1)

    need_end = torch.clamp(-((-last_row) // 128) - start, 0, wr)
    length = torch.where(first_row >= last_row, 0, need_end)

    # Dedup overlapping windows: a candidate read twice would be counted
    # twice by the k-smallest selection.
    cover_end = torch.cummax(start + length, dim=1).values
    prev_end = torch.cat(
        [torch.zeros((nb, 1), dtype=cover_end.dtype, device=dev),
         cover_end[:, :-1]], dim=1)
    skip = torch.clamp(prev_end - start, 0, wr)
    pack = torch.cat([start, skip, length,
                      has_valid.to(torch.int32)[:, None]], dim=1)
    return pack.to(torch.int32), block_ok


def _window_row_lists(starts_skip, cap: int, nmax: int):
    """Flatten each block's 9 dedup'd windows into a flat candidate row list
    i32[NB, cap + 2]: ``cap`` row ids (pad slots = ``nmax``), the
    block-has-valid flag, the true row count (clamped to cap). Also returns
    fits bool[NB]: False where the true rows exceed ``cap``."""
    ns = NSHIFT
    st = starts_skip[:, :ns].long()
    sk = starts_skip[:, ns: 2 * ns].long()
    ln = starts_skip[:, 2 * ns: 3 * ns].long()
    bv = starts_skip[:, 3 * ns].long()
    eff_start = st + sk
    eff_len = torch.clamp(ln - sk, min=0)
    cum = torch.cumsum(eff_len, dim=1)
    total = cum[:, -1]
    cum0 = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
    t = torch.arange(cap, device=starts_skip.device)
    j = (cum[:, :, None] <= t[None, None, :]).sum(dim=1)
    j = torch.clamp(j, max=ns - 1)
    row = torch.gather(eff_start, 1, j) + (t[None, :] - torch.gather(cum0, 1, j))
    row = torch.where(t[None, :] < total[:, None], row, nmax)
    fits = total <= cap
    rowlist = torch.cat([row, bv[:, None], torch.clamp(total, max=cap)[:, None]],
                        dim=1)
    return rowlist.to(torch.int32).contiguous(), fits


def _planar_padded(planar):
    """Planar rows with an all-masked pad row appended (w = 0, coordinates
    1e9 so an unmasked read could never fake a near neighbour)."""
    pad = torch.zeros((1, 4, 128), dtype=torch.float32, device=planar.device)
    pad[:, :3] = 1e9
    return torch.cat([planar, pad]).contiguous()


def _pack_planar(sx, sy, sz, suse, nrows):
    return torch.stack([sx.reshape(nrows, 128), sy.reshape(nrows, 128),
                        sz.reshape(nrows, 128),
                        suse.to(torch.float32).reshape(nrows, 128)],
                       dim=1).contiguous()


def _pad_tail(a, tail: int, value):
    if not tail:
        return a
    return torch.cat([a, torch.full((tail,), value, dtype=a.dtype,
                                    device=a.device)])


def structure_from_sorted(xyz_sorted, valid_sorted, slin, extent, hi_cells,
                          table_overflow, wr: int,
                          table_size: int = SWEEP_TABLE_SIZE,
                          grid_origin=None):
    """Sweep structure for rows already sorted by ascending sor-cell id
    (``slin``, table_size sentinel on the invalid tail); identity
    permutation. ``grid_origin`` = (mn_v i32[3], voxel_size, factor): the
    voxel lattice the cell ids came from, for pass 1's per-query coverage
    certificate."""
    n = xyz_sorted.shape[0]
    if n % 128:
        raise ValueError(f"structure_from_sorted: {n} rows not a multiple "
                         "of 128")
    nrows = max(n // 128, wr)
    nb = n // 128
    tail = nrows * 128 - n
    sx, sy, sz = (_pad_tail(torch.where(valid_sorted, xyz_sorted[:, i], 0.0),
                            tail, 0.0) for i in range(3))
    slin_p = _pad_tail(slin, tail, table_size)
    suse_p = _pad_tail(valid_sorted, tail, False)
    planar = _pack_planar(sx, sy, sz, suse_p, nrows)
    starts_skip, block_ok = _window_starts(slin_p, suse_p, extent, nrows, nb,
                                           wr, table_size)
    # order/inv None: the identity permutation (row i IS sorted position i).
    return dict(planar=planar, order=None, inv=None, use=valid_sorted,
                starts_skip=starts_skip, block_ok=block_ok, mn=None,
                extent=extent, hi_cells=hi_cells, nrows=nrows, nb=nb,
                table_overflow=table_overflow, slin_p=slin_p,
                grid_origin=grid_origin)


def _hi_cells(s):
    """|coordinate| / cell bound of a structure's grid, for the f32
    floor-rounding margin: carried by a prebuilt structure, else from the
    grid's own cell extents."""
    if s.get("hi_cells") is not None:
        return s["hi_cells"]
    return torch.maximum(s["mn"].abs(), (s["mn"] + s["extent"]).abs()).amax(
    ).to(torch.float32)


def _sweep_pass1(cell_size, *, k: int, prebuilt, row_cap: int | None):
    """Pass 1: exact k+1-smallest over each block's candidates (its flat
    row list of at most ``row_cap`` rows, or with ``row_cap=None`` its nine
    windows), mean neighbour distance and certificates, in the sorted
    frame. ``cell_size`` is a float32 0-d tensor."""
    kp1 = k + 1
    s = prebuilt
    planar = s["planar"]
    starts_skip = s["starts_skip"]
    table_overflow = s["table_overflow"]
    block_ok = s["block_ok"]
    if row_cap is None:
        total, count, kth, seg_ok = sweep_select(planar, starts_skip, k=kp1)
    else:
        rowlist, fits = _window_row_lists(starts_skip, row_cap,
                                          planar.shape[0])
        total, count, kth, seg_ok = sweep_select_rows(
            _planar_padded(planar), rowlist, k=kp1, cap=row_cap)
        block_ok = block_ok & fits
    ok_sorted = seg_ok & block_ok.repeat_interleave(128)

    nb = starts_skip.shape[0]
    use_s = planar[:nb, 3, :].reshape(-1) > 0.5
    n_neighbors = torch.clamp(count - 1.0, min=0.0)
    mean_s = torch.where(n_neighbors > 0,
                         total / torch.clamp(n_neighbors, min=1.0), torch.inf)
    n_valid_total = use_s.sum()
    # max(.., 2): a cloud with ONE valid point must fail certification.
    want = torch.clamp(torch.clamp(n_valid_total, min=2), max=kp1)
    wantf = want.to(torch.float32)
    mean_s = torch.where(count >= wantf, mean_s, torch.inf)
    mean_s = torch.where(use_s, mean_s, torch.inf)

    margin = (_hi_cells(s) * 4.0 * 1.2e-7 + 1e-6) * cell_size
    origin = s.get("grid_origin")
    if origin is not None:
        # Per-query coverage radius: distance from the query to the outer
        # boundary of its 3x3x3 cell slab (1.0-1.5 cells).
        mn_v, voxel_g, factor_g = origin
        sl = s["slin_p"][: nb * 128]
        e1 = torch.clamp(s["extent"][1], min=1)
        e2 = torch.clamp(s["extent"][2], min=1)
        cells = (sl // (e1 * e2), (sl // e2) % e1, sl % e2)
        qs = (planar[:nb, i, :].reshape(-1) for i in range(3))
        voxel_g = scalar_like(voxel_g, planar)

        def cov(c, q, a):
            lo = voxel_g * (mn_v[a] + (c - 1) * factor_g).to(torch.float32)
            hi = voxel_g * (mn_v[a] + (c + 2) * factor_g).to(torch.float32)
            return torch.minimum(q - lo, hi - q)

        c0, c1, c2 = (cov(c, q, a) for a, (c, q) in enumerate(zip(cells, qs)))
        rcov = torch.minimum(torch.minimum(c0, c1), c2)
        safe_q = torch.clamp(torch.minimum(rcov, 1.5 * cell_size) - margin,
                             min=0.0)
        cell2 = safe_q * safe_q
    else:
        safe = torch.clamp(cell_size - margin, min=0.0)
        cell2 = safe * safe

    machine_ok_s = ok_sorted & use_s & ~table_overflow
    point_ok_s = machine_ok_s & (count >= wantf) & (kth <= cell2)
    return dict(mean_s=mean_s, point_ok_s=point_ok_s, use_s=use_s,
                planar=planar, want=want, table_overflow=table_overflow,
                total_s=total, count_s=count,
                safe2_s=torch.broadcast_to(cell2, count.shape),
                machine_ok_s=machine_ok_s, kth_s=kth)


def _rescue_structure(planar, order, flagged, fix_cap: int, n: int, radius,
                      priority=None, q_src=None):
    """Pass-2 front end: compact flagged queries (priority rows first, then
    sorted order), pad the planar rows to rescue groups, and build each
    query block's AABB-pruned active-group list. ``order`` maps sorted
    position -> original row of ``flagged``/``priority`` (None: identity).
    ``q_src``: the planar frame the query coordinates come from (default
    ``planar``; the cross-cloud sweep passes its query frame, and then
    ``order``, ``flagged`` and ``n`` are the query side's). Returns
    (planar_g, q_planar [QB, 4, 128], active i32[QB, 1 + NG], qvalid, qsel
    -- sorted-frame positions)."""
    dev = planar.device
    nrows = planar.shape[0]
    gr = RESCUE_GROUP_ROWS
    gpad = (-nrows) % gr
    planar_g = planar
    if gpad:
        planar_g = torch.cat([planar, torch.zeros((gpad, 4, 128),
                                                  device=dev)]).contiguous()
    ng = planar_g.shape[0] // gr

    if order is not None:
        flagged = flagged[order]
        priority = None if priority is None else priority[order]
    if priority is None:
        fq = compaction_order(flagged)
    else:
        fq = stable_argsort(torch.where(flagged, torch.where(priority, 0, 1),
                                        2).to(torch.int32))
    fix_cap = ((fix_cap + 127) // 128) * 128
    qcap = min(fix_cap, ((n + 127) // 128) * 128)
    qsel = fq[: min(qcap, n)]
    if qcap > n:
        qsel = torch.cat([qsel, torch.zeros(qcap - n, dtype=qsel.dtype,
                                            device=dev)])
    qvalid = flagged[qsel]
    if qcap > n:
        qvalid = qvalid & (torch.arange(qcap, device=dev) < n)

    qf = planar if q_src is None else q_src
    qx, qy, qz = (qf[:, i, :].reshape(-1)[qsel] for i in range(3))
    qb = qcap // 128
    q_planar = _pack_planar(qx, qy, qz, qvalid, qb)

    # AABB prune: a group is visited iff its box lies within the (inflated)
    # rescue radius of the query block's box.
    gw = planar_g[:, 3, :].reshape(ng, -1) > 0.5
    qv = qvalid.reshape(qb, 128)

    def minmax(v, m):
        return (torch.where(m, v, torch.inf).amin(dim=1),
                torch.where(m, v, -torch.inf).amax(dim=1))

    gap2 = None
    for c, q in enumerate((qx, qy, qz)):
        gn, gx = minmax(planar_g[:, c, :].reshape(ng, -1), gw)
        qn, qx_ = minmax(q.reshape(qb, 128), qv)
        gap = torch.clamp(torch.maximum(qn[:, None] - gx[None, :],
                                        gn[None, :] - qx_[:, None]), min=0.0)
        gap2 = gap * gap if gap2 is None else gap2 + gap * gap
    r2p = radius * 1.00001
    keep = (gap2 <= r2p * r2p + 1e-6) & ~torch.isnan(gap2)
    counts = keep.sum(dim=1).to(torch.int32)
    act = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    active = torch.cat([counts[:, None], act.to(torch.int32)], dim=1)
    return planar_g, q_planar, active.contiguous(), qvalid, qsel


def _unsort(packed, s, n: int):
    """Sorted-frame channels [C, NALL] -> row order [C, n]: a slice on the
    identity permutation of a prebuilt structure, else one gather."""
    return packed[:, :n] if s["inv"] is None else packed[:, s["inv"]]


def sweep_sor_mean_dists(xyz, valid, cell_size, *, k: int, wr: int = 4,
                         table_size: int = SWEEP_TABLE_SIZE):
    """Pass 1 of the SOR sweep on its own: the mean distance to the k
    nearest neighbours of each point (self included in the k+1
    extraction) over its block's nine windows, with no rescue.

    Returns (mean f32[N], +inf where unresolved or invalid; point_ok
    bool[N]; certified bool[]) in row order, the contract of
    `cellgrid.point_sor_mean_dists`: a row is certified only when its
    (k+1)-th neighbour lies within one margin-shrunk ``cell_size``."""
    n = xyz.shape[0]
    cell_size = scalar_like(cell_size, xyz)
    s = _sorted_structure(xyz, valid, cell_size, wr, table_size)
    p = _sweep_pass1(cell_size, k=k, prebuilt=s, row_cap=None)
    ok_s = p["point_ok_s"]
    certified = ~(p["use_s"] & ~ok_s).any()
    res = _unsort(torch.stack([p["mean_s"], ok_s.to(torch.float32)]), s, n)
    return res[0], res[1] > 0.5, certified


def sweep_sor_two_pass(xyz, valid, cell_size, *, k: int,
                       fix_cap: int = 4096, rescue_cells: float = 4.0,
                       wr: int = 4, table_size: int = SWEEP_TABLE_SIZE,
                       prebuilt=None, row_cap: int | None = None,
                       with_lb: bool = False):
    """Pass-1 sweep + exact AABB-pruned rescue of the flagged queries.

    Returns (mean f32[N], point_ok bool[N], certified bool) in row order,
    and with ``with_lb`` also lb f32[N], per-row lower bounds on the true
    mean (the keep-decision certificate's input). ``prebuilt``: a
    `structure_from_sorted` dict (identity permutation); otherwise the
    points are sorted here (``wr``, ``table_size``). ``row_cap``: pass 1
    walks each block's flat row list of at most this many rows (blocks
    with more fail certification); None walks the nine windows."""
    n = xyz.shape[0]
    cell_size = scalar_like(cell_size, xyz)
    s = prebuilt if prebuilt is not None else _sorted_structure(
        xyz, valid, cell_size, wr, table_size)
    with profiling.span("sor.pass1"):
        p = _sweep_pass1(cell_size, k=k, prebuilt=s, row_cap=row_cap)
    with profiling.span("sor.rescue"):
        return _sor_rescue(xyz, s, p, cell_size, k=k, fix_cap=fix_cap,
                           rescue_cells=rescue_cells, with_lb=with_lb)


def _sor_rescue(xyz, s, p, cell_size, *, k: int, fix_cap: int,
                rescue_cells: float, with_lb: bool):
    """`sweep_sor_two_pass` after pass 1 ``p``: the exact rescue of the
    flagged rows, merged back and unsorted to row order."""
    n = xyz.shape[0]
    kp1 = k + 1
    use_s = p["use_s"]
    nall = use_s.shape[0]
    wantf = p["want"].to(torch.float32)

    flagged_s = use_s & ~p["point_ok_s"]
    radius = rescue_cells * cell_size
    # With lower bounds, rows with no decision certificate from pass 1 go
    # first when the flagged rows exceed fix_cap.
    hard_s = (flagged_s & (p["count_s"] >= wantf)
              & (p["mean_s"] > 2.0 * cell_size)) if with_lb else None
    planar_g, q_planar, active, qvalid, qsel = _rescue_structure(
        p["planar"], None, flagged_s, fix_cap, nall, radius, priority=hard_s)
    rtotal, rcount, rkth, rseg_ok = rescue_select(
        planar_g, q_planar, active, k=kp1, gr=RESCUE_GROUP_ROWS)

    n_neighbors = torch.clamp(rcount - 1.0, min=0.0)
    rmean = torch.where(n_neighbors > 0,
                        rtotal / torch.clamp(n_neighbors, min=1.0), torch.inf)
    rmean = torch.where(rcount >= wantf, rmean, torch.inf)
    rc = radius * 0.99999
    rok = (rcount >= wantf) & (rkth <= rc * rc) & rseg_ok & qvalid
    rok = rok & ~p["table_overflow"]

    # Scatter the rescued rows back (qsel are sorted positions; slot nall
    # swallows the non-flagged padding slots).
    pos = torch.where(qvalid, qsel, nall)
    rows = [p["mean_s"], p["point_ok_s"].to(torch.float32)]
    upd = [torch.where(qvalid, rmean, 0.0),
           torch.where(qvalid, rok.to(torch.float32), 0.0)]
    if with_lb:
        lb1, rlb = _lower_bounds(p, rtotal, rcount, rkth, rseg_ok, rmean,
                                 rok, radius, wantf)
        rows.append(lb1)
        upd.append(torch.where(qvalid, rlb, 0.0))
    merged = torch.zeros((len(rows), nall + 1), dtype=torch.float32,
                         device=xyz.device)
    merged[:, :nall] = torch.stack(rows)
    merged[:, pos] = torch.stack(upd)
    merged = merged[:, :nall]
    # Flagged rows beyond fix_cap stay point_ok=False.
    certified = ~(use_s & ~(merged[1] > 0.5)).any()
    res = _unsort(merged, s, n)
    out = (res[0], res[1] > 0.5, certified)
    return out + (res[2],) if with_lb else out


def _lower_bounds(p, rtotal, rcount, rkth, rseg_ok, rmean, rok, radius,
                  wantf):
    """Lower bounds on the true mean, sorted frame (pass 1) and per rescue
    slot: candidates are complete within R (the coverage radius in pass
    1, the rescue radius in pass 2). Count-short rows: the missing
    neighbours are each > R. Others: each found distance beyond R
    over-estimates its true counterpart by <= kth - R."""
    ndiv = torch.clamp(wantf - 1.0, min=1.0)
    safe1 = torch.sqrt(p["safe2_s"])
    mok = p["machine_ok_s"]
    short1 = p["count_s"] < wantf
    lb1_short = torch.where(
        mok & short1, (p["total_s"] + (wantf - p["count_s"]) * safe1) / ndiv,
        0.0)
    kthd1 = torch.sqrt(torch.clamp(p["kth_s"], min=0.0))
    lb1_m = torch.where(mok & ~short1,
                        p["mean_s"] - torch.clamp(kthd1 - safe1, min=0.0), 0.0)
    lb1 = torch.maximum(lb1_short, torch.clamp(lb1_m, min=0.0))
    lb1 = torch.where(p["point_ok_s"], p["mean_s"], lb1)
    rshort = rcount < wantf
    rlb_short = torch.where(rseg_ok & rshort,
                            (rtotal + (wantf - rcount) * radius) / ndiv, 0.0)
    rkthd = torch.sqrt(torch.clamp(rkth, min=0.0))
    rmean_f = torch.where(torch.isfinite(rmean), rmean, 0.0)
    rlb_m = torch.where(rseg_ok & ~rshort,
                        rmean_f - torch.clamp(rkthd - radius, min=0.0), 0.0)
    rlb = torch.maximum(rlb_short, torch.clamp(rlb_m, min=0.0))
    return lb1, torch.where(rok, rmean_f, rlb)


# ── Clustering ──────────────────────────────────────────────────────────────


def cluster_cell_size(radius, hi_abs):
    """Sort-cell width for cluster and radius sweeps: one radius plus the
    f32 floor-rounding margin, so the 27-cell neighbourhood holds every
    within-radius candidate. ``radius``, ``hi_abs``: f32 0-d tensors. The
    reference's ``radius * 1.00002 + hi_abs * 6e-7 + 1e-7`` is taken as
    XLA's CPU backend contracts it, fma(radius, 1.00002, hi_abs * 6e-7) +
    1e-7 (measured: 100% bitwise, 75% for the uncontracted form)."""
    c = scalar_like(np.float32(1.00002), hi_abs)
    one = (1,)
    return fma_f32(radius.reshape(one), c.reshape(one),
                   (hi_abs * 6e-7).reshape(one))[0] + 1e-7


def _sorted_structure(xyz, valid, cell_size, wr: int, table_size: int):
    """Sort, pack and window-compute: the front half of the cluster and
    moments sweeps. ``cell_size`` is a float32 0-d tensor."""
    n = xyz.shape[0]
    dev = xyz.device
    use = valid & torch.isfinite(xyz).all(dim=-1)
    c = torch.clamp(torch.floor(xyz / cell_size), -1e9, 1e9).to(torch.int32)
    big32 = 2**30
    mn = torch.clamp(torch.where(use[:, None], c, big32).amin(dim=0),
                     max=big32 - 1)
    rel = torch.clamp(c - mn[None, :], min=0)
    mx = torch.where(use[:, None], rel, 0).amax(dim=0)
    extent = (mx + 1).to(torch.int32)
    ext64 = extent.to(torch.int64)
    rel64 = rel.to(torch.int64)
    lin64 = (rel64[:, 0] * ext64[1] + rel64[:, 1]) * ext64[2] + rel64[:, 2]
    table_overflow = (ext64[0] * ext64[1] * ext64[2]) > table_size
    lin = torch.where(use, torch.clamp(lin64, 0, table_size - 1),
                      table_size).to(torch.int32)

    order = stable_argsort(lin)
    slin = lin[order]
    suse = slin < table_size
    sxc, syc, szc = (torch.where(suse, xyz[order, i], 0.0) for i in range(3))

    npad = n + (-n) % 128
    nrows = max(npad // 128, wr)
    tail = nrows * 128 - n
    nb = npad // 128
    slin_p = _pad_tail(slin, tail, table_size)
    suse_p = _pad_tail(suse, tail, False)
    planar = _pack_planar(_pad_tail(sxc, tail, 0.0), _pad_tail(syc, tail, 0.0),
                          _pad_tail(szc, tail, 0.0), suse_p, nrows)
    starts_skip, block_ok = _window_starts(slin_p, suse_p, extent, nrows, nb,
                                           wr, table_size)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, dtype=order.dtype, device=dev)
    return dict(planar=planar, order=order, inv=inv, use=use,
                starts_skip=starts_skip, block_ok=block_ok, mn=mn,
                extent=extent, nrows=nrows, nb=nb,
                table_overflow=table_overflow, slin_p=slin_p, suse_p=suse_p)


def _cluster_epilogue(lab, s, n: int, nall: int, exact,
                      rep_labels: bool = True):
    """Sorted-position labels -> original-order labels: each valid point
    gets the smallest ORIGINAL row of its component, invalid points their
    own row. ``rep_labels=False`` returns canonical component ids instead
    (the smallest sorted position in the component, in original order;
    invalid points get unique ids past every sorted position): the same
    components, without the scatter-min."""
    dev = lab.device
    if not rep_labels:
        plab = lab[:n].long()[s["inv"]]
        own = torch.arange(nall, nall + n, dtype=torch.int64, device=dev)
        return torch.where(s["use"], plab, own).to(torch.int32), exact
    order_rows = torch.cat([s["order"],
                            torch.full((nall - n,), n, dtype=torch.int64,
                                       device=dev)])
    idx = torch.where(s["suse_p"], lab.long(), nall)
    min_row = torch.full((nall + 1,), n, dtype=torch.int64, device=dev)
    min_row.scatter_reduce_(0, idx, order_rows, reduce="amin")
    rep_sorted = min_row[torch.clamp(lab.long(), 0, nall - 1)]
    plab = rep_sorted[:n][s["inv"]]
    own = torch.arange(n, dtype=torch.int64, device=dev)
    labels = torch.where(s["use"] & (plab < n), plab, own)
    return labels.to(torch.int32), exact


# Further bursts of `cluster_multisweep_windows` after a first one that did
# not converge (the reference's completion loop).
_RESUME_BURSTS = 8


def sweep_cluster_labels(xyz, valid, radius, *, wr: int = 7,
                         max_iters: int = 64, sweeps: int = 12,
                         table_size: int = SWEEP_TABLE_SIZE,
                         rep_labels: bool = True,
                         row_cap: int | None = 16):
    """Euclidean-cluster labels (inclusive distance ``radius``, taken as
    float32) by min-label propagation over the cell-sorted windows.

    Up to `CLUSTER_RESIDENT_BYTES` of planar rows: ``row_cap=int`` walks
    each block's flat row list (at most ``max_iters`` rounds);
    ``row_cap=None`` walks the nine windows with no cap (the dense
    backend), in bursts of at most ``sweeps`` rounds: a first burst, then up
    to 8 more resumed from the current labels while the last round still
    changed any. Above it, the reference's hop loop (`_hop_loop_labels`)
    over the windows, whatever ``row_cap`` and ``sweeps``.

    Returns (labels i32[N], exact bool): label = smallest original row in
    the component, or with ``rep_labels=False`` a canonical component id
    (`_cluster_epilogue`); invalid/non-finite points keep their own id.
    ``exact`` is False when a block's windows or row list overflowed, or
    when the propagation did not converge within its rounds."""
    n = xyz.shape[0]
    r32 = np.float32(radius)
    r2 = float(r32 * r32)
    with profiling.span("cluster.structure"):
        use_pre = valid & torch.isfinite(xyz).all(dim=-1)
        hi_abs = torch.where(use_pre[:, None], xyz.abs(), 0.0).amax()
        cell_size = cluster_cell_size(scalar_like(r32, xyz), hi_abs)
        s = _sorted_structure(xyz, valid, cell_size, wr, table_size)
    planar, nrows, nb = s["planar"], s["nrows"], s["nb"]
    starts_skip = s["starts_skip"]
    nall = nrows * 128
    with profiling.span("cluster.rounds"):
        exact = s["block_ok"][:nb].all() & ~s["table_overflow"]
        if nrows * 8 * 128 * 4 > CLUSTER_RESIDENT_BYTES:
            labels, iters = _hop_loop_labels(planar, starts_skip, r2, nb,
                                             max_iters)
            exact = exact & (iters < max_iters)
        elif row_cap is not None:
            rowlist, fits = _window_row_lists(starts_skip, row_cap, nrows)
            labels, changed, _ = cluster_multisweep(
                planar, rowlist, r2, cap=row_cap, max_rounds=max_iters)
            exact = exact & fits[:nb].all() & ~changed.any()
        else:
            labels, changed, _ = cluster_multisweep_windows(
                planar, starts_skip, r2, max_rounds=sweeps)
            bursts = 0
            while bursts < _RESUME_BURSTS:
                # The completion loop's test of the last round's flags.
                with profiling.host_read("cluster.resume"):
                    if not bool(changed.any()):
                        break
                labels, changed, _ = cluster_multisweep_windows(
                    planar, starts_skip, r2, max_rounds=sweeps,
                    labels0=labels)
                bursts += 1
            exact = exact & ~changed.any()
    with profiling.span("cluster.epilogue"):
        if labels.shape[0] < nall:  # the windows' rows, padded
            labels = torch.cat([labels, torch.arange(nb * 128, nall,
                                                     dtype=labels.dtype,
                                                     device=labels.device)])
        return _cluster_epilogue(labels, s, n, nall, exact, rep_labels)


def _hop_loop_labels(planar, starts_skip, r2: float, nb: int,
                     max_iters: int):
    """The reference's hop loop (`sweep.py` of the JAX package, its
    `use_kernel=False` branch): each iteration one min-label hop over the
    active blocks' windows (kernel `cluster_propagate`), a scatter-min hook
    of every changed label into its old root, two pointer jumps, and
    the next frontier: the blocks whose window rows hold a changed label.
    Runs while the hop changed a label, at most ``max_iters`` iterations
    (one host read each). Returns (labels i32[NR*128] sorted positions of
    the component minima, iterations run)."""
    nrows = planar.shape[0]
    nall = nrows * 128
    dev = planar.device
    st = starts_skip[:, :NSHIFT]
    lo_rows = torch.clamp(st + starts_skip[:, NSHIFT:2 * NSHIFT],
                          max=nrows).long()
    hi_rows = torch.clamp(st + starts_skip[:, 2 * NSHIFT:3 * NSHIFT],
                          max=nrows).long()
    lab = torch.arange(nall, dtype=torch.int32, device=dev)
    active = torch.ones(nb, dtype=torch.bool, device=dev)
    iters = 0
    while iters < max_iters:
        starts_it = torch.cat([starts_skip, active.to(torch.int32)[:, None]],
                              dim=1).contiguous()
        m, changed = cluster_propagate(planar, lab, starts_it, r2)
        if nall > nb * 128:
            m = torch.cat([m, lab[nb * 128:]])
        new = torch.minimum(lab, m)
        # Hook: each discovery also lowers its old root's label.
        new.scatter_reduce_(0, torch.clamp(lab, 0, nall - 1).long(), m,
                            reduce="amin")
        for _ in range(2):
            new = torch.minimum(new, new[torch.clamp(new, 0, nall - 1).long()])
        diff_rows = (new != lab).reshape(nrows, 128).any(dim=1)
        cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(diff_rows.to(torch.int64), 0)])
        active = ((cum[hi_rows] - cum[lo_rows]) > 0).any(dim=1)
        lab = new
        iters += 1
        with profiling.host_read("cluster.hop"):  # the loop's condition
            if not bool(changed.any()):
                break
    profiling.count("cluster.rounds", iters)
    return lab, iters


# ── kNN moments (normal estimation) ─────────────────────────────────────────


def sweep_knn_moments_rows(xyz, valid, cell_size, *, k: int, wr: int = 4,
                           table_size: int = SWEEP_TABLE_SIZE,
                           prebuilt=None):
    """Query-centred moments of each point's k nearest neighbours (self
    included), in row layout: (m1 f32[3, N], m2 f32[6, N] (xx, yy, zz, xy,
    xz, yz), count f32[N], point_ok bool[N]). ``point_ok`` certifies the
    neighbour set is the true k nearest and tie-free at the kth distance.

    ``prebuilt``: a `structure_from_sorted` dict (results in its row
    order); otherwise the points are sorted here and results come back in
    the input order. ``cell_size`` is taken as float32."""
    cell_size = scalar_like(cell_size, xyz)
    s = prebuilt if prebuilt is not None else _sorted_structure(
        xyz, valid, cell_size, wr, table_size)
    return _moments_pass1(s, cell_size, k=k)


def _moments_pass1(s, cell_size, *, k: int):
    out = sweep_moments(s["planar"], s["starts_skip"], k=k)
    ok_sorted = (out[12] > 0.5) & s["block_ok"].repeat_interleave(128)
    ok_sorted = ok_sorted & (out[9] == out[10])  # tie-free at kth
    packed = torch.cat([out[0:9], out[10:12],
                        ok_sorted[None].to(torch.float32)])
    n = s["use"].shape[0]
    res = packed[:, :n] if s["inv"] is None else packed[:, s["inv"]]
    count, kth, point_ok = res[9], res[10], res[11] > 0.5

    # kth-within-cell certificate (the SOR sweep's margin).
    margin = (_hi_cells(s) * 4.0 * 1.2e-7 + 1e-6) * cell_size
    safe = torch.clamp(cell_size - margin, min=0.0)
    point_ok = (point_ok & (kth <= safe * safe) & s["use"]
                & ~s["table_overflow"])
    return res[0:3], res[3:9], count, point_ok


def _set_rows(dst, rows, vals):
    """``dst`` with rows ``rows`` set to ``vals``; rows equal to len(dst)
    (padding slots) are dropped."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst[:1]])
    ext[rows] = vals
    return ext[:n]


def _sum_columns(t):
    """[Q, k] -> [Q], added column by column from 0.0."""
    acc = torch.zeros(t.shape[0], dtype=t.dtype, device=t.device)
    for j in range(t.shape[1]):
        acc = acc + t[:, j]
    return acc


def _rescue_rows_orig(order, qsel, n: int):
    """Original row ids of the compacted rescue queries (n = drop slot)."""
    qsel = torch.clamp(qsel.long(), max=n)
    if order is None:
        return qsel
    return torch.cat([order, torch.full((1,), n, dtype=order.dtype,
                                        device=order.device)])[qsel]


def _positions_to_rows(pos, order, n: int):
    """Sorted-frame positions (f32, -1 pad) -> original row ids (-1 pad)."""
    pos_i = torch.clamp(pos.to(torch.int64), -1, n - 1)
    rows = order[torch.clamp(pos_i, 0, n - 1)]
    return torch.where(pos_i >= 0, rows, -1)


def sweep_moments_two_pass_rows(xyz, valid, cell_size, *, k: int,
                                fix_cap: int = 4096,
                                rescue_cells: float = 4.0, wr: int = 4,
                                table_size: int = SWEEP_TABLE_SIZE):
    """`sweep_knn_moments_rows` plus the AABB-group-pruned exact rescue of
    the flagged rows (up to ``fix_cap``): their neighbours come from
    `rescue_knn_idx` and their moments are recomputed from the neighbour
    rows. Rescued rows are certified up to the choice among kth-distance
    ties, so the tie-free test of pass 1 is not imposed on them. Same
    outputs as `sweep_knn_moments_rows`, in the input order."""
    n = xyz.shape[0]
    cell_size = scalar_like(cell_size, xyz)
    s = _sorted_structure(xyz, valid, cell_size, wr, table_size)
    m1r, m2r, count, point_ok = _moments_pass1(s, cell_size, k=k)

    order, use = s["order"], s["use"]
    flagged = use & ~point_ok
    radius = rescue_cells * cell_size
    planar_g, q_planar, active, qvalid, qsel = _rescue_structure(
        s["planar"], order, flagged, fix_cap, n, radius)
    rout = rescue_knn_idx(planar_g, q_planar, active, k=k,
                          gr=RESCUE_GROUP_ROWS)
    rd, rpos = rout[:k].T, rout[k:2 * k].T  # [qcap, k]
    rcount, rkth, rseg_ok = rout[2 * k], rout[2 * k + 1], rout[2 * k + 2] > 0.5

    want_f = torch.clamp(use.sum(), max=k).to(torch.float32)
    rc = radius * 0.99999
    rok = ((rcount >= want_f) & (rkth <= rc * rc) & rseg_ok & qvalid
           & ~s["table_overflow"])

    # Query-centred moments from the rescued neighbour rows.
    ridx = _positions_to_rows(rpos, order, n)
    found = torch.isfinite(rd)
    idxc = torch.clamp(ridx, 0, n - 1)
    rows_orig = _rescue_rows_orig(order, qsel, n)
    rowc = torch.clamp(rows_orig, 0, n - 1)
    rel = [torch.where(found, xyz[idxc, i] - xyz[rowc, i][:, None], 0.0)
           for i in range(3)]
    relx, rely, relz = rel
    # Summed one neighbour at a time: torch's reductions add in another
    # order on the card than on the CPU.
    rm1 = torch.stack([_sum_columns(r) for r in rel])
    rm2 = torch.stack([_sum_columns(a * b) for a, b in (
        (relx, relx), (rely, rely), (relz, relz), (relx, rely),
        (relx, relz), (rely, relz))])
    rcnt = found.sum(dim=1).to(torch.float32)

    # Scatter back only the certified rescues (column n swallows the rest).
    drop = torch.where(rok, rows_orig, n)

    def scatter(dst, vals):
        ext = torch.cat([dst, dst[..., :1]], dim=-1)
        ext[..., drop] = vals
        return ext[..., :n]

    return (scatter(m1r, rm1), scatter(m2r, rm2), scatter(count, rcnt),
            scatter(point_ok, rok))


def sweep_knn_moments(xyz, valid, cell_size, *, k: int, wr: int = 4,
                      table_size: int = SWEEP_TABLE_SIZE):
    """`sweep_knn_moments_rows` in column layout: (m1 f32[N, 3], m2
    f32[N, 6] (xx, yy, zz, xy, xz, yz), count f32[N], point_ok bool[N])."""
    m1r, m2r, count, point_ok = sweep_knn_moments_rows(
        xyz, valid, cell_size, k=k, wr=wr, table_size=table_size)
    return m1r.T, m2r.T, count, point_ok


# ── Radius counts (radius outlier removal) ─────────────────────────────────


def _radius_structure(xyz, valid, radius, wr: int, table_size: int):
    """The sorted structure with a sort cell of one radius (f32) plus the
    floor-rounding margin, so every within-radius candidate lies in the
    27-cell neighbourhood."""
    use = valid & torch.isfinite(xyz).all(dim=-1)
    hi_abs = torch.where(use[:, None], xyz.abs(), 0.0).amax()
    cell = cluster_cell_size(scalar_like(radius, xyz), hi_abs)
    return _sorted_structure(xyz, valid, cell, wr, table_size)


def _radius_pass1(s, radius):
    """Pass 1: per-point counts over the windows (``count_within``; r2
    rides the w channel: 1 -> r2, 0 stays 0), in row order. Counts are
    exact by construction wherever the block's windows were complete."""
    planar = s["planar"]
    r = scalar_like(radius, planar)
    planar = planar.clone()
    planar[:, 3, :] *= r * r
    counts_f = count_within(planar, s["starts_skip"])
    ok_sorted = s["block_ok"].repeat_interleave(128)
    res = torch.stack([counts_f, ok_sorted.to(torch.float32)])[:, s["inv"]]
    use = s["use"]
    counts = torch.where(use, res[0].to(torch.int32), 0)
    point_ok = (res[1] > 0.5) & use & ~s["table_overflow"]
    return counts, point_ok


def sweep_radius_count(xyz, valid, radius, *, wr: int = 4,
                       table_size: int = SWEEP_TABLE_SIZE):
    """Points within ``radius`` (f32, inclusive, self included) of each
    point, over the sorted windows. Returns (counts i32[N], point_ok
    bool[N]); rows flagged only where a block's windows overflowed or the
    cell table did."""
    s = _radius_structure(xyz, valid, radius, wr, table_size)
    return _radius_pass1(s, radius)


def sweep_radius_count_two_pass(xyz, valid, radius, *, fix_cap: int = 4096,
                                wr: int = 4,
                                table_size: int = SWEEP_TABLE_SIZE):
    """`sweep_radius_count` plus the exact AABB-group-pruned rescue of up
    to ``fix_cap`` flagged rows (the prune ball is the query radius, so a
    rescued count is exact by construction). Only a fix_cap or cell-table
    overflow leaves rows flagged."""
    n = xyz.shape[0]
    s = _radius_structure(xyz, valid, radius, wr, table_size)
    counts, point_ok = _radius_pass1(s, radius)
    r = scalar_like(radius, xyz)
    flagged = s["use"] & ~point_ok
    planar_g, q_planar, active, qvalid, qsel = _rescue_structure(
        s["planar"], s["order"], flagged, fix_cap, n, r)
    # r^2 rides the query w channel; -1 marks an invalid or padding slot.
    q_planar = q_planar.clone()
    q_planar[:, 3, :] = torch.where(q_planar[:, 3, :] > 0.5, r * r, -1.0)
    rcounts = rescue_radius_count_groups(planar_g, q_planar, active,
                                         gr=RESCUE_GROUP_ROWS)
    rok = qvalid & ~s["table_overflow"]
    rows = torch.where(rok, _rescue_rows_orig(s["order"], qsel, n), n)
    return (_set_rows(counts, rows, torch.where(rok, rcounts.to(torch.int32),
                                                0)),
            _set_rows(point_ok, rows, rok))


# ── kNN (distances and original indices) ───────────────────────────────────


def _knn_unsort(out, k: int, block_ok, inv, n: int, order, pn: int):
    """`sweep_knn_select` rows (sorted query frame) -> original query order:
    (dists f32[n, k], idx i32[n, k] original point rows (-1 pad), nvalid
    bool[n, k], count, kth, ok) with ok = the kernel's certificate and its
    block's window certificate. ``order``/``pn``: the point frame's sort
    order and size."""
    ok_sorted = (out[2 * k + 2] > 0.5) & block_ok.repeat_interleave(128)
    res = torch.cat([out, ok_sorted[None].to(torch.float32)])[:, :n][:, inv]
    dists = res[:k].T
    idx = _positions_to_rows(res[k:2 * k].T, order, pn).to(torch.int32)
    return (dists, idx, torch.isfinite(dists), res[2 * k], res[2 * k + 1],
            res[2 * k + 3] > 0.5)


def _knn_safe2(s, cell_size):
    """Squared kth-distance bound of pass 1: one cell less the f32
    floor-rounding margin (the SOR sweep's margin)."""
    margin = (_hi_cells(s) * 4.0 * 1.2e-7 + 1e-6) * cell_size
    safe = torch.clamp(cell_size - margin, min=0.0)
    return safe * safe


def _knn_pass1(s, n: int, cell_size, *, k: int):
    """Pass 1 of the all-points kNN sweep (kernel `sweep_knn_select`) and
    its certificates, in original order: (dists f32[N, k] Euclidean
    ascending (+inf pad), idx i32[N, k] original rows (-1 pad), nvalid
    bool[N, k], point_ok bool[N], want_f = min(k, valid points))."""
    out = sweep_knn_select(s["planar"], s["starts_skip"], k=k)
    dists, idx, nvalid, count, kth, ok = _knn_unsort(
        out, k, s["block_ok"], s["inv"], n, s["order"], n)
    want_f = torch.clamp(s["use"].sum(), max=k).to(torch.float32)
    point_ok = (ok & (count >= want_f) & (kth <= _knn_safe2(s, cell_size))
                & s["use"] & ~s["table_overflow"])
    return dists, idx, nvalid, point_ok, want_f


def sweep_knn(xyz, valid, cell_size, *, k: int, wr: int = 4,
              table_size: int = SWEEP_TABLE_SIZE):
    """All-points kNN (self included) by the sorted-window sweep: (dists
    f32[N, k] Euclidean ascending (+inf pad), idx i32[N, k] original rows
    (-1 pad), nvalid bool[N, k], point_ok bool[N]). Certified rows hold
    exactly the k nearest, ties at equal distance to the smaller sorted
    position. ``cell_size`` is taken as float32."""
    cell_size = scalar_like(cell_size, xyz)
    s = _sorted_structure(xyz, valid, cell_size, wr, table_size)
    return _knn_pass1(s, xyz.shape[0], cell_size, k=k)[:4]


def _knn_rescue(knn, rout, k: int, want_f, radius, qvalid, table_overflow,
                rows_orig, qn: int, order, pn: int):
    """Scatter the certified rows of a `rescue_knn_idx` pass into the pass-1
    results ``knn`` = (dists, idx, nvalid, point_ok): a rescued row is
    certified iff it found min(k, valid points) neighbours strictly inside
    the (deflated) rescue ball. Uncertified rows keep their pass-1 values
    and point_ok False."""
    dists, idx, nvalid, point_ok = knn
    rd, rpos = rout[:k].T, rout[k:2 * k].T
    rc = radius * 0.99999
    rok = ((rout[2 * k] >= want_f) & (rout[2 * k + 1] <= rc * rc)
           & (rout[2 * k + 2] > 0.5) & qvalid & ~table_overflow)
    ridx = _positions_to_rows(rpos, order, pn).to(torch.int32)
    drop = torch.where(rok, rows_orig, qn)
    ok2 = rok[:, None]
    return (_set_rows(dists, drop, torch.where(ok2, rd, 0.0)),
            _set_rows(idx, drop, torch.where(ok2, ridx, 0)),
            _set_rows(nvalid, drop, ok2 & torch.isfinite(rd)),
            _set_rows(point_ok, drop, rok))


def sweep_knn_two_pass(xyz, valid, cell_size, *, k: int, fix_cap: int = 4096,
                       rescue_cells: float = 4.0, wr: int = 4,
                       table_size: int = SWEEP_TABLE_SIZE):
    """`sweep_knn` plus the exact AABB-group-pruned rescue (kernel
    `rescue_knn_idx`) of up to ``fix_cap`` flagged rows against the
    candidate groups within ``rescue_cells`` cells of their query block.
    Rows uncertified after both passes keep their pass-1 values and
    point_ok False (the caller's whole-cloud rescue takes them)."""
    n = xyz.shape[0]
    cell_size = scalar_like(cell_size, xyz)
    s = _sorted_structure(xyz, valid, cell_size, wr, table_size)
    dists, idx, nvalid, point_ok, want_f = _knn_pass1(s, n, cell_size, k=k)
    order = s["order"]
    radius = rescue_cells * cell_size
    planar_g, q_planar, active, qvalid, qsel = _rescue_structure(
        s["planar"], order, s["use"] & ~point_ok, fix_cap, n, radius)
    rout = rescue_knn_idx(planar_g, q_planar, active, k=k,
                          gr=RESCUE_GROUP_ROWS)
    return _knn_rescue((dists, idx, nvalid, point_ok), rout, k, want_f,
                       radius, qvalid, s["table_overflow"],
                       _rescue_rows_orig(order, qsel, n), n, order, n)


def _sorted_query_frame(qxyz, qvalid, mn, extent, cell_size,
                        table_size: int):
    """Sort a query set into an existing point grid's cell order (``mn``,
    ``extent`` of the point cloud's `_sorted_structure` at the same
    ``cell_size``) and pack it as a [QB, 4, 128] planar frame whose block b
    walks the point windows `_window_starts_from_bounds` gives its cell
    range. Valid queries whose cell lies outside the point grid sort to the
    tail with w = 0 and must be rescued (``in_ok`` False); their
    coordinates stay in the frame for the rescue. Non-finite coordinates
    are zeroed and never served (``use`` False)."""
    qn = qxyz.shape[0]
    dev = qxyz.device
    finite = torch.isfinite(qxyz).all(dim=-1)
    use = qvalid & finite
    qc = torch.where(finite[:, None], qxyz, 0.0)
    c = torch.clamp(torch.floor(qxyz / cell_size), -1e9, 1e9)
    c = torch.where(finite[:, None], c, 0.0).to(torch.int32)
    rel = c - mn[None, :]
    in_grid = ((rel >= 0) & (rel < extent[None, :])).all(dim=1)
    inb = use & in_grid
    relc = torch.minimum(torch.clamp(rel, min=0), extent[None, :] - 1).long()
    ext64 = extent.to(torch.int64)
    lin64 = (relc[:, 0] * ext64[1] + relc[:, 1]) * ext64[2] + relc[:, 2]
    lin = torch.where(inb, torch.clamp(lin64, 0, table_size - 1),
                      table_size).to(torch.int32)
    order = stable_argsort(lin)
    slin = lin[order]
    suse = slin < table_size
    tail = (-qn) % 128
    nb = (qn + tail) // 128
    sc = [_pad_tail(qc[order, i], tail, 0.0) for i in range(3)]
    slin = _pad_tail(slin, tail, table_size)
    suse = _pad_tail(suse, tail, False)
    blocks = slin.reshape(nb, 128)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(qn, dtype=order.dtype, device=dev)
    return dict(planar=_pack_planar(*sc, suse, nb), order=order, inv=inv,
                use=use, in_ok=inb, lo=blocks[:, 0], hi=blocks[:, -1],
                has_valid=suse.reshape(nb, 128).any(dim=1), nb=nb)


def sweep_knn_cross_two_pass(pxyz, pvalid, qxyz, qvalid, cell_size, *,
                             k: int, fix_cap: int = 4096,
                             rescue_cells: float = 4.0, wr: int = 4,
                             table_size: int = SWEEP_TABLE_SIZE):
    """Cross-cloud kNN (original point indices, per query row): the point
    cloud is sorted and windowed once, the queries are sorted into its cell
    frame (`_sorted_query_frame`) and swept by `sweep_knn_select` with the
    query frame; then the group-pruned rescue of the flagged queries
    (queries outside the point grid included). Same contract as
    `sweep_knn_two_pass`; returns (dists f32[Q, k], idx i32[Q, k], nvalid
    bool[Q, k], point_ok bool[Q]) in the original query order."""
    pn, qn = pxyz.shape[0], qxyz.shape[0]
    cell_size = scalar_like(cell_size, pxyz)
    sp = _sorted_structure(pxyz, pvalid, cell_size, wr, table_size)
    sq = _sorted_query_frame(qxyz, qvalid, sp["mn"], sp["extent"], cell_size,
                             table_size)
    starts, block_ok = _window_starts_from_bounds(
        sq["lo"], sq["hi"], sq["has_valid"], sp["slin_p"], sp["suse_p"],
        sp["extent"], sp["nrows"], sp["nb"], wr, table_size)
    out = sweep_knn_select(sp["planar"], starts, k=k, q_planar=sq["planar"])
    dists, idx, nvalid, count, kth, ok = _knn_unsort(
        out, k, block_ok, sq["inv"], qn, sp["order"], pn)
    want_f = torch.clamp(sp["use"].sum(), max=k).to(torch.float32)
    point_ok = (ok & (count >= want_f) & (kth <= _knn_safe2(sp, cell_size))
                & sq["in_ok"] & ~sp["table_overflow"])

    radius = rescue_cells * cell_size
    planar_g, q_planar, active, qvalid_r, qsel = _rescue_structure(
        sp["planar"], sq["order"], sq["use"] & ~point_ok, fix_cap, qn,
        radius, q_src=sq["planar"])
    rout = rescue_knn_idx(planar_g, q_planar, active, k=k,
                          gr=RESCUE_GROUP_ROWS)
    return _knn_rescue((dists, idx, nvalid, point_ok), rout, k, want_f,
                       radius, qvalid_r, sp["table_overflow"],
                       _rescue_rows_orig(sq["order"], qsel, qn), qn,
                       sp["order"], pn)
