"""Sorted-window sweep: SOR neighbour means and cluster labels over
cell-sorted planar rows.

Counterpart of `pointclouds_tpu/spatial/sweep.py`, ported for the KITTI
pipeline's path: the structure built on rows already sorted by sor cell
(`structure_from_sorted`), SOR pass 1 over flat per-block row lists, the
AABB-pruned exact rescue with lower bounds (`sweep_sor_two_pass`,
``with_lb``), and the row-list cluster labels (`sweep_cluster_labels`).

Points sorted by linearized cell id (z fastest) pack 128 to a planar row
``[x*128 | y*128 | z*128 | w*128]``; for a block of 128 consecutive sorted
queries the union of their 27-cell neighbourhoods is nine contiguous row
windows, flattened into one candidate row list per block. Every neighbour
query is certified exact or flagged, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.cloud import stable_argsort
from .grid import scalar_like
from .kernels import cluster_multisweep, rescue_select, sweep_select_rows

SWEEP_TABLE_SIZE = 1 << 21
NSHIFT = 9
RESCUE_GROUP_ROWS = 8  # candidate rows (of 128 points) per prune group


def _shift_offsets(extent):
    """[9] linear-id offsets for the (dx, dy) in {-1,0,1}^2 shifts."""
    return torch.stack([(dx * extent[1] + dy) * extent[2]
                        for dx in (-1, 0, 1) for dy in (-1, 0, 1)])


def _window_starts(slin_p, suse_p, extent, nrows, nb, wr, table_size):
    """Per-block window pack (start, skip, length, has-valid) and the
    per-block length certificate, for the same-cloud sweep."""
    blocks = slin_p[: nb * 128].reshape(nb, 128)
    has_valid = suse_p[: nb * 128].reshape(nb, 128).any(dim=1)
    return _window_starts_from_bounds(blocks[:, 0], blocks[:, -1], has_valid,
                                      slin_p, suse_p, extent, nrows, nb, wr,
                                      table_size)


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

    # first_row(c) = #rows with cell id < c (rows are cell-sorted).
    all_rows = slin_p.shape[0]
    nbt = slin_p[: p_nb * 128].reshape(p_nb, 128)
    p_hi = nbt[:, -1]

    def rows_less_blocked(c):
        w = c.shape[1]
        cf = c.reshape(nb * w, 1)
        nfull = (p_hi[None, :] < cf).sum(dim=1)
        jb = torch.clamp(nfull, max=p_nb - 1)
        cin = (nbt[jb] < cf).sum(dim=1)
        cnt = torch.where(nfull >= p_nb, p_nb * 128, nfull * 128 + cin)
        return torch.clamp(cnt, max=all_rows).reshape(nb, w)

    if nb <= 2048 and p_nb <= 2048:
        first_row = rows_less_blocked(a)
        last_row_raw = rows_less_blocked(zhi + 1)
    else:
        # Dense first-row table + suffix-min scan.
        pos = torch.arange(nrows * 128, dtype=torch.int64, device=dev)
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           slin_p[1:] != slin_p[:-1]])
        raw = torch.full((table_size + 2,), 2**30, dtype=torch.int64,
                         device=dev)
        raw[torch.where(first, slin_p.long(), table_size + 1)] = torch.where(
            first, pos, 2**30)
        raw[table_size + 1] = slin_p.shape[0]
        prefix = torch.flip(torch.cummin(torch.flip(raw, [0]), 0).values, [0])
        first_row = prefix[a.long()]
        last_row_raw = prefix[(zhi + 1).long()]
    first_row = first_row.to(torch.int32)
    last_row_raw = last_row_raw.to(torch.int32)

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
    return dict(planar=planar, starts_skip=starts_skip, block_ok=block_ok,
                extent=extent, hi_cells=hi_cells,
                table_overflow=table_overflow, slin_p=slin_p,
                grid_origin=grid_origin)


def _sweep_pass1(cell_size, *, k: int, prebuilt, row_cap: int):
    """Pass 1: exact k+1-smallest over each block's flat row list, mean
    neighbour distance and certificates, in the sorted frame. ``cell_size``
    is a float32 0-d tensor."""
    kp1 = k + 1
    s = prebuilt
    planar = s["planar"]
    starts_skip = s["starts_skip"]
    table_overflow = s["table_overflow"]
    rowlist, fits = _window_row_lists(starts_skip, row_cap, planar.shape[0])
    total, count, kth, seg_ok = sweep_select_rows(
        _planar_padded(planar), rowlist, k=kp1, cap=row_cap)
    block_ok = s["block_ok"] & fits
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

    margin = (s["hi_cells"] * 4.0 * 1.2e-7 + 1e-6) * cell_size
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


def _rescue_structure(planar, flagged, fix_cap: int, n: int, radius,
                      priority):
    """Pass-2 front end: compact flagged queries (priority rows first, then
    sorted order), pad the planar rows to rescue groups, and build each
    query block's AABB-pruned active-group list. Returns (planar_g,
    q_planar [QB, 4, 128], active i32[QB, 1 + NG], qvalid, qsel)."""
    dev = planar.device
    nrows = planar.shape[0]
    gr = RESCUE_GROUP_ROWS
    gpad = (-nrows) % gr
    planar_g = planar
    if gpad:
        planar_g = torch.cat([planar, torch.zeros((gpad, 4, 128),
                                                  device=dev)]).contiguous()
    ng = planar_g.shape[0] // gr

    key = torch.where(flagged, torch.where(priority, 0, 1), 2).to(torch.int32)
    fq = stable_argsort(key)
    fix_cap = ((fix_cap + 127) // 128) * 128
    qcap = min(fix_cap, ((n + 127) // 128) * 128)
    qsel = fq[: min(qcap, n)]
    if qcap > n:
        qsel = torch.cat([qsel, torch.zeros(qcap - n, dtype=qsel.dtype,
                                            device=dev)])
    qvalid = flagged[qsel]
    if qcap > n:
        qvalid = qvalid & (torch.arange(qcap, device=dev) < n)

    qx, qy, qz = (planar[:, i, :].reshape(-1)[qsel] for i in range(3))
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


def sweep_sor_two_pass(xyz, valid, cell_size, *, k: int, prebuilt,
                       fix_cap: int = 4096, rescue_cells: float = 4.0,
                       row_cap: int = 12):
    """Pass-1 sweep + exact AABB-pruned rescue of the flagged queries, with
    per-row lower bounds on the true mean (the keep-decision certificate's
    input). Returns (mean f32[N], point_ok bool[N], certified bool, lb
    f32[N]) in row order (``prebuilt`` has the identity permutation).

    Only the path the KITTI pipeline takes is ported: a
    `structure_from_sorted` ``prebuilt``, the row-list pass 1
    (``row_cap``) and the lower bounds (the reference's ``with_lb=True``).
    """
    if prebuilt is None or row_cap is None:
        raise NotImplementedError(
            "sweep_sor_two_pass: only prebuilt + row_cap is ported "
            "(ROADMAP.md, queue 1)")
    n = xyz.shape[0]
    cell_size = scalar_like(cell_size, xyz)
    p = _sweep_pass1(cell_size, k=k, prebuilt=prebuilt, row_cap=row_cap)
    kp1 = k + 1
    use_s = p["use_s"]
    nall = use_s.shape[0]
    wantf = p["want"].to(torch.float32)

    flagged_s = use_s & ~p["point_ok_s"]
    radius = rescue_cells * cell_size
    # Rows with no decision certificate from pass 1 go first when the
    # flagged rows exceed fix_cap.
    hard_s = flagged_s & (p["count_s"] >= wantf) & (p["mean_s"] > 2.0 * cell_size)
    planar_g, q_planar, active, qvalid, qsel = _rescue_structure(
        p["planar"], flagged_s, fix_cap, nall, radius, priority=hard_s)
    rtotal, rcount, rkth, rseg_ok = rescue_select(
        planar_g, q_planar, active, k=kp1, gr=RESCUE_GROUP_ROWS)

    n_neighbors = torch.clamp(rcount - 1.0, min=0.0)
    rmean = torch.where(n_neighbors > 0,
                        rtotal / torch.clamp(n_neighbors, min=1.0), torch.inf)
    rmean = torch.where(rcount >= wantf, rmean, torch.inf)
    rc = radius * 0.99999
    rok = (rcount >= wantf) & (rkth <= rc * rc) & rseg_ok & qvalid
    rok = rok & ~p["table_overflow"]

    # Lower bounds on the true mean: candidates are complete within R (the
    # coverage radius in pass 1, the rescue radius in pass 2). Count-short
    # rows: the missing neighbours are each > R. Others: each found
    # distance beyond R over-estimates its true counterpart by <= kth - R.
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
    rlb = torch.where(rok, rmean_f, rlb)

    # Scatter the rescued rows back (qsel are sorted positions; slot nall
    # swallows the non-flagged padding slots).
    pos = torch.where(qvalid, qsel, nall)
    merged = torch.zeros((3, nall + 1), dtype=torch.float32, device=xyz.device)
    merged[0, :nall] = p["mean_s"]
    merged[1, :nall] = p["point_ok_s"].to(torch.float32)
    merged[2, :nall] = lb1
    merged[:, pos] = torch.stack([torch.where(qvalid, rmean, 0.0),
                                  torch.where(qvalid, rok.float(), 0.0),
                                  torch.where(qvalid, rlb, 0.0)])
    mean_s, ok_s, lb_s = merged[0, :nall], merged[1, :nall] > 0.5, merged[2, :nall]
    # Flagged rows beyond fix_cap stay point_ok=False.
    certified = ~(use_s & ~ok_s).any()
    return mean_s[:n], ok_s[:n], certified, lb_s[:n]


# ── Clustering ──────────────────────────────────────────────────────────────


def cluster_cell_size(radius, hi_abs):
    """Sort-cell width for cluster sweeps: one radius plus the f32
    floor-rounding margin, so the 27-cell neighbourhood holds every
    within-radius candidate."""
    return radius * 1.00002 + hi_abs * 6e-7 + 1e-7


def _sorted_structure(xyz, valid, cell_size, wr: int, table_size: int):
    """Sort, pack and window-compute: the front half of the cluster sweep.
    ``cell_size`` is a float32 0-d tensor."""
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
                starts_skip=starts_skip, block_ok=block_ok, nrows=nrows,
                nb=nb, table_overflow=table_overflow, suse_p=suse_p)


def _cluster_epilogue(lab, s, n: int, nall: int, exact):
    """Sorted-position labels -> original-order labels: each valid point
    gets the smallest ORIGINAL row of its component, invalid points their
    own row."""
    dev = lab.device
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


def sweep_cluster_labels(xyz, valid, radius, *, wr: int = 7,
                         max_iters: int = 64,
                         table_size: int = SWEEP_TABLE_SIZE,
                         row_cap: int = 16):
    """Euclidean-cluster labels (inclusive distance ``radius``, taken as
    float32) by min-label propagation over the cell-sorted row lists.

    Returns (labels i32[N], exact bool): label = smallest original row in
    the component (invalid/non-finite points keep their own row). ``exact``
    is False when a block's windows or row list overflowed, or when the
    propagation did not converge within ``max_iters`` rounds."""
    if row_cap is None:
        raise NotImplementedError(
            "sweep_cluster_labels: only the row_cap path is ported "
            "(ROADMAP.md, queue 2: cluster_multisweep_windows)")
    n = xyz.shape[0]
    r32 = np.float32(radius)
    use_pre = valid & torch.isfinite(xyz).all(dim=-1)
    hi_abs = torch.where(use_pre[:, None], xyz.abs(), 0.0).amax()
    cell_size = cluster_cell_size(scalar_like(r32, xyz), hi_abs)

    s = _sorted_structure(xyz, valid, cell_size, wr, table_size)
    planar, nrows, nb = s["planar"], s["nrows"], s["nb"]
    nall = nrows * 128
    exact = s["block_ok"][:nb].all() & ~s["table_overflow"]
    rowlist, fits = _window_row_lists(s["starts_skip"], row_cap, nrows)
    labels, changed, _ = cluster_multisweep(
        planar, rowlist, float(r32 * r32), cap=row_cap,
        max_rounds=max_iters)
    exact = exact & fits[:nb].all() & ~changed.any()
    if nall > nb * 128:
        labels = torch.cat([labels, torch.arange(nb * 128, nall,
                                                 dtype=labels.dtype,
                                                 device=labels.device)])
    return _cluster_epilogue(labels, s, n, nall, exact)
