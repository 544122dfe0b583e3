"""Cell-centric dense grid: the cell-grid SOR backends, their coarse second
pass, the collapsed cell-graph clustering, and the kNN and radius-count
queries of the engine's cell-grid rungs.

Counterpart of `pointclouds_tpu/spatial/cellgrid.py` (`ring_offsets`,
`CellGrid`, `build_cellgrid`, `cert_cell2`, the neighbour-block gathers,
the selection helper, `cell_sor_mean_dists`, `point_sor_mean_dists`,
`cell_knn_subset`, the radius blocks and their label propagation
`cell_radius_neighbor_blocks`, `cell_propagate_labels`,
`cell_graph_adjacency`, `cell_graph_labels`, and the pointwise queries
`point_knn`, `point_radius_count`, `slab_knn`). Points are
scattered once into dense ``[C, M, ...]`` per-cell blocks; a dense
linear-id -> slot table gives each cell its ring of neighbour slots, and
each cell (or point) gathers its neighbour blocks as its candidate slab.

The k-smallest selections run through the hand-written kernels of
`kernels.py`: ``sor_select`` (one cell's queries against its slab) and
``segmented_select`` (k smallest of each work row, exact, so its ``ok`` is
always True: a superset of the rows the reference certifies, with equal
values on those). Squared distances take the forms XLA's CPU backend gives
the reference (measured bitwise): ``jnp.sum(diff * diff, -1)`` as
fma(dz, dz, fma(dy, dy, dx*dx)) on the XLA paths, the Pallas kernel's
fma(dz, dz, fma(dx, dx, dy*dy)) inside ``sor_select``. The rungs' queries
are XLA code in the reference (a k-step argmin), torch ops here: one exact
top-k on (d2, row) keys, ties to the smaller row.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.cloud import stable_argsort
from .grid import scalar_like
from .kernels import (_sqrt_f32, _topk_lex, fma_f32, segmented_select,
                      sor_select)

_INT32_MIN = -(2**31)
# An empty xyzw slot: no coordinates, row id -1 (invalid).
_PAD_XYZW = torch.tensor([0.0, 0.0, 0.0, -1.0])


def ring_offsets(ring: int) -> np.ndarray:
    r = range(-ring, ring + 1)
    return np.array(
        [(dx, dy, dz) for dx in r for dy in r for dz in r], dtype=np.int32
    )


NEIGHBOR_OFFSETS = ring_offsets(1)

DEFAULT_TABLE_SIZE = 1 << 21  # 2M cells, 8 MB int32
CELL_CHUNK = 2048
# Query-candidate pairs the torch selections materialise at a time.
_PAIR_CHUNK = 1 << 22


class CellGrid(NamedTuple):
    cell_xyz: torch.Tensor  # f32[C, M, 3] dense per-cell point blocks
    cell_xyzw: torch.Tensor  # f32[C, M, 4] xyz + original row id (-1 pad)
    cell_idx: torch.Tensor  # i32[C, M] original row ids (N for padding)
    cell_mask: torch.Tensor  # bool[C, M]
    neighbor_slots: torch.Tensor  # i32[C, K] neighbour slots (C if absent)
    point_slot: torch.Tensor  # i32[N] cell slot of each point (C if none)
    num_cells: torch.Tensor  # i64
    table: torch.Tensor  # i32[T+1] linear id -> slot (cell_cap if absent)
    min_coord: torch.Tensor  # i32[3] cell-coordinate origin
    extent: torch.Tensor  # i32[3]
    cell_size: torch.Tensor  # f32
    overflow: torch.Tensor  # bool: some cell holds > M points
    table_overflow: torch.Tensor  # bool: extent exceeded the table


def _take_fill(arr, idx):
    """``jnp.take(arr, idx)`` for a 1-D int32 ``arr``: negative indices
    count from the end, indices out of range give INT32_MIN (JAX's fill
    mode)."""
    size = arr.shape[0]
    i = idx.long()
    ok = (i >= -size) & (i < size)
    src = torch.where(ok, torch.where(i < 0, i + size, i), 0)
    return torch.where(ok, arr[src], _INT32_MIN)


def _scatter_rows(shape, fill, dtype, index, values, device):
    """``full(shape, fill).at[index].set(values, mode="drop")`` over the
    leading axis, for indices in [0, shape[0]]: the extra row shape[0]
    takes what the reference drops."""
    out = torch.empty((shape[0] + 1,) + tuple(shape[1:]), dtype=dtype,
                      device=device)
    out[:] = fill
    out[index] = values
    return out[: shape[0]]


def build_cellgrid(xyz, valid, cell_size, *, m_per_cell: int, cell_cap: int,
                   table_size: int = DEFAULT_TABLE_SIZE,
                   ring: int = 1) -> CellGrid:
    """Dense per-cell blocks of at most ``m_per_cell`` points for the
    valid finite rows of ``xyz`` f32[N, 3] (stable in row order), at most
    ``cell_cap`` cells, each with its (2 ring + 1)^3 neighbour slots.
    ``cell_size`` is taken as float32. Raises for N >= 2^24 (row ids ride
    the f32 w channel)."""
    n = xyz.shape[0]
    if n >= 1 << 24:
        raise ValueError(
            f"cell grid supports at most 2^24 points (got {n}); "
            "use the int64 grid engine for larger clouds")
    dev = xyz.device
    m = m_per_cell
    cell = scalar_like(cell_size, xyz)
    use = valid & torch.isfinite(xyz).all(dim=-1)

    c = torch.clamp(torch.floor(xyz / cell), -1e9, 1e9).to(torch.int32)
    big = 2**30
    mn = torch.clamp(torch.where(use[:, None], c, big).amin(dim=0),
                     max=big - 1)
    rel = torch.clamp(c - mn[None, :], min=0)
    mx = torch.where(use[:, None], rel, 0).amax(dim=0)
    extent = (mx + 1).to(torch.int32)

    # Linear id in int64 first to detect table overflow, then clamp.
    ext64 = extent.to(torch.int64)
    rel64 = rel.to(torch.int64)
    lin64 = (rel64[:, 0] * ext64[1] + rel64[:, 1]) * ext64[2] + rel64[:, 2]
    table_overflow = (ext64[0] * ext64[1] * ext64[2]) > table_size
    lin = torch.where(use, torch.clamp(lin64, 0, table_size - 1),
                      table_size).to(torch.int32)

    order = stable_argsort(lin)
    slin = lin[order]
    sxyz = xyz[order]
    sidx = order.to(torch.int32)
    suse = slin < table_size

    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       slin[1:] != slin[:-1]]) & suse
    slot = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(suse, slot, cell_cap)
    num_cells = first.sum()  # int64, as the reference's under x64

    pos = torch.arange(n, dtype=torch.int32, device=dev)
    seg_start = torch.cummax(torch.where(first, pos, -1), 0).values
    rank = pos - seg_start

    in_block = suse & (rank < m)
    overflow = (suse & (rank >= m)).any() | (num_cells > cell_cap)
    sslot = torch.where(in_block, slot, cell_cap)
    srank = torch.where(in_block, rank, 0)

    # Scatters with the reference's mode="drop": slots at or past cell_cap
    # land in the extra row.
    flat = (cell_cap * m,)
    at = torch.where(sslot < cell_cap, sslot.long() * m + srank.long(),
                     flat[0])
    cell_xyz = _scatter_rows(flat + (3,), 0.0, torch.float32, at, sxyz,
                             dev).reshape(cell_cap, m, 3)
    sxyzw = torch.cat([sxyz, torch.where(in_block, sidx.to(torch.float32),
                                         -1.0)[:, None]], dim=1)
    cell_xyzw = _scatter_rows(flat + (4,), _PAD_XYZW.to(dev), torch.float32,
                              at, sxyzw, dev).reshape(cell_cap, m, 4)
    cell_idx = _scatter_rows(flat, n, torch.int32, at, sidx,
                             dev).reshape(cell_cap, m)
    cell_mask = _scatter_rows(flat, False, torch.bool, at, in_block,
                              dev).reshape(cell_cap, m)

    # Dense linear-id -> slot table (one scatter; first rows only).
    table = torch.full((table_size + 1,), cell_cap, dtype=torch.int32,
                       device=dev)
    table[torch.where(first, slin, table_size).long()] = torch.where(
        first, slot, cell_cap)

    # Per-slot rel coords (scattered from first rows), then the neighbours.
    cell_rel = _scatter_rows(
        (cell_cap, 3), 0, torch.int32,
        torch.clamp(torch.where(first, slot, cell_cap), max=cell_cap).long(),
        rel[order], dev)
    noff = torch.from_numpy(ring_offsets(ring)).to(dev)
    nrel = cell_rel[:, None, :] + noff[None, :, :]  # [C, K, 3]
    in_bounds = ((nrel >= 0) & (nrel < extent[None, None, :])).all(dim=-1)
    nlin = (nrel[..., 0] * extent[1] + nrel[..., 1]) * extent[2] + nrel[..., 2]
    nlin = torch.where(in_bounds, nlin, table_size)
    neighbor_slots = _take_fill(table, nlin.reshape(-1)).reshape(nlin.shape)
    # Slots >= num_cells are stale block rows; mask them out.
    slot_valid = torch.arange(cell_cap, device=dev)[:, None] < num_cells
    neighbor_slots = torch.where((neighbor_slots < num_cells) & slot_valid,
                                 neighbor_slots, cell_cap)

    # Map back: original point row -> its cell slot.
    point_slot = _scatter_rows((n,), cell_cap, torch.int32,
                               torch.where(suse, sidx, n).long(), sslot, dev)

    return CellGrid(
        cell_xyz=cell_xyz,
        cell_xyzw=cell_xyzw,
        cell_idx=cell_idx,
        cell_mask=cell_mask,
        neighbor_slots=neighbor_slots,
        point_slot=point_slot,
        num_cells=num_cells,
        table=table,
        min_coord=mn,
        extent=extent,
        cell_size=cell,
        overflow=overflow,
        table_overflow=table_overflow,
    )


def cert_cell2(grid: CellGrid):
    """Squared certification radius: one cell width less the f32
    floor-rounding margin, bounded from the grid's own cell extents. Taken
    as XLA's CPU backend contracts the reference: margin = fma(hi * 4,
    1.2e-7, 1e-6), safe = fma(-margin, cell, cell) (measured bitwise)."""
    hi = torch.maximum(grid.min_coord.abs(),
                       (grid.min_coord + grid.extent).abs()).amax()
    hi4 = (hi.to(torch.float32) * 4.0).reshape(1)
    one = (1,)
    margin = fma_f32(hi4, scalar_like(np.float32(1.2e-7), hi4).reshape(one),
                     scalar_like(np.float32(1e-6), hi4).reshape(one))
    cs = grid.cell_size.reshape(one)
    safe = torch.clamp(fma_f32(-margin, cs, cs), min=0.0)[0]
    return safe * safe


def gather_neighbor_blocks(grid: CellGrid, slots):
    """[..., M, 3] coordinates and [..., M] mask of the neighbour blocks
    ``slots`` (absent slots, >= C, masked out). The reference also gathers
    the blocks' row ids; only `cell_radius_neighbor_blocks` reads them,
    and gathers them itself."""
    cap, m, _ = grid.cell_xyz.shape
    flat = torch.clamp(slots, 0, cap - 1).reshape(-1).long()
    absent = slots >= cap
    nb_xyz = grid.cell_xyz[flat].reshape(slots.shape + (m, 3))
    nb_mask = (grid.cell_mask[flat].reshape(slots.shape + (m,))
               & ~absent[..., None])
    return nb_xyz, nb_mask


def gather_neighbor_xyzw(grid: CellGrid, slots):
    """One-gather neighbour blocks: [..., M, 3] coordinates and [..., M]
    validity (w >= 0; absent slots invalid)."""
    cap, m, _ = grid.cell_xyzw.shape
    flat = torch.clamp(slots, 0, cap - 1).reshape(-1).long()
    nb = grid.cell_xyzw[flat].reshape(slots.shape + (m, 4))
    w = torch.where((slots >= cap)[..., None], -1.0, nb[..., 3])
    return nb[..., :3], w >= 0.0


def _xyzw_rows(grid: CellGrid, slots):
    """[..., K M, 4] packed candidate blocks (xyz and row id) of ``slots``
    [..., K]; absent slots as empty xyzw (row id -1)."""
    cap, m, _ = grid.cell_xyzw.shape
    nb = grid.cell_xyzw[torch.clamp(slots, max=cap - 1).long()]
    nb = torch.where((slots >= cap)[..., None, None],
                     _PAD_XYZW.to(nb.device), nb)
    return nb.reshape(slots.shape[:-1] + (slots.shape[-1] * m, 4))


def _chunk_cells(grid: CellGrid, chunk: int) -> None:
    """The reference's tiling contract: cell_cap a multiple of ``chunk``."""
    cap = grid.cell_xyz.shape[0]
    if cap % chunk:
        raise ValueError(f"cell_cap {cap} % {chunk} != 0")


def _sum_sq(diff):
    """``jnp.sum(diff * diff, -1)`` over a trailing xyz axis, as XLA's CPU
    backend contracts it: fma(dz, dz, fma(dy, dy, dx*dx))."""
    dx, dy, dz = diff.unbind(-1)
    return fma_f32(dz, dz, fma_f32(dy, dy, dx * dx))


def _smallest_k_sum_count(d2, valid, k: int):
    """Sum of the square roots (added in ascending order), count (int32)
    and last value of the k smallest valid ``d2`` per row of [..., W]; kth
    0 where none. Exact (kernel ``segmented_select``), so the reference's
    segmented variant (`_segmented_smallest_k`, whose certificate an exact
    selection always passes) is this same function here."""
    work = torch.where(valid, d2, torch.inf)
    lead = work.shape[:-1]
    total, count, kth, _ = segmented_select(
        work.reshape(-1, work.shape[-1]).contiguous(), k=k)
    return (total.reshape(lead), count.to(torch.int32).reshape(lead),
            kth.reshape(lead))


def _means(total, count, k: int, grid: CellGrid):
    """Mean over the non-self neighbours, +inf below ``want`` results, and
    ``want`` = min(k + 1, valid points)."""
    n_neighbors = torch.clamp(count - 1, min=0)
    mean = torch.where(n_neighbors > 0,
                       total / torch.clamp(n_neighbors.to(torch.float32),
                                           min=1.0), torch.inf)
    want = torch.clamp(grid.cell_mask.sum(), max=k + 1)
    return torch.where(count >= want, mean, torch.inf), want


def _cell_rows(width: int) -> int:
    """Cells per torch chunk: about `_PAIR_CHUNK` pairs of ``width``."""
    return max(1, _PAIR_CHUNK // max(width, 1))


def cell_sor_mean_dists(grid: CellGrid, *, k: int, chunk: int = CELL_CHUNK,
                        backend: str = "xla"):
    """Per-point mean distance to the k nearest non-self neighbours,
    computed cell-centrically (queries = each cell's own points). Returns
    (mean f32[N] in original row order, point_ok bool[N], certified bool):
    ``point_ok`` is False where the result is not certified exact (kth
    beyond one cell width, or fewer than k+1 candidates).

    ``backend`` "pallas" / "pallas_interpret" gathers every cell's slab and
    runs kernel ``sor_select``; any other string takes the chunked torch
    selection (kernel ``segmented_select``), the same function."""
    cell2 = cert_cell2(grid)
    caps, m, _ = grid.cell_xyz.shape
    qm = grid.cell_mask
    if backend in ("pallas", "pallas_interpret"):
        nb_xyz, nb_mask = gather_neighbor_blocks(grid, grid.neighbor_slots)
        total, count, kth = sor_select(
            grid.cell_xyz.permute(0, 2, 1).contiguous(), qm.contiguous(),
            nb_xyz.reshape(caps, -1, 3).contiguous(),
            nb_mask.reshape(caps, -1).contiguous(), k=k)
    else:
        _chunk_cells(grid, chunk)
        km = grid.neighbor_slots.shape[1] * m
        total = torch.zeros((caps, m), dtype=torch.float32,
                            device=qm.device)
        count = torch.zeros((caps, m), dtype=torch.int32, device=qm.device)
        kth = torch.zeros((caps, m), dtype=torch.float32, device=qm.device)
        # Cells past num_cells hold no query (their rows stay zero, as the
        # reference computes them): one host read bounds the work.
        occupied = int(grid.num_cells)
        step = _cell_rows(m * km)
        for s in range(0, min(caps, occupied), step):
            sl = slice(s, min(s + step, caps))
            nb_xyz, nb_mask = gather_neighbor_blocks(
                grid, grid.neighbor_slots[sl])
            c = nb_xyz.shape[0]
            nbf = nb_xyz.reshape(c, km, 3)
            d2 = _sum_sq(grid.cell_xyz[sl][:, :, None, :] - nbf[:, None])
            pair = qm[sl][:, :, None] & nb_mask.reshape(c, km)[:, None, :]
            total[sl], count[sl], kth[sl] = _smallest_k_sum_count(
                d2, pair, k + 1)

    mean, want = _means(total, count, k, grid)
    ok_q = (count >= want) & (kth <= cell2)
    certified = ~(qm & ~ok_q).any()

    # Scatter back to original point order.
    n = grid.point_slot.shape[0]
    flat_m = qm.reshape(-1)
    safe_idx = torch.where(flat_m, grid.cell_idx.reshape(-1), n).long()
    out = _scatter_rows((n,), torch.inf, torch.float32, safe_idx,
                        torch.where(flat_m, mean.reshape(-1), torch.inf),
                        qm.device)
    # Points in no block (invalid or rank-truncated) are not ok.
    point_ok = _scatter_rows((n,), False, torch.bool, safe_idx,
                             flat_m & ok_q.reshape(-1), qm.device)
    return out, point_ok, certified


def cell_knn_subset(grid: CellGrid, qxyz, qrows, qvalid, *, k: int):
    """Per-query kNN mean distances for a compacted subset of points
    (``qxyz`` f32[B, 3], original rows ``qrows`` i32[B], ``qvalid``
    bool[B]) against a (typically coarser) grid: the second pass that
    resolves the points the cell-centric pass could not certify. Returns
    (mean f32[B], ok bool[B]) with `cell_sor_mean_dists`'s semantics."""
    cap = grid.cell_xyz.shape[0]
    n = grid.point_slot.shape[0]
    dev = qxyz.device
    kk = grid.neighbor_slots.shape[1]
    slot = torch.cat([grid.point_slot, torch.tensor([cap], dtype=torch.int32,
                                                     device=dev)])
    slot = slot[torch.clamp(qrows.long(), max=n)]
    nbs = torch.cat([grid.neighbor_slots,
                     torch.full((1, kk), cap, dtype=torch.int32, device=dev)])
    nb = nbs[torch.clamp(slot, max=cap).long()]  # [B, K]
    nb_xyz, nb_mask = gather_neighbor_xyzw(grid, nb)
    b, _, m, _ = nb_xyz.shape
    nbf = nb_xyz.reshape(b, kk * m, 3)
    nbm = nb_mask.reshape(b, kk * m) & qvalid[:, None]
    d2 = _sum_sq(nbf - qxyz[:, None, :])
    # The reference's segmented selection (k + 1 <= 32, >= 512 candidates)
    # certifies a subset of these exact rows, with equal values.
    total, count, kth = _smallest_k_sum_count(d2, nbm, k + 1)
    mean, want = _means(total, count, k, grid)
    return mean, (count >= want) & (kth <= cert_cell2(grid))


def cell_radius_neighbor_blocks(grid: CellGrid, radius, *,
                                chunk: int = CELL_CHUNK):
    """Per-cell candidate blocks for radius queries: (nb_idx i32[C, KM],
    the original rows of each cell's K neighbour blocks, K = 27 at ring 1,
    and within bool[C, M, KM], whether candidate j lies within ``radius``
    (inclusive, float32) of the cell's point i). Complete where the ring
    spans the radius (ring 1: cell >= radius). The cells go in chunks of
    at most ``chunk`` (fewer where their pairs pass `_PAIR_CHUNK`); cells
    past num_cells hold no point, so their rows stay False (one host
    read)."""
    _chunk_cells(grid, chunk)
    caps, m, _ = grid.cell_xyz.shape
    kk = grid.neighbor_slots.shape[1]
    dev = grid.cell_xyz.device
    r = scalar_like(radius, grid.cell_xyz)
    r2 = r * r
    # Absent slots read the last cell's rows, as the reference's clamped
    # gather does; `within` masks them out.
    nb_idx = grid.cell_idx[torch.clamp(grid.neighbor_slots, 0, caps - 1)
                           .long()].reshape(caps, kk * m)
    within = torch.zeros((caps, m, kk * m), dtype=torch.bool, device=dev)
    occupied = int(grid.num_cells)
    step = min(chunk, _cell_rows(m * kk * m))
    for s in range(0, min(caps, occupied), step):
        sl = slice(s, min(s + step, caps))
        nb_xyz, nb_mask = gather_neighbor_blocks(grid, grid.neighbor_slots[sl])
        c = nb_xyz.shape[0]
        d2 = _sum_sq(grid.cell_xyz[sl][:, :, None, :]
                     - nb_xyz.reshape(c, kk * m, 3)[:, None])
        within[sl] = (grid.cell_mask[sl][:, :, None]
                      & nb_mask.reshape(c, kk * m)[:, None, :] & (d2 <= r2))
    return nb_idx, within


def cell_propagate_labels(grid: CellGrid, nb_idx, within):
    """Connected-component labels by min-label propagation over the blocks
    of `cell_radius_neighbor_blocks`, each round followed by two pointer
    jumps, until a round changes no label (one host read a round). Labels
    are original rows (the smallest of each component); invalid points
    keep their own row. Returns i32[N]. Cells past num_cells hold no
    point and are skipped (one host read)."""
    n = grid.point_slot.shape[0]
    _, m, width = within.shape
    dev = within.device
    big = torch.tensor([n], dtype=torch.int32, device=dev)
    occupied = min(int(grid.num_cells), within.shape[0])
    cm = grid.cell_mask[:occupied]
    rows = torch.where(cm, grid.cell_idx[:occupied], n).long()  # [C', M]
    nbl = nb_idx[:occupied].long()
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    step = _cell_rows(m * width)
    while True:
        ext = torch.cat([labels, big])
        new_min = torch.empty((occupied, m), dtype=torch.int32, device=dev)
        for s in range(0, occupied, step):
            sl = slice(s, min(s + step, occupied))
            cand = torch.where(within[sl], ext[nbl[sl]][:, None, :], big)
            new_min[sl] = cand.amin(dim=-1)
        new_min = torch.minimum(new_min, ext[rows])
        upd = torch.full((n + 1,), n, dtype=torch.int32, device=dev)
        upd.scatter_reduce_(0, rows.reshape(-1),
                            torch.where(cm, new_min, big).reshape(-1),
                            reduce="amin")
        new = torch.minimum(labels, upd[:n])
        for _ in range(2):
            new = torch.minimum(new, new[new.long()])
        changed = bool((new != labels).any())  # host read: the stop test
        labels = new
        if not changed:
            return labels


# ── Collapsed cell-graph clustering ──────────────────────────────────────────
#
# With cell = r/2 and ring 2 the cell diagonal stays below r, so all points
# of one cell are connected and each occupied cell collapses to one graph
# node; the cell-pair adjacency is computed once and min-label propagation
# runs on the small cell graph.


def cell_graph_adjacency(grid: CellGrid, radius, *, chunk: int = 256):
    """bool[C, K] adjacency: does any point pair between cell c and its
    k-th ring neighbour lie within ``radius`` (inclusive, float32)?"""
    _chunk_cells(grid, chunk)
    caps, m, _ = grid.cell_xyz.shape
    kk = grid.neighbor_slots.shape[1]
    dev = grid.cell_xyz.device
    r = scalar_like(radius, grid.cell_xyz)
    r2 = r * r
    adj = torch.zeros((caps, kk), dtype=torch.bool, device=dev)
    # Cells past num_cells hold no point: no edge (one host read).
    occupied = int(grid.num_cells)
    step = _cell_rows(m * kk * m)
    for s in range(0, min(caps, occupied), step):
        sl = slice(s, min(s + step, caps))
        nb_xyz, nb_mask = gather_neighbor_xyzw(grid, grid.neighbor_slots[sl])
        c = nb_xyz.shape[0]
        nbf = nb_xyz.reshape(c, kk * m, 3)
        d2 = _sum_sq(grid.cell_xyz[sl][:, :, None, :] - nbf[:, None])
        ok = (grid.cell_mask[sl][:, :, None]
              & nb_mask.reshape(c, kk * m)[:, None, :] & (d2 <= r2))
        adj[sl] = ok.reshape(c, m, kk, m).any(dim=3).any(dim=1)
    return adj


def cell_graph_labels(grid: CellGrid, adjacency):
    """Min-label propagation + pointer jumping on the collapsed cell graph
    (one host read per round: the change test). Returns per-POINT labels
    i32[N] in original order: the smallest original row of each component;
    invalid points keep their own row."""
    cap = grid.cell_xyz.shape[0]
    n = grid.point_slot.shape[0]
    dev = adjacency.device
    big = torch.tensor([cap], dtype=torch.int32, device=dev)
    nbr = torch.clamp(torch.where(adjacency, grid.neighbor_slots, cap), 0,
                      cap).long()
    lab = torch.arange(cap, dtype=torch.int32, device=dev)
    while True:
        nl = torch.cat([lab, big])[nbr]
        m = torch.minimum(nl.amin(dim=1), lab)
        for _ in range(2):
            m = torch.minimum(m, torch.cat([m, big])[m.long()])
        changed = bool((m != lab).any())
        lab = m
        if not changed:
            break

    # Representative = smallest original row in the component.
    min_row = torch.where(grid.cell_mask, grid.cell_idx, n).amin(dim=1)
    rep = torch.full((cap + 1,), n, dtype=torch.int32, device=dev)
    rep.scatter_reduce_(0, lab.long(), min_row, reduce="amin")
    cell_rep = torch.cat([rep[lab.long()],
                          torch.tensor([n], dtype=torch.int32, device=dev)])
    plab = cell_rep[torch.clamp(grid.point_slot, max=cap).long()]
    own = torch.arange(n, dtype=torch.int32, device=dev)
    return torch.where(plab >= n, own, plab)


def point_sor_mean_dists(grid: CellGrid, xyz, valid, *, k: int,
                         qchunk: int = 4096):
    """Query-centric SOR means: each point's k+1 smallest over its own
    cell's slab. Same contract as `cell_sor_mean_dists` (mean, point_ok,
    certified). Each cell's neighbour slab is materialised once; each
    point's slab row becomes one work row of squared distances (+inf
    masked, padded to a multiple of 128), and kernel ``segmented_select``
    selects over all rows at once (the reference's "kernel" branch; its
    "xla" branch computes the same function)."""
    cap, m, _ = grid.cell_xyz.shape
    n = xyz.shape[0]
    dev = xyz.device
    km = grid.neighbor_slots.shape[1] * m
    cell2 = cert_cell2(grid)

    # Stage 1: every cell's candidate slab, [C, KM, 4].
    slab = _xyzw_rows(grid, grid.neighbor_slots)

    # Stage 2: each point's slab row -> one work row.
    q_use = valid & torch.isfinite(xyz).all(dim=-1)
    slot = torch.clamp(grid.point_slot, max=cap - 1).long()
    in_grid = grid.point_slot < cap
    use = q_use & in_grid
    km_pad = -(-km // 128) * 128
    work = torch.full((n, km_pad), torch.inf, dtype=torch.float32, device=dev)
    for s in range(0, n, qchunk):
        e = min(s + qchunk, n)
        row = slab[slot[s:e]]
        cv = (row[..., 3] >= 0.0) & use[s:e, None]
        d2 = _sum_sq(row[..., :3] - xyz[s:e, None, :])
        work[s:e, :km] = torch.where(cv, d2, torch.inf)
    total, count_f, kth, seg_ok = segmented_select(work, k=k + 1)
    count = count_f.to(torch.int32)

    mean, want = _means(total, count, k, grid)
    mean = torch.where(q_use, mean, torch.inf)
    point_ok = (count >= want) & (kth <= cell2) & seg_ok & use
    certified = ~(q_use & ~point_ok).any()
    return mean, point_ok, certified


# ── General (cross-cloud) pointwise queries ──────────────────────────────────
#
# The queries need not be the grid's own points: each query's 27 neighbour
# cells come from the dense table by its cell coordinates, and each (query,
# cell) pair fetches that cell's xyzw block. `engine.knn` and
# `engine.radius_count` take these rungs.


def _query_neighbor_slots(grid: CellGrid, qxyz):
    """[Q, 27] neighbour cell slots of arbitrary query positions (cell_cap
    where absent or out of range)."""
    cap = grid.cell_xyz.shape[0]
    table_size = grid.table.shape[0] - 1
    c = torch.floor(qxyz / grid.cell_size)
    c = torch.clamp(c, -1e9, 1e9).to(torch.int32)
    rel = c - grid.min_coord[None, :]
    noff = torch.from_numpy(NEIGHBOR_OFFSETS).to(qxyz.device)
    nrel = rel[:, None, :] + noff[None, :, :]  # [Q, 27, 3]
    in_bounds = ((nrel >= 0) & (nrel < grid.extent[None, None, :])).all(
        dim=-1)
    ext = grid.extent
    nlin = (nrel[..., 0] * ext[1] + nrel[..., 1]) * ext[2] + nrel[..., 2]
    nlin = torch.where(in_bounds, nlin, table_size)
    slots = _take_fill(grid.table, nlin.reshape(-1)).reshape(nlin.shape)
    return torch.where(slots < grid.num_cells, slots, cap)


def _knn_rows(rows, qx, qu, kk: int):
    """Exact kk smallest (d2, row id) of each query over its candidate
    rows [q, W, 4] (ties to the smaller original row: the port's rule, where
    the reference's k-step argmin keeps candidate order). Returns (d2 f32[q,
    kk] ascending, +inf past the candidates; row ids i64[q, kk]; valid
    candidates found i32[q])."""
    ids = rows[..., 3]
    cv = (ids >= 0.0) & qu[:, None]
    d2 = _sum_sq(rows[..., :3] - qx[:, None, :])
    work = torch.where(cv, d2, torch.inf)
    pos = torch.where(cv, ids, 2.0**31).to(torch.int64)
    vals, rid = _topk_lex(work, kk, pos=pos)
    return vals, rid, cv.sum(dim=1).to(torch.int32)


def _knn_result(d2k, ids, found, q_use, grid: CellGrid, k: int, kk: int,
                in_grid=None):
    """(dists, idx, nvalid, point_ok) from the selected d2 and row ids, with
    the reference's certificate: min(k, grid points) found and the kth d2
    within `cert_cell2`; invalid queries certified; fewer candidate slots
    than k padded and flagged."""
    nvalid = torch.isfinite(d2k)
    dists = torch.where(nvalid, _sqrt_f32(torch.clamp(d2k, min=0.0)),
                        torch.inf)
    idx = torch.where(nvalid, ids, 0).to(torch.int32)
    want = torch.clamp(grid.cell_mask.sum(), max=k)
    kth_col = torch.clamp(want - 1, 0, kk - 1)
    kth_d2 = torch.where(nvalid, d2k, torch.inf)[:, kth_col]
    point_ok = (found >= want) & (kth_d2 <= cert_cell2(grid))
    if in_grid is not None:
        point_ok = point_ok & q_use & in_grid
    point_ok = point_ok | ~q_use
    if kk < k:  # fewer candidate slots than k: pad and let the flags retry
        padc = k - kk
        dists = torch.nn.functional.pad(dists, (0, padc), value=torch.inf)
        idx = torch.nn.functional.pad(idx, (0, padc))
        nvalid = torch.nn.functional.pad(nvalid, (0, padc))
        point_ok = torch.zeros_like(point_ok)
    return dists, idx, nvalid, point_ok


def point_knn(grid: CellGrid, qxyz, qvalid, *, k: int, qchunk: int = 2048):
    """K nearest grid points of each query over its 27-cell neighbourhood.

    Returns (dists f32[Q, k] Euclidean ascending (+inf beyond results),
    idx i32[Q, k] original rows (0 where invalid), nvalid bool[Q, k],
    point_ok bool[Q]): the per-query certificate, min(k, grid points)
    found and the kth distance within one cell less the f32 margin; True
    for invalid queries, whose empty result is final. Queries run in
    chunks of ``qchunk``: one chunk gathers [qchunk, 27 M, 4]."""
    nq = qxyz.shape[0]
    dev = qxyz.device
    m = grid.cell_xyzw.shape[1]
    kk = min(k, 27 * m)
    finite = torch.isfinite(qxyz).all(dim=-1)
    q_use = qvalid & finite
    slots = _query_neighbor_slots(grid, torch.where(finite[:, None], qxyz,
                                                    0.0))
    d2k = torch.empty((nq, kk), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, kk), dtype=torch.int64, device=dev)
    found = torch.empty(nq, dtype=torch.int32, device=dev)
    for s in range(0, nq, qchunk):
        e = min(s + qchunk, nq)
        d2k[s:e], ids[s:e], found[s:e] = _knn_rows(
            _xyzw_rows(grid, slots[s:e]), qxyz[s:e], q_use[s:e], kk)
    return _knn_result(d2k, ids, found, q_use, grid, k, kk)


def point_radius_count(grid: CellGrid, qxyz, qvalid, radius, *,
                       qchunk: int = 4096):
    """Count of grid points within ``radius`` (inclusive) of each query,
    int32[Q], r2 as `knn._radius_sq` forms it. Exact iff radius <= the
    cell and no block truncated (``grid.overflow``)."""
    from .knn import _radius_sq

    nq = qxyz.shape[0]
    dev = qxyz.device
    r2 = _radius_sq(radius, dev)
    finite = torch.isfinite(qxyz).all(dim=-1)
    q_use = qvalid & finite
    slots = _query_neighbor_slots(grid, torch.where(finite[:, None], qxyz,
                                                    0.0))
    counts = torch.empty(nq, dtype=torch.int32, device=dev)
    for s in range(0, nq, qchunk):
        e = min(s + qchunk, nq)
        rows = _xyzw_rows(grid, slots[s:e])
        ok = ((rows[..., 3] >= 0.0) & q_use[s:e, None]
              & (_sum_sq(rows[..., :3] - qxyz[s:e, None, :]) <= r2))
        counts[s:e] = ok.sum(dim=1).to(torch.int32)
    return counts


def slab_knn(grid: CellGrid, qxyz, qvalid, *, k: int, qchunk: int = 4096):
    """Same-cloud kNN in the two-stage slab pattern: every cell's candidate
    slab materialised once, then one slab row a query. The queries must be
    the grid's own points (`point_slot`). Returns `point_knn`'s (dists,
    idx, nvalid, point_ok); a point in no block is not certified."""
    cap, m, _ = grid.cell_xyzw.shape
    n = qxyz.shape[0]
    dev = qxyz.device
    kk = min(k, grid.neighbor_slots.shape[1] * m)
    slab = _xyzw_rows(grid, grid.neighbor_slots)  # [C, 27 M, 4]
    q_use = qvalid & torch.isfinite(qxyz).all(dim=-1)
    in_grid = grid.point_slot < cap
    slot = torch.clamp(grid.point_slot, max=cap - 1).long()
    use = q_use & in_grid
    d2k = torch.empty((n, kk), dtype=torch.float32, device=dev)
    ids = torch.empty((n, kk), dtype=torch.int64, device=dev)
    found = torch.empty(n, dtype=torch.int32, device=dev)
    for s in range(0, n, qchunk):
        e = min(s + qchunk, n)
        d2k[s:e], ids[s:e], found[s:e] = _knn_rows(
            slab[slot[s:e]], qxyz[s:e], use[s:e], kk)
    return _knn_result(d2k, ids, found, q_use, grid, k, kk, in_grid=in_grid)
