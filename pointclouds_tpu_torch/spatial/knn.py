"""Batched kNN and radius queries, brute force and over the int64-keyed
grid: the counterpart of `pointclouds_tpu/spatial/knn.py`.

These are XLA code in the JAX package (no Pallas kernel), so they stay
torch ops here. The brute force serves small clouds (at most
`engine.BRUTE_THRESHOLD` points) and the engine's exact fallbacks; the grid
queries (`grid_knn`, `grid_radius_count`, `grid_radius_neighbors`) serve
clouds of 2^24 points or more and the clustering rung before the brute
force, and return the flags by which the engine retries;
`radius_within_mask` is the single-query radius search of
`engine.radius_indices`. Distances are
Euclidean, ascending; an invalid or non-finite query gets no results.

The exact squared distance is pinned to the form XLA's CPU backend gives
the JAX package's ``jnp.sum(diff * diff, axis=-1)``: fma(dz, dz, fma(dy,
dy, dx*dx)) (measured: 100% bitwise on random pairs, against 87-97% for
the other orders). Note that the sweep kernels' form is fma(dz, dz,
fma(dx, dx, dy*dy)) (`kernels._d2`); the two differ in the last ulp.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.segmentation import _full_fp32_matmul
from .grid import GridHash, gather_candidates
from .kernels import _sqrt_f32, _topk_lex, fma_f32

# Query rows per chunk: at most this many query-point pairs at once (query
# slots at once, for the grid queries). The JAX package maps over chunks of
# 1024 queries; the chunks are independent, so their size changes nothing.
_CHUNK_ELEMS = 1 << 24


def _d2_sum(q, p):
    """[..., 3] x [..., 3] -> the pinned fma(dz, dz, fma(dy, dy, dx*dx))."""
    d = q - p
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return fma_f32(dz, dz, fma_f32(dy, dy, dx * dx))


def _query_use(qxyz, qvalid):
    return qvalid & torch.isfinite(qxyz).all(dim=-1)


def bruteforce_knn(pxyz, pvalid, qxyz, qvalid, k: int):
    """Exact kNN of each query against all valid points.

    Returns (dists f32[Q, k], idx i32[Q, k], nvalid bool[Q, k]); ``nvalid``
    marks real results (fewer than k when fewer valid points exist or the
    query is invalid / non-finite).

    As in the JAX package: a preselection of ``max(2k, k + 8)`` candidates
    by the centred |q|^2 + |p|^2 - 2 q.p matmul form (full f32, TF32 off),
    then the exact difference-based d2 on those, ranked again."""
    n = pxyz.shape[0]
    dev = pxyz.device
    puse = pvalid & torch.isfinite(pxyz).all(dim=-1)
    inf = torch.tensor(torch.inf, device=dev)
    plo = torch.where(puse[:, None], pxyz, inf).amin(dim=0)
    phi = torch.where(puse[:, None], pxyz, -inf).amax(dim=0)
    center = torch.where(torch.isfinite(plo), 0.5 * plo + 0.5 * phi, 0.0)
    pc = torch.where(puse[:, None], pxyz - center, 0.0)
    p2 = (pc * pc).sum(dim=-1)
    k_eff = min(k, n)
    k_sel = min(max(2 * k_eff, k_eff + 8), n)

    quse = _query_use(qxyz, qvalid)
    nq = qxyz.shape[0]
    dists = torch.full((nq, k), torch.inf, dtype=torch.float32, device=dev)
    idx = torch.zeros((nq, k), dtype=torch.int32, device=dev)
    step = max(1, _CHUNK_ELEMS // max(n, 1))
    with _full_fp32_matmul():
        for s in range(0, nq, step):
            qc, uc = qxyz[s:s + step], quse[s:s + step]
            qcc = torch.where(uc[:, None], qc - center, 0.0)
            d2 = (qcc * qcc).sum(-1)[:, None] + p2[None, :] - 2.0 * (
                qcc @ pc.T)
            d2 = torch.where(uc[:, None] & puse[None, :], d2, torch.inf)
            pre_d2, pre_idx = _topk_lex(d2, k_sel)
            d2x = _d2_sum(qc[:, None, :], pxyz[pre_idx])
            d2x = torch.where(torch.isfinite(pre_d2), d2x, torch.inf)
            vals, at = _topk_lex(d2x, k_eff)
            dists[s:s + step, :k_eff] = vals
            idx[s:s + step, :k_eff] = torch.gather(pre_idx, 1, at).to(
                torch.int32)
    nvalid = torch.isfinite(dists)
    dists = torch.where(nvalid, _sqrt_f32(torch.clamp(dists, min=0.0)),
                        torch.inf)
    return dists, idx, nvalid


def _radius_sq(radius, device):
    """r2 as the JAX package's jitted functions square ``radius``: a Python
    float is a weakly typed float64 there, so r2 is its square in float64
    rounded to f32; anything else is taken as f32 and squared in f32."""
    if type(radius) is float:
        return torch.tensor(np.float32(radius * radius), device=device)
    r = torch.as_tensor(radius, dtype=torch.float32, device=device)
    return r * r


def bruteforce_radius_count(pxyz, pvalid, qxyz, qvalid, radius):
    """Number of valid points with d2 <= r2 (inclusive) of each query,
    int32[Q], r2 as `_radius_sq` forms it."""
    dev = pxyz.device
    puse = pvalid & torch.isfinite(pxyz).all(dim=-1)
    quse = _query_use(qxyz, qvalid)
    r2 = _radius_sq(radius, dev)
    nq, n = qxyz.shape[0], pxyz.shape[0]
    counts = torch.zeros(nq, dtype=torch.int32, device=dev)
    step = max(1, _CHUNK_ELEMS // max(n, 1))
    for s in range(0, nq, step):
        qc, uc = qxyz[s:s + step], quse[s:s + step]
        hit = (uc[:, None] & puse[None, :]
               & (_d2_sum(qc[:, None, :], pxyz[None, :, :]) <= r2))
        counts[s:s + step] = hit.sum(dim=1).to(torch.int32)
    return counts


def radius_within_mask(pxyz, pvalid, query, radius):
    """bool[N] mask of the valid, finite points within ``radius``
    (inclusive) of one query f32[3]: one pass of direct f32 differences
    over the whole cloud, d2 in the pinned form, r2 as `_radius_sq`
    forms it (an f32 radius is squared in f32)."""
    puse = pvalid & torch.isfinite(pxyz).all(dim=-1)
    d2 = _d2_sum(pxyz, query.to(pxyz.dtype)[None, :])
    return puse & (d2 <= _radius_sq(radius, pxyz.device))


# ── Grid backend ─────────────────────────────────────────────────────────────


def _grid_chunks(nq: int, m_per_cell: int):
    """Query slices of at most `_CHUNK_ELEMS` candidate slots."""
    step = max(1, _CHUNK_ELEMS // (27 * m_per_cell))
    return [slice(s, s + step) for s in range(0, nq, step)]


def grid_knn(grid: GridHash, qxyz, qvalid, k: int, m_per_cell: int):
    """kNN over each query's 27-cell neighbourhood, at most ``m_per_cell``
    points a cell.

    Returns (dists f32[Q, k], idx i32[Q, k], nvalid bool[Q, k], overflow,
    insufficient), the flags 0-d bools; the results are exact iff neither
    is set. ``overflow``: some cell of a used query held more than M
    points. ``insufficient``: some used query's kth d2 exceeds the square
    of the cell less an f32 margin (floor(p / cell) rounds, more so far
    from the origin), or it found fewer than min(k, valid points)
    candidates. Ties go to the smaller candidate slot, as `lax.top_k`
    orders them."""
    dev = qxyz.device
    nq = qxyz.shape[0]
    q_use = _query_use(qxyz, qvalid)
    cell = grid.cell_size
    quot = torch.where(q_use[:, None], (qxyz / cell).abs(), 0.0)
    max_quot = quot.amax() if nq else torch.zeros((), device=dev)
    # The JAX package's (max_quot * 4 * 1.2e-7 + 1e-6) * cell, in the form
    # XLA's CPU backend gives it (measured bitwise).
    margin = fma_f32(max_quot * 4.0, torch.tensor(np.float32(1.2e-7),
                                                  device=dev),
                     torch.tensor(np.float32(1e-6), device=dev)) * cell
    safe_cell = torch.clamp(cell - margin, min=0.0)
    safe_cell2 = safe_cell * safe_cell
    want = torch.clamp(grid.num_valid, max=k)
    k_eff = min(k, 27 * m_per_cell)
    d2s = torch.full((nq, k), torch.inf, dtype=torch.float32, device=dev)
    idx = torch.zeros((nq, k), dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    insufficient = torch.zeros((), dtype=torch.bool, device=dev)
    for s in _grid_chunks(nq, m_per_cell):
        uc = q_use[s]
        cand_idx, d2, cand_valid, ov = gather_candidates(grid, qxyz[s], uc,
                                                         m_per_cell)
        vals, pos = _topk_lex(d2, k_eff)
        d2s[s, :k_eff] = vals
        idx[s, :k_eff] = torch.gather(cand_idx, 1, pos)
        found = cand_valid.sum(dim=1)
        bad = torch.where(found >= k, d2s[s, k - 1] > safe_cell2,
                          found < want)
        overflow |= ov
        insufficient |= (uc & bad).any()
    nvalid = torch.isfinite(d2s)
    dists = torch.where(nvalid, _sqrt_f32(torch.clamp(d2s, min=0.0)),
                        torch.inf)
    return dists, idx, nvalid, overflow, insufficient


def grid_radius_count(grid: GridHash, qxyz, qvalid, radius, m_per_cell: int):
    """(counts i32[Q] of the points with d2 <= r2, overflow): exact iff
    radius <= the grid's cell and not overflow."""
    dev = qxyz.device
    nq = qxyz.shape[0]
    q_use = _query_use(qxyz, qvalid)
    r2 = _radius_sq(radius, dev)
    counts = torch.zeros(nq, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for s in _grid_chunks(nq, m_per_cell):
        _, d2, _, ov = gather_candidates(grid, qxyz[s], q_use[s], m_per_cell)
        counts[s] = (d2 <= r2).sum(dim=1).to(torch.int32)
        overflow |= ov
    return counts, overflow


def grid_radius_neighbors(grid: GridHash, qxyz, qvalid, radius,
                          m_per_cell: int):
    """Capped neighbour lists within ``radius`` (inclusive), for the
    clustering rung: (idx i32[Q, 27M] original rows, within bool[Q, 27M]
    marking the entries at d2 <= r2, overflow). Exact iff radius <= the
    grid's cell and not overflow. The outputs are written in place, chunk
    by chunk: at 2^24 queries and M 16 they take 36 GB."""
    dev = qxyz.device
    nq = qxyz.shape[0]
    q_use = _query_use(qxyz, qvalid)
    r2 = _radius_sq(radius, dev)
    slots = 27 * m_per_cell
    idx = torch.empty((nq, slots), dtype=torch.int32, device=dev)
    within = torch.empty((nq, slots), dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for s in _grid_chunks(nq, m_per_cell):
        cand_idx, d2, _, ov = gather_candidates(grid, qxyz[s], q_use[s],
                                                m_per_cell)
        idx[s] = cand_idx
        within[s] = d2 <= r2
        overflow |= ov
    return idx, within, overflow
