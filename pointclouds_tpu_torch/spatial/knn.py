"""Brute-force kNN and radius counts: the counterpart of
`pointclouds_tpu/spatial/knn.py`'s `bruteforce_knn` and
`bruteforce_radius_count`.

These are XLA code in the JAX package (no Pallas kernel), so they stay
torch ops here. They serve small clouds (at most `engine.BRUTE_THRESHOLD`
points) and the engine's exact fallbacks. Distances are Euclidean,
ascending; an invalid or non-finite query gets no results.

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
from .kernels import _sqrt_f32, _topk_lex, fma_f32

# Query rows per chunk: at most this many query-point pairs at once.
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


def bruteforce_radius_count(pxyz, pvalid, qxyz, qvalid, radius):
    """Number of valid points with d2 <= r2 (inclusive) of each query,
    int32[Q]. As the JAX package's jitted function receives ``radius``:
    a Python float is a weakly typed float64 there, so r2 is its square in
    float64 rounded to f32; anything else is taken as f32 and squared in
    f32."""
    dev = pxyz.device
    puse = pvalid & torch.isfinite(pxyz).all(dim=-1)
    quse = _query_use(qxyz, qvalid)
    if type(radius) is float:
        r2 = torch.tensor(np.float32(radius * radius), device=dev)
    else:
        r = torch.as_tensor(radius, dtype=torch.float32, device=dev)
        r2 = r * r
    nq, n = qxyz.shape[0], pxyz.shape[0]
    counts = torch.zeros(nq, dtype=torch.int32, device=dev)
    step = max(1, _CHUNK_ELEMS // max(n, 1))
    for s in range(0, nq, step):
        qc, uc = qxyz[s:s + step], quse[s:s + step]
        hit = (uc[:, None] & puse[None, :]
               & (_d2_sum(qc[:, None, :], pxyz[None, :, :]) <= r2))
        counts[s:s + step] = hit.sum(dim=1).to(torch.int32)
    return counts
