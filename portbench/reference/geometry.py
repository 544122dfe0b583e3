"""Plain PyTorch geometry for the reference: voxel centroids, exact k
nearest neighbours, radius pairs, connected components and the RANSAC
tournament. It imports nothing of the program.

Every function computes in the dtype of the points it is given: float64
for the reference, bfloat16 for its lower-precision control. Neighbour
searches bucket the points into a grid and compare each cell's points with
the points of the cells around it, cells of like size together, so the work
grows with the points and not with their square; a query whose k-th
neighbour could lie beyond the cells searched is taken again against every
point. The grid itself is built in float64 whatever the dtype, so that only
the arithmetic, not the search, changes with the precision.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .threefry import mod_u64, random_bits64

BIAS = 1 << 20
# Pair elements a chunk of the neighbour searches holds at once.
CHUNK_ELEMS = 1 << 25


def pack_keys(cells: torch.Tensor) -> torch.Tensor:
    """int64 [N, 3] cell coordinates -> one int64 key whose order is the
    lexicographic (ix, iy, iz) order."""
    c = cells + BIAS
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def voxel_keys(xyz: torch.Tensor, voxel: float, dtype) -> torch.Tensor:
    """Voxel keys of ``xyz``: the cell floor(p / voxel), divided in float32,
    the configuration's rule, or in ``dtype`` where that is narrower."""
    kd = torch.float32 if dtype in (torch.float64, torch.float32) else dtype
    v = torch.tensor(voxel, dtype=kd, device=xyz.device)
    return pack_keys(torch.floor(xyz.to(kd) / v).to(torch.int64))


def voxel_centroids(xyz32: torch.Tensor, voxel: float, dtype):
    """One centroid per occupied voxel of the float32 points ``xyz32``:
    (keys int64[V] ascending, centroids [V, 3] in ``dtype``)."""
    keys = voxel_keys(xyz32, voxel, dtype)
    ukeys, inverse = torch.unique(keys, return_inverse=True)
    sums = torch.zeros((ukeys.numel(), 3), dtype=dtype, device=xyz32.device)
    sums.index_add_(0, inverse, xyz32.to(dtype))
    counts = torch.zeros(ukeys.numel(), dtype=dtype, device=xyz32.device)
    counts.index_add_(0, inverse, torch.ones_like(keys, dtype=dtype))
    return ukeys, sums / counts[:, None]


class Grid:
    """Points bucketed into cubic cells of ``cell`` (float64 geometry),
    with each occupied cell's sorted range and its neighbour cells within
    ``ring`` cells."""

    def __init__(self, pts: torch.Tensor, cell: float, ring: int):
        p64 = pts.to(torch.float64)
        self.cell, self.ring = float(cell), ring
        self.lo = p64.amin(0) - ring * self.cell
        c = torch.floor((p64 - self.lo) / self.cell).to(torch.int64)
        dims = c.amax(0) + 1 + ring
        key = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
        self.order = torch.argsort(key, stable=True)
        skey = key[self.order]
        self.ukey, self.counts = torch.unique_consecutive(
            skey, return_counts=True)
        self.starts = torch.cumsum(self.counts, 0) - self.counts
        self.ucell = c[self.order][self.starts]
        offs = torch.tensor(list(itertools.product(range(-ring, ring + 1),
                                                   repeat=3)),
                            dtype=torch.int64, device=pts.device)
        nkey = (self.ukey[:, None] + (offs[:, 0] * dims[1] + offs[:, 1])
                * dims[2] + offs[:, 2])
        pos = torch.searchsorted(self.ukey, nkey).clamp(
            max=self.ukey.numel() - 1)
        found = self.ukey[pos] == nkey
        self.nstart = torch.where(found, self.starts[pos], 0)
        self.ncount = torch.where(found, self.counts[pos], 0)
        self.ncand = self.ncount.sum(1)

    def margin(self, q64: torch.Tensor, cell_idx: torch.Tensor):
        """Distance from each query to the faces of the block of cells its
        candidates came from: every point nearer than this was a
        candidate."""
        lo = self.lo + (self.ucell[cell_idx] - self.ring) * self.cell
        hi = lo + (2 * self.ring + 1) * self.cell
        return torch.minimum(q64 - lo, hi - q64).amin(-1)

    def chunks(self, width_of_query: int):
        """Occupied cells, most candidates first, in chunks of at most
        `CHUNK_ELEMS` query-candidate pairs (times ``width_of_query``):
        (cell ids, query slots, candidate slots)."""
        by = torch.argsort(self.ncand, descending=True)
        ncand = self.ncand[by].tolist()
        counts = self.counts[by].tolist()
        a, n = 0, len(ncand)
        while a < n:
            mq, mc = counts[a], ncand[a]
            b = a + 1
            while (b < n and (b + 1 - a) * max(mq, counts[b]) * mc
                   * width_of_query <= CHUNK_ELEMS):
                mq = max(mq, counts[b])
                b += 1
            yield by[a:b], mq, mc
            a = b

    def slots(self, cells: torch.Tensor, mq: int, mc: int):
        """Sorted positions of the queries [B, mq] and candidates [B, mc]
        of ``cells``, with their validity masks."""
        dev = cells.device
        qpos = self.starts[cells, None] + torch.arange(mq, device=dev)
        qok = torch.arange(mq, device=dev) < self.counts[cells, None]
        ncount = self.ncount[cells]
        ends = torch.cumsum(ncount, 1)
        j = torch.arange(mc, device=dev).expand(cells.numel(), mc)
        o = torch.searchsorted(ends, j.contiguous(), right=True)
        o = o.clamp(max=ncount.shape[1] - 1)
        begin = torch.gather(ends - ncount, 1, o)
        cpos = torch.gather(self.nstart[cells], 1, o) + (j - begin)
        cok = j < ends[:, -1:]
        return (torch.where(qok, qpos, 0), qok, torch.where(cok, cpos, 0),
                cok)


def _d2(q, c):
    """Squared distances [.., Q, C] between rows of q [.., Q, 3] and c
    [.., C, 3], by differences, in their dtype."""
    d = q[..., :, None, :] - c[..., None, :, :]
    return (d * d).sum(-1)


def knn(pts: torch.Tensor, k: int, cell: float, ring: int = 1):
    """The ``k`` nearest points of every row of ``pts`` [N, 3] (the row
    itself among them), exact: (d2 [N, k] ascending, idx int64[N, k]).
    Rows with fewer than k points get +inf and -1 in the missing places."""
    n, dev = pts.shape[0], pts.device
    g = Grid(pts, cell, ring)
    sp = pts[g.order]
    out_d = torch.full((n, k), torch.inf, dtype=pts.dtype, device=dev)
    out_i = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    redo = torch.zeros(n, dtype=torch.bool, device=dev)
    for cells, mq, mc in g.chunks(3):
        qpos, qok, cpos, cok = g.slots(cells, mq, mc)
        d2 = _d2(sp[qpos], sp[cpos])
        cand_row = g.order[cpos]
        d2 = torch.where(cok[:, None, :], d2, torch.inf)
        kk = min(k, mc)
        vals, sel = torch.topk(d2, kk, dim=2, largest=False, sorted=True)
        idx = torch.gather(cand_row[:, None, :].expand(-1, mq, -1), 2, sel)
        idx = torch.where(torch.isfinite(vals), idx, -1)
        q_rows = g.order[qpos][qok]
        kth = vals[..., -1].to(torch.float64)
        marg = g.margin(sp[qpos].to(torch.float64), cells[:, None])
        sure = (kk == k) & (kth < marg * marg)
        vals_k = torch.full((*vals.shape[:2], k), torch.inf,
                            dtype=pts.dtype, device=dev)
        idx_k = torch.full((*vals.shape[:2], k), -1, dtype=torch.int64,
                           device=dev)
        vals_k[..., :kk], idx_k[..., :kk] = vals, idx
        out_d[q_rows], out_i[q_rows] = vals_k[qok], idx_k[qok]
        redo[q_rows] = ~sure[qok]
    rows = redo.nonzero().flatten()
    step = max(1, CHUNK_ELEMS // (3 * n))
    for s in range(0, rows.numel(), step):
        r = rows[s:s + step]
        d2 = _d2(pts[r], pts)
        kk = min(k, n)
        vals, idx = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
        out_d[r, :kk], out_i[r, :kk] = vals, idx
    return out_d, out_i


def radius_pairs(pts: torch.Tensor, r2: float):
    """Every ordered pair (i, j), i != j, of rows of ``pts`` within squared
    distance ``r2`` (inclusive): (int64 [2, P], their d2 in float64)."""
    dev = pts.device
    cell = float(np.sqrt(r2)) * (1.0 + 1e-9)
    g = Grid(pts, cell, 1)
    sp = pts[g.order]
    rr = torch.tensor(r2, dtype=torch.float64, device=dev)
    found, dist = [], []
    for cells, mq, mc in g.chunks(3):
        qpos, qok, cpos, cok = g.slots(cells, mq, mc)
        d2 = _d2(sp[qpos], sp[cpos]).to(torch.float64)
        within = (d2 <= rr) & qok[:, :, None] & cok[:, None, :]
        b, qi, ci = within.nonzero(as_tuple=True)
        i = g.order[qpos[b, qi]]
        j = g.order[cpos[b, ci]]
        keep = i != j
        found.append(torch.stack([i[keep], j[keep]]))
        dist.append(d2[b, qi, ci][keep])
    if not found:
        return (torch.zeros((2, 0), dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.float64, device=dev))
    return torch.cat(found, 1), torch.cat(dist)


def components(n: int, pairs: torch.Tensor) -> torch.Tensor:
    """Connected components of n rows under ``pairs`` (both directions
    listed): each row labelled with the smallest row of its component."""
    lab = torch.arange(n, dtype=torch.int64, device=pairs.device)
    while True:
        m = lab.scatter_reduce(0, pairs[0], lab[pairs[1]], reduce="amin")
        m = torch.minimum(m, m[m])
        m = torch.minimum(m, m[m])
        if torch.equal(m, lab):
            return lab
        lab = m


def extra_parts(a: torch.Tensor, b: torch.Tensor) -> int:
    """How many more parts the labelling ``b`` cuts the parts of ``a``
    into: 0 iff every part of ``a`` lies within one part of ``b``."""
    if a.numel() == 0:
        return 0
    a = torch.unique(a, return_inverse=True)[1]
    b = torch.unique(b, return_inverse=True)[1]
    pairs = torch.unique(a * (int(b.max()) + 1) + b).numel()
    return pairs - int(a.max()) - 1


def partition_gap(labels: torch.Tensor, pts: torch.Tensor, r2: float,
                  rel: float) -> int:
    """Splits and merges of the partition ``labels`` of ``pts`` against the
    components within squared distance ``r2``: a component of the pairs
    nearer than ``r2 * (1 - rel)`` that ``labels`` splits, or two components
    of the pairs within ``r2 * (1 + rel)`` that it merges, count; pairs
    within ``rel`` of the radius may go either way."""
    n = pts.shape[0]
    pairs, d2 = radius_pairs(pts, r2 * (1.0 + rel))
    sure = components(n, pairs[:, d2 <= r2 * (1.0 - rel)])
    maybe = components(n, pairs)
    return extra_parts(sure, labels) + extra_parts(labels, maybe)


def sample_three_distinct(seed: int, iterations: int, cnt: int, device):
    """[iterations, 3] distinct positions in [0, cnt) from the Threefry
    stream of ``seed``: one draw, then shrinking-range modulo and shifts past
    the values already chosen (the program's hypothesis stream)."""
    cnt = torch.tensor(max(cnt, 3), dtype=torch.int64, device=device)
    hi, lo = random_bits64(seed, (3, iterations), device=device)
    a = mod_u64(hi[0], lo[0], cnt)
    b = mod_u64(hi[1], lo[1], cnt - 1)
    b = b + (b >= a)
    lo_ab, hi_ab = torch.minimum(a, b), torch.maximum(a, b)
    c = mod_u64(hi[2], lo[2], cnt - 2)
    c = c + (c >= lo_ab)
    c = c + (c >= hi_ab)
    return torch.stack([a, b, c], dim=1)


def plane_distances(pts: torch.Tensor, normal: torch.Tensor, d):
    """|p . n + d| of every row of ``pts`` for every plane (columns of
    ``normal`` [3, H], ``d`` [H]), as one matrix product."""
    return torch.abs(pts @ normal + d)


def ransac_tournament(pts: torch.Tensor, seed: int, iterations: int,
                      threshold: float, subsample: int, rescore_top: int = 8):
    """The RANSAC plane of ``pts`` [cnt, 3] (rows in sample-position
    order): every hypothesis of the seed's stream scored on an evenly spaced
    subsample, the ``rescore_top`` best (ties to the earlier) rescored on
    every point, the best of those kept (ties to the earlier). Returns
    (normal [3], d) in the points' dtype; (0, 0, 1), 0 when fewer than three
    points or no inlier."""
    dev, dt = pts.device, pts.dtype
    cnt = pts.shape[0]
    up = torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev)
    if cnt < 3:
        return up, torch.zeros((), dtype=dt, device=dev)
    s = sample_three_distinct(seed, iterations, cnt, dev)
    p = pts[s]
    nrm = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    length = torch.sqrt((nrm * nrm).sum(1))
    degenerate = length < 1e-10
    normal = nrm / torch.where(degenerate, 1.0, length)[:, None]
    d = -(normal * p[:, 0]).sum(1)
    thr = torch.tensor(threshold, dtype=dt, device=dev)

    ar = torch.arange(subsample, dtype=torch.int64, device=dev)
    pos = ar * (cnt // subsample) + (ar * (cnt % subsample)) // subsample
    distinct = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          pos[1:] != pos[:-1]])
    within = plane_distances(pts[pos], normal.T, d) <= thr
    sub = (within & distinct[:, None]).sum(0)
    sub = torch.where(degenerate, -1, sub)
    ii = torch.arange(iterations, dtype=torch.int64, device=dev)
    top = torch.topk(sub * iterations + (iterations - 1 - ii),
                     rescore_top).indices
    full = (plane_distances(pts, normal[top].T, d[top]) <= thr).sum(0)
    full = torch.where(degenerate[top], -1, full)
    best_count = int(full.max())
    if best_count <= 0:
        return up, torch.zeros((), dtype=dt, device=dev)
    best = int(top[full == best_count].min())
    return normal[best], d[best]


def smallest_eigvec(cov: torch.Tensor):
    """Unit eigenvector of the smallest eigenvalue of symmetric [N, 3, 3]
    matrices, and the ratio of the middle eigenvalue to it. The solve runs
    on the host (LAPACK): the card's batched solver refuses batches of this
    size."""
    lam, vec = torch.linalg.eigh(cov.cpu())
    ratio = lam[:, 1] / torch.clamp(lam[:, 0], min=1e-30)
    return vec[:, :, 0].to(cov.device), ratio.to(cov.device)
