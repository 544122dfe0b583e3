"""Build-once / query-many host index for single-point spatial queries:
the counterpart of `pointclouds_tpu/spatial/hostindex.py`. Where the host
C++ builds (`native/`, a compiler found) its index (`native/pcindex.cpp`)
takes over the build and the queries: the same grid, the same exact f64
semantics and tie order, without the interpreter's per-query overhead. The
numpy path below defines the contract, serves where there is no compiler,
and is what the tests hold the C++ against.

The reference amortizes its KD-tree build across queries (ref:
crates/spatial/src/kdtree.rs:25-44). A single-point query does not need the
card: the cloud is indexed once on the host (an O(N log N) numpy build,
cached on the PointCloud), and each query is a few binary searches plus an
exact distance pass over the 27+-cell candidate set. Batched queries
(whole-cloud kNN, SOR, clustering) go through the device sweeps; this
index serves `radius_search`, `knn_indices` and small-batch `knn`.

Exactness: candidate coverage uses an f64 host grid (ring = ceil(r/cell)
cells reaches every point within r by construction); distances are checked
exactly in f64, so results match brute force on index sets.
"""

from __future__ import annotations

import numpy as np

# Target points per cell for the build (queries scan 27+ cells); the same
# constant as `native/pcindex.cpp`'s, so both build the same grid.
_TARGET_PER_CELL = 2.0


class HostCellIndex:
    """Sorted-by-cell host arrays + binary-searchable cell runs."""

    def __init__(self, xyz: np.ndarray, valid: np.ndarray):
        from .. import native

        xyz = np.asarray(xyz, np.float32)
        self._native = native.create_index(xyz, np.asarray(valid, bool))
        if self._native is not None:
            self.n = xyz.shape[0]
            self.n_valid = self._native.nvalid()
            self.empty = self.n_valid == 0
            if not self.empty:
                # The C entry points themselves, bound on the instance: no
                # Python frame between the caller and the index.
                self.radius = self._native.radius
                self.knn = self._native.knn
            return
        finite = np.isfinite(xyz).all(axis=1)
        use = np.asarray(valid, bool) & finite
        self.n = xyz.shape[0]
        self.n_valid = int(use.sum())
        if self.n_valid == 0:
            self.empty = True
            return
        self.empty = False

        pts = xyz[use].astype(np.float64)
        self.rows = np.nonzero(use)[0].astype(np.int64)  # original rows
        mn = pts.min(axis=0)
        mx = pts.max(axis=0)
        span = np.maximum(mx - mn, 1e-12)
        vol = float(span.prod())
        # Blended 3D / planar / linear density: the unblended 3D formula
        # explodes the cell count on degenerate clouds (a flat plane gives
        # vol ~ 1e-12 -> billions of cells -> seconds per query).
        sspan = np.sort(span)
        nv = float(max(self.n_valid, 1))
        c3 = (vol * _TARGET_PER_CELL / nv) ** (1.0 / 3.0)
        c2 = float(np.sqrt(sspan[1] * sspan[2] * _TARGET_PER_CELL / nv))
        c1 = float(sspan[2] * _TARGET_PER_CELL / nv)
        cell = max(c3, max(c2, c1))
        # Clamp: between the finest axis resolution and the whole span.
        self.cell = float(min(max(cell, 1e-9), span.max()))
        self.mn = mn

        c = np.floor((pts - mn) / self.cell).astype(np.int64)
        self.extent = c.max(axis=0) + 1
        ey, ez = int(self.extent[1]), int(self.extent[2])
        lin = (c[:, 0] * ey + c[:, 1]) * ez + c[:, 2]
        order = np.argsort(lin, kind="stable")
        self.slin = lin[order]
        self.spts = pts[order]
        self.srows = self.rows[order]
        self.ey, self.ez = ey, ez

    # ── queries ──

    def _candidate_slices(self, q: np.ndarray, reach_cells: int):
        """Row ranges of the sorted arrays covering every cell within
        ``reach_cells`` of the query's cell (z-runs are contiguous)."""
        cq = np.floor((q - self.mn) / self.cell).astype(np.int64)
        r = reach_cells
        ex = int(self.extent[0])
        # Clip to the grid: out-of-range coordinates must be DROPPED, not
        # linearized (a negative x would alias another cell's id).
        xs = np.arange(max(cq[0] - r, 0), min(cq[0] + r, ex - 1) + 1)
        ys = np.arange(max(cq[1] - r, 0), min(cq[1] + r, self.ey - 1) + 1)
        zlo = max(cq[2] - r, 0)
        zhi = min(cq[2] + r, self.ez - 1)
        if xs.size == 0 or ys.size == 0 or zhi < zlo:
            return np.empty((0,), np.int64), np.empty((0,), np.int64)
        base = (xs[:, None] * self.ey + ys[None, :]) * self.ez  # [X, Y]
        lo = (base + zlo).ravel()
        hi = (base + zhi + 1).ravel()
        starts = np.searchsorted(self.slin, lo, side="left")
        ends = np.searchsorted(self.slin, hi, side="left")
        return starts, ends

    def _gather(self, starts, ends):
        sel = [np.arange(s, e) for s, e in zip(starts, ends) if e > s]
        if not sel:
            return np.empty((0,), np.int64)
        return np.concatenate(sel)

    def radius(self, q, radius: float) -> np.ndarray:
        """Original-order row indices within ``radius`` (inclusive) of
        ``q``, ascending. Exact (f64 distance check)."""
        if self.empty:
            return np.empty((0,), np.int64)
        q = np.asarray(q, np.float64).reshape(3)
        reach = int(np.ceil(radius / self.cell)) + 1
        idx = self._gather(*self._candidate_slices(q, reach))
        if idx.size == 0:
            return np.empty((0,), np.int64)
        d2 = ((self.spts[idx] - q) ** 2).sum(axis=1)
        hit = idx[d2 <= float(radius) * float(radius)]
        return np.sort(self.srows[hit])

    def knn(self, q, k: int):
        """(rows, dists) of the k nearest (ascending), expanding the cell
        ring until the kth distance is provably covered."""
        if self.empty or k <= 0:
            return np.empty((0,), np.int64), np.empty((0,), np.float64)
        q = np.asarray(q, np.float64).reshape(3)
        reach = 1
        # A reach that covers the whole grid from the query's cell (the
        # query may lie far outside the grid bounds): past it every valid
        # point is a candidate, so the loop ends there at the latest.
        cq = np.floor((q - self.mn) / self.cell).astype(np.int64)
        max_reach = int(
            np.max(np.maximum(np.abs(cq), np.abs(self.extent - 1 - cq)))
        ) + 1
        while True:
            idx = self._gather(*self._candidate_slices(q, reach))
            if idx.size >= min(k, self.n_valid):
                d2 = ((self.spts[idx] - q) ** 2).sum(axis=1)
                o = np.argsort(d2, kind="stable")
                kk = min(k, idx.size)
                kth = np.sqrt(d2[o[kk - 1]])
                # Every cell within `reach` is covered, so any point
                # closer than (reach - 1) * cell from the query is
                # guaranteed among the candidates (the query sits
                # somewhere inside its own cell).
                covered = (reach - 1) * self.cell
                if kth <= covered or reach > max_reach:
                    sel = idx[o[:kk]]
                    return self.srows[sel], np.sqrt(d2[o[:kk]])
            reach *= 2
