"""RANSAC ground-plane fit: the counterpart of
`pointclouds_tpu/ops/segmentation.py::ransac_plane_masked` and
`_ransac_sequential_scan`.

Hypotheses come from the threefry port, so the same seed draws the same
three points per iteration as the JAX package. Three scorings, as there:
the tournament (every hypothesis on an evenly spaced subsample, the top
``rescore_top`` rescored over the full cloud), full scoring of every
hypothesis (kernel `ransac_score_counts` up to 4096 iterations), and the
reference's sequential loop with adaptive early termination, which
``adaptive=True`` selects below 10,000 valid points or 16 iterations.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..core.cloud import compaction_order
from ..spatial.kernels import _sqrt_f32, fma_f32, ransac_score_counts
from ..utils import profiling
from ..utils.threefry import mod_u64, random_bits64
from .registration import _to_planar

# ln(1 - 0.999), the reference's adaptive-termination constant.
_LN_OUTLIER = math.log(0.001)
# Reference dispatch: the sequential adaptive path runs unless n >= 10_000
# AND iterations >= 16.
_PARALLEL_MIN_POINTS = 10_000
_PARALLEL_MIN_ITERS = 16
# Full scoring goes through the counts kernel up to this many hypotheses
# (as the JAX package's kernel path), through a matmul above it.
_KERNEL_MAX_ITERS = 4096
# Matmul scoring works on at most this many point-hypothesis pairs at once.
_SCORE_CHUNK_ELEMS = 1 << 26


def _dot3(a, b):
    """Row dot products of [..., 3] f32 tensors in the form XLA's CPU
    backend gives the JAX package's ``jnp.sum(a * b, axis=1)``:
    fma(a2, b2, fma(a1, b1, a0 * b0)). Its ``jnp.cross`` is likewise
    fma(a_j, b_k, -(a_k * b_j)) per component (both measured bitwise), so
    the hypotheses' normals and offsets are the JAX package's bits."""
    return fma_f32(a[..., 2], b[..., 2],
                   fma_f32(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _sample_three_distinct(seed: int, iterations: int, cnt):
    """[iterations, 3] distinct positions in [0, cnt): one threefry draw,
    then shrinking-range modulo and shifts past the chosen values."""
    cnt = torch.clamp(torch.as_tensor(cnt).to(torch.int64), min=3)
    hi, lo = random_bits64(seed, (3, iterations), device=cnt.device)
    a = mod_u64(hi[0], lo[0], cnt)
    b = mod_u64(hi[1], lo[1], cnt - 1)
    b = b + (b >= a)
    lo_ab = torch.minimum(a, b)
    hi_ab = torch.maximum(a, b)
    c = mod_u64(hi[2], lo[2], cnt - 2)
    c = c + (c >= lo_ab)
    c = c + (c >= hi_ab)
    return torch.stack([a, b, c], dim=1)


@contextlib.contextmanager
def _full_fp32_matmul():
    """TF32 off for the enclosed matmuls (TF32 keeps ~3 digits:
    centimetres at 10 m), the caller's setting restored afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _inlier_counts(xyz, use_pt, normal, d, threshold):
    """Inliers of each hypothesis (rows of ``normal``/``d``) by a plain f32
    matrix product, the JAX package's `Precision.HIGHEST` dot, over chunks
    of hypotheses. Returns int64[H]."""
    step = max(1, _SCORE_CHUNK_ELEMS // max(xyz.shape[0], 1))
    parts = []
    with _full_fp32_matmul():
        for s in range(0, normal.shape[0], step):
            dist = torch.abs(xyz @ normal[s:s + step].T + d[None, s:s + step])
            parts.append((use_pt[:, None] & (dist <= threshold)).sum(dim=0))
    return torch.cat(parts)


def _score_all(xyz, use_pt, normal, d, threshold, iterations: int):
    """Full-cloud inlier counts of every hypothesis, int64[iterations]."""
    if iterations > _KERNEL_MAX_ITERS:
        return _inlier_counts(xyz, use_pt, normal, d, threshold)
    dev = xyz.device
    nh = -(-iterations // 128) * 128
    hyp = torch.zeros((5, nh), dtype=torch.float32, device=dev)
    hyp[:3, :iterations] = normal.T
    hyp[3, :iterations] = d
    hyp[4, :iterations] = threshold
    hyp[4, iterations:] = -1.0  # pad slots count 0
    counts = ransac_score_counts(hyp, _to_planar(xyz, use_pt))
    return counts[:iterations].to(torch.int64)


def _ransac_sequential_scan(xyz, use_pt, normal, d, degenerate, threshold,
                            cnt, iterations: int, chunk: int = 16):
    """The reference's sequential RANSAC with adaptive early termination,
    scored ``chunk`` hypotheses at a time.

    The reference walks hypotheses in order, keeps the first running
    maximum (strict ``>``), and at an improving iteration stops when
    ``iter > ln(0.001)/ln(1 - w^3)`` with ``w = best/n > 0.5``. Each chunk
    is scored in one matmul and that rule replayed inside it; ``w``,
    ``needed`` and the comparison run in float64, as in the JAX package.
    Returns (best_iter, best_count, n_evaluated) as Python ints."""
    c_len = max(1, min(chunk, iterations))
    nch = -(-iterations // c_len)
    with profiling.host_read("ransac.scan_count"):
        n64 = max(float(int(cnt)), 1.0)
    threshold = float(np.float32(threshold))
    bc, bi, ne = 0, 0, 0
    # Host loop: one read of each chunk's counts, and it stops at the
    # chunk that holds the breaking iteration.
    for ci in range(nch):
        base = ci * c_len
        sl = slice(base, base + c_len)
        c = _inlier_counts(xyz, use_pt, normal[sl], d[sl], threshold)
        with profiling.host_read("ransac.scan_chunk"):
            c = torch.where(degenerate[sl], -1, c).cpu().numpy()
        c = np.concatenate([c, np.full(c_len - len(c), -1, np.int64)])
        pre = np.maximum(bc, np.concatenate(
            [[-(2**31) + 1], np.maximum.accumulate(c)[:-1]]))
        improved = c > pre
        w = c.astype(np.float64) / n64
        with np.errstate(divide="ignore"):
            denom = np.log(np.clip(1.0 - (w * w) * w, 1e-300, None))
        needed = _LN_OUTLIER / denom
        g = (base + np.arange(c_len)).astype(np.float64)
        brk = np.nonzero(improved & (w > 0.5) & (g > needed))[0]
        fb = int(brk[0]) if len(brk) else c_len
        cm = c[: fb + 1]  # the breaking iteration itself is evaluated
        cmax = int(cm.max())
        if cmax > bc:
            bc, bi = cmax, base + int(np.argmax(cm))
        ne += min(fb + 1, c_len, iterations - base)
        if fb < c_len:
            break
    return bi, bc, ne


def ransac_plane_masked(xyz, valid, threshold, seed, iterations: int, *,
                        assume_compact: bool = False,
                        score_subsample: int | None = None,
                        rescore_top: int = 8, adaptive: bool = False,
                        position_rows=None):
    """Batched RANSAC plane fit on a masked cloud.

    Returns (normal f32[3], d f32, inlier_mask bool[N]); fewer than 3 valid
    points give normal (0, 0, 1), d = 0 and no inliers. ``position_rows``
    maps sample position p to the row holding the p-th valid point;
    ``assume_compact`` asserts the valid rows are the leading ones (default:
    the stable compaction order). ``score_subsample=m`` selects the
    tournament; ``adaptive=True`` the reference's dispatch between full
    scoring and the sequential scan (ignored under the tournament).
    ``threshold`` is taken as float32."""
    threshold = float(np.float32(threshold))
    dev = xyz.device
    with profiling.span("ransac.hypotheses"):
        cnt = valid.sum()
        samples = _sample_three_distinct(seed, iterations, cnt)
        if position_rows is not None:
            order = position_rows.long()
        elif assume_compact:
            order = None  # position p is row p
        else:
            order = compaction_order(valid)
        flat = samples.reshape(-1)
        idx = flat if order is None else order[flat]
        p = xyz[idx].reshape(iterations, 3, 3)

        v1 = p[:, 1] - p[:, 0]
        v2 = p[:, 2] - p[:, 0]
        nrm = torch.stack([fma_f32(v1[:, j], v2[:, k], -(v1[:, k] * v2[:, j]))
                           for j, k in ((1, 2), (2, 0), (0, 1))], dim=1)
        length = _sqrt_f32(_dot3(nrm, nrm))
        degenerate = length < 1e-10
        safe_len = torch.where(degenerate, 1.0, length)
        normal = nrm / safe_len[:, None]
        d = -_dot3(normal, p[:, 0])

    use_pt = valid & torch.isfinite(xyz).all(dim=-1)
    if score_subsample is not None and iterations > rescore_top:
        with profiling.span("ransac.score"):
            m = score_subsample
            ar = torch.arange(m, dtype=torch.int64, device=dev)
            pos = ar * (cnt // m) + (ar * (cnt % m)) // m
            distinct = torch.cat([torch.ones(1, dtype=torch.bool,
                                             device=dev),
                                  pos[1:] != pos[:-1]])
            sub_rows = pos if order is None else order[pos]
            sub_use = use_pt[sub_rows] & distinct
            sub_counts = _inlier_counts(xyz[sub_rows], sub_use, normal, d,
                                        threshold)
            sub_counts = torch.where(degenerate, -1, sub_counts)
            # Leaders, ties toward the EARLIER hypothesis (first-max
            # reduce).
            ii = torch.arange(iterations, dtype=torch.int64, device=dev)
            top_idx = torch.topk(
                sub_counts * iterations + (iterations - 1 - ii),
                rescore_top).indices
            full_counts = _inlier_counts(xyz, use_pt, normal[top_idx],
                                         d[top_idx], threshold)
            full_counts = torch.where(degenerate[top_idx], -1, full_counts)
            best_count = full_counts.max()
            best = torch.where(full_counts == best_count, top_idx,
                               iterations).min()
    else:
        # The reference's dispatch: a host read of the valid count.
        sequential = adaptive and iterations >= 2
        if sequential and iterations >= _PARALLEL_MIN_ITERS:
            with profiling.host_read("ransac.dispatch"):
                sequential = int(cnt) < _PARALLEL_MIN_POINTS
        if sequential:
            with profiling.span("ransac.scan"):
                bi, bcount, _ = _ransac_sequential_scan(
                    xyz, use_pt, normal, d, degenerate, threshold, cnt,
                    iterations)
                with profiling.host_read("ransac.scan_upload"):
                    best = torch.tensor(bi, device=dev)
                with profiling.host_read("ransac.scan_upload"):
                    best_count = torch.tensor(bcount, device=dev)
        else:
            with profiling.span("ransac.score"):
                counts = _score_all(xyz, use_pt, normal, d, threshold,
                                    iterations)
                counts = torch.where(degenerate, -1, counts)
                best = torch.argmax(counts)  # first maximum
                with profiling.host_read("ransac.best"):  # a 0-d index
                    best_count = counts[best]

    with profiling.span("ransac.inliers"):
        ok_model = (best_count > 0) & (cnt >= 3)
        best_c = torch.clamp(best, max=iterations - 1)
        # Indexing by a 0-d card tensor reads it to the host; so does the
        # upload of the fallback normal.
        with profiling.host_read("ransac.model"):
            best_normal = torch.where(
                ok_model, normal[best_c],
                torch.tensor([0.0, 0.0, 1.0], device=dev))
        with profiling.host_read("ransac.model"):
            best_d = torch.where(ok_model, d[best_c], 0.0)
        # The reference evaluates the final inlier test in float64 (its
        # model normal is promoted there); so does the port.
        x64, n64 = xyz.to(torch.float64), best_normal.to(torch.float64)
        dist = torch.abs(x64[:, 0] * n64[0] + x64[:, 1] * n64[1]
                         + x64[:, 2] * n64[2] + best_d.to(torch.float64))
        inlier_mask = valid & (dist <= threshold) & (cnt >= 3)
    return best_normal, best_d, inlier_mask


def ransac_plane_bytes(xyz, valid, threshold, seed, iterations: int, *,
                       assume_compact: bool = False,
                       score_subsample: int | None = None,
                       adaptive: bool = False):
    """`ransac_plane_masked` packed into one uint8[16 + N/8] tensor, for a
    single device-to-host copy: bytes [0:16] the little-endian f32 [nx, ny,
    nz, d], then the inlier mask bit-packed in little bit order
    (``np.unpackbits(..., bitorder="little")`` on the host)."""
    n = xyz.shape[0]
    if n % 8:
        raise ValueError(f"ransac_plane_bytes: capacity {n} not a multiple "
                         "of 8")
    normal, d, inlier_mask = ransac_plane_masked(
        xyz, valid, threshold, seed, iterations,
        assume_compact=assume_compact, score_subsample=score_subsample,
        adaptive=adaptive)
    scal = torch.cat([normal, d[None]]).to(torch.float32).view(torch.uint8)
    bits = inlier_mask.to(torch.uint8).reshape(-1, 8)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                           device=xyz.device)
    packed = (bits * weights).sum(dim=1, dtype=torch.uint8)
    return torch.cat([scal, packed])


# ── Euclidean clustering: the grid rung and the exact last resort ───────────

# Neighbour-list slots scanned at once when the within pairs are gathered.
_PAIR_CHUNK_ELEMS = 1 << 26


def propagate_labels(neighbor_idx, within, valid):
    """Connected components of capped neighbour lists (``neighbor_idx``
    i32[N, C] with ``within`` bool[N, C] marking the entries at distance <=
    r, as `engine.radius_neighbors` returns them): min-label rounds with
    two pointer jumps each, until a round changes nothing (a host read a
    round). Returns int32 labels equal to the JAX package's: each
    component carries its smallest row; isolated and invalid rows keep
    their own (validity is already in ``within``).

    The JAX package takes the minimum over the whole [N, C] gather each
    round. The minimum does not depend on the order of its terms, so here
    the within entries are gathered once, in chunks of rows, into (row,
    neighbour) pairs, and each round is one gather and one scatter-min over
    those pairs."""
    del valid
    n, c = neighbor_idx.shape
    dev = neighbor_idx.device
    rows, cols = [], []
    step = max(1, _PAIR_CHUNK_ELEMS // max(c, 1))
    for s in range(0, n, step):
        r, j = within[s:s + step].nonzero(as_tuple=True)  # host read
        rows.append(r + s)
        cols.append(neighbor_idx[s:s + step][r, j].to(torch.int64))
    rows = torch.cat(rows) if rows else torch.zeros(0, dtype=torch.int64,
                                                    device=dev)
    cols = torch.cat(cols) if cols else rows
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    while True:
        m = labels.scatter_reduce(0, rows, labels[cols], reduce="amin")
        m = torch.minimum(m, m[m.long()])
        m = torch.minimum(m, m[m.long()])
        if torch.equal(m, labels):  # host read: the round changed nothing
            return labels
        labels = m




def bruteforce_cluster_labels(xyz, valid, radius):
    """Exact connected-component labels by all-pairs min-label propagation,
    uncapped: each round gives every point the smallest label within
    ``radius`` (inclusive; ``radius`` taken as float32 and squared there),
    then two pointer jumps, until a round changes nothing (a host read per
    round). d2 has the JAX package's form for its ``jnp.sum(diff * diff,
    -1)``, fma(dz, dz, fma(dy, dy, dx*dx)). Invalid and non-finite points
    keep their own row as label. O(N^2) distances a round, in chunks."""
    from ..spatial.knn import _CHUNK_ELEMS, _d2_sum

    n = xyz.shape[0]
    dev = xyz.device
    use = valid & torch.isfinite(xyz).all(dim=-1)
    r = torch.as_tensor(np.float32(radius), device=dev)
    r2 = r * r
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    step = max(1, _CHUNK_ELEMS // max(n, 1))
    while True:
        mins = []
        for s in range(0, n, step):
            within = (use[s:s + step, None] & use[None, :]
                      & (_d2_sum(xyz[s:s + step, None, :], xyz[None]) <= r2))
            mins.append(torch.where(within, labels[None, :], n).amin(dim=1))
        m = torch.minimum(labels, torch.cat(mins).to(torch.int32))
        m = torch.minimum(m, m[m.long()])
        m = torch.minimum(m, m[m.long()])
        if torch.equal(m, labels):  # host read: the round changed nothing
            return labels
        labels = m
