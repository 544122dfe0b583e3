"""The port's hand-written CUDA kernels, each beside its plain torch version.

Counterparts of the Pallas kernels (`pointclouds_tpu/spatial/
pallas_kernels.py`) on the paths of the KITTI pipeline (every SOR
backend), the aerial pipeline and the per-op API (filters, normals, kNN,
clustering, ICP), and one kernel in place of XLA code (19, RANSAC's
plane hypotheses). Each wrapper
checks its inputs, runs
the plain version for CPU tensors, and for CUDA tensors
launches the kernel (built from ``csrc/`` at first use) or raises; it
never falls back. ``LAUNCHES`` counts kernel launches per wrapper, so a
run can show that its path really went through the kernels. The kernel
sources carry the design notes (what bounds each on Hopper and why).

Output contract of the selection kernels: the TPU kernels certify a
row through per-lane segment finalists; the port selects an exact top-k, so
its ``ok`` is always True. Wherever the TPU kernel reports ``ok`` the
port's total, count and kth equal it, and the port certifies a superset of
its rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling
from ..utils.threefry import mod_u64, prng_key, random_bits64

LAUNCHES = {
    "segmented_scan_sums": 0,
    "sweep_select_rows": 0,
    "rescue_select": 0,
    "cluster_multisweep": 0,
    "ransac_score_counts": 0,
    "sweep_moments": 0,
    "rescue_knn_idx": 0,
    "cluster_multisweep_windows": 0,
    "sweep_select": 0,
    "count_within": 0,
    "rescue_radius_count_groups": 0,
    "brute_knn_idx": 0,
    "brute_radius_count": 0,
    "sweep_knn_select": 0,
    "nn_argmin": 0,
    "cluster_propagate": 0,
    "sor_select": 0,
    "segmented_select": 0,
    "ransac_hypotheses": 0,
}

# Relative inclusion band of the moments' second walk
# (`pallas_kernels.D2_BAND`): ~7 ulp.
D2_BAND = 8e-7
# Plain versions work on at most this many d2 elements at a time.
_CHUNK_ELEMS = 1 << 24


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    from ._build import library

    return library()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(name: str, t: torch.Tensor, dtype, shape=None, device=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


# ── 1. Segmented scan (voxel centroids) ─────────────────────────────────────


def _segscan_br(nrows: int) -> int:
    """Tile height, as the TPU kernel derives it (its combine tree)."""
    return min(512, nrows)


def _segscan_layout(n: int):
    nrows = max(-(-n // 128), 1)
    br = _segscan_br(nrows)
    t = -(-nrows // br)
    return t, br * 128


def segmented_scan_sums_plain(first, x, y, z, c):
    """Plain torch replay of the TPU kernel's combine tree: per tile of
    ``br*128`` elements, Hillis-Steele steps over the flat index with
    shifts 1, 2, 4, ... < tile length, then the sequential tile carry."""
    n = first.shape[0]
    t, tl = _segscan_layout(n)
    pad = t * tl - n

    def tiles(a):
        return torch.nn.functional.pad(a, (0, pad)).reshape(t, tl)

    f, x, y, z, c = (tiles(a) for a in (first, x, y, z, c))
    zero = torch.zeros((t, tl), dtype=torch.float32, device=first.device)
    d = 1
    while d < tl:
        def sh(a, d=d):
            return torch.cat([zero[:, :d], a[:, :-d]], dim=1)

        start = f > 0.5
        x = torch.where(start, x, x + sh(x))
        y = torch.where(start, y, y + sh(y))
        z = torch.where(start, z, z + sh(z))
        c = torch.where(start, c, c + sh(c))
        f = torch.maximum(f, sh(f))
        d *= 2
    outs = [[], [], [], []]
    carry = [torch.zeros((), dtype=torch.float32, device=first.device)] * 4
    for i in range(t):
        start = f[i] > 0.5
        tile = [torch.where(start, a[i], a[i] + cv)
                for a, cv in zip((x, y, z, c), carry)]
        carry = [a[-1] for a in tile]
        for o, a in zip(outs, tile):
            o.append(a)
    return tuple(torch.cat(o)[:n] for o in outs)


def segmented_scan_sums(first, x, y, z, c):
    """Segmented inclusive scan of (x, y, z, count) over flat f32[N]
    arrays, segments starting where ``first`` = 1.0. Returns (sx, sy, sz,
    sc) f32[N], bitwise equal to the TPU kernel and its XLA mirror.

    Replaces `pallas_kernels.segmented_scan_sums` (csrc/segscan.cu)."""
    n = first.shape[0]
    for nm, a in zip("fxyzc", (first, x, y, z, c)):
        _check(f"segmented_scan_sums.{nm}", a, torch.float32, (n,),
               first.device)
    if not _on_cuda(first):
        return segmented_scan_sums_plain(first, x, y, z, c)
    t, tl = _segscan_layout(n)
    total = t * tl
    ins = [a if total == n else torch.nn.functional.pad(a, (0, total - n))
           for a in (first, x, y, z, c)]
    # One allocation: the four sums, then the kernel's 5-channel scratch
    # (held until the returned views are freed).
    out = torch.empty((9, total), dtype=torch.float32, device=first.device)
    _lib().call("pc_segscan5", *[a.data_ptr() for a in ins],
                out[4].data_ptr(), out.data_ptr(), total, tl, _stream())
    LAUNCHES["segmented_scan_sums"] += 1
    return tuple(out[i, :n] for i in range(4))


# ── 2./3. Exact k-smallest selection (SOR passes 1 and 2) ──────────────────


def _sqrt_f32(x):
    """Correctly rounded float32 square root (as CUDA's sqrtf and XLA's):
    taken in float64, whose rounding to float32 is then exact. torch's
    vectorised CPU sqrt is not correctly rounded."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _ordered_bits(v):
    """f32 -> int32 with the same order (negatives' magnitude bits
    flipped); its own inverse."""
    b = v.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _topk_lex(vals, k: int, pos=None):
    """The k smallest of f32 ``vals`` (no NaN) along the last axis, ties to
    the smaller position (as `lax.top_k` and the kernels order them): one
    int64 key (value, position) per element, since ``torch.topk`` does not
    promise an order among equal values. ``pos``: non-negative int64
    positions broadcasting to ``vals`` (default: the index along the last
    axis). Returns (values, positions)."""
    if pos is None:
        pos = torch.arange(vals.shape[-1], device=vals.device)
    key = (_ordered_bits(vals).to(torch.int64) << 32) | pos
    top = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    top_v = _ordered_bits((top >> 32).to(torch.int32).view(torch.float32))
    return top_v.view(torch.float32), top & 0xFFFFFFFF


def _topk_stats(w, k: int):
    """(total, count, kth) of the k smallest finite values along the last
    axis of ``w`` (inf = masked), summed sequentially in ascending order."""
    kk = min(k, w.shape[-1])
    if kk == 0:
        z = torch.zeros(w.shape[:-1], dtype=torch.float32, device=w.device)
        return z, z, z
    vals = torch.topk(w, kk, dim=-1, largest=False, sorted=True).values
    fin = torch.isfinite(vals)
    total = torch.zeros(w.shape[:-1], dtype=torch.float32, device=w.device)
    for j in range(kk):
        total = total + torch.where(
            fin[..., j], _sqrt_f32(torch.clamp(vals[..., j], min=0.0)), 0.0
        )
    count = fin.sum(-1)
    last = torch.clamp(count - 1, min=0).unsqueeze(-1)
    kth = torch.where(count > 0, torch.gather(vals, -1, last)[..., 0], 0.0)
    return total, count.to(torch.float32), kth


def fma_f32(a, b, c):
    """Correctly rounded float32 fused multiply-add, emulated in float64:
    a*b is exact there; the one f64 rounding of the sum is undone where it
    landed exactly on an f32 halfway point (the only case in which rounding
    twice differs from rounding once), using the TwoSum error term. Exact
    for results in the normal f32 range."""
    c = c.to(torch.float64)
    p = a.to(torch.float64) * b.to(torch.float64)
    s = p + c
    half = (s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)

    def fix(ps, cs, ss):
        bb = ss - ps
        err = (ps - (ss - bb)) + (cs - bb)
        toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
        return torch.where(err != 0, torch.nextafter(ss, toward), ss)

    if s.is_cuda:  # no host read: fix every element where it is needed
        return torch.where(half, fix(p, c, s), s).to(torch.float32)
    out = s.to(torch.float32)
    if bool(half.any()):  # rare: fix up only those elements
        idx = half.nonzero(as_tuple=True)
        out[idx] = fix(p[idx], c[idx], s[idx]).to(torch.float32)
    return out


def _d2(qx, qy, qz, cx, cy, cz):
    """[B, 128, C] squared distances, contracted as the kernels (and XLA's
    CPU backend) compute them: fma(dz, dz, fma(dx, dx, dy*dy))."""
    dx = qx[:, :, None] - cx[:, None, :]
    dy = qy[:, :, None] - cy[:, None, :]
    dz = qz[:, :, None] - cz[:, None, :]
    return fma_f32(dz, dz, fma_f32(dx, dx, dy * dy))


def _block_cands(q, pts, rows):
    """Chunks of query blocks against their candidate rows: yields (rows
    [B, R], query rows [B, 4, 128], candidates [B, 4, R*128]) for q
    [NB, 4, 128] and rows [NB, R] ids into ``pts``, at most
    ``_CHUNK_ELEMS`` query-candidate pairs per chunk."""
    nb, r = rows.shape
    step = max(1, _CHUNK_ELEMS // (128 * 128 * max(r, 1)))
    for s in range(0, nb, step):
        rs = rows[s:s + step]
        b = rs.shape[0]
        cand = pts[rs].permute(0, 2, 1, 3).reshape(b, 4, r * 128)
        yield rs, q[s:s + b], cand


def _block_pairs(q, pts, rows):
    """`_block_cands` with the pinned d2 [B, 128, R*128] and the both-valid
    mask (w channel = validity) in place of the candidates."""
    for rs, qs, cand in _block_cands(q, pts, rows):
        d2 = _d2(qs[:, 0], qs[:, 1], qs[:, 2], cand[:, 0], cand[:, 1],
                 cand[:, 2])
        pair = (qs[:, 3, :, None] > 0.5) & (cand[:, 3, None, :] > 0.5)
        yield rs, d2, pair


def _within_r2(qs, cand, r2):
    """[B, 128, C] exact ``d2 <= r2`` for the pinned d2, without the fma
    emulation on every pair: a plain f32 sum of the three squares is within
    a few ulp of the pinned form (no cancellation), so only pairs within a
    1e-5 relative band of r2 need the exact form. ``r2``: a float, or an
    f32 tensor broadcasting to [B, 128, C] (per query or per candidate)."""
    d = [qs[:, i, :, None] - cand[:, i, None, :] for i in range(3)]
    approx = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    r2 = torch.as_tensor(r2, dtype=torch.float32, device=approx.device)
    within = approx <= r2
    near = (approx - r2).abs() <= r2.abs() * 1e-5 + 1e-30
    if bool(near.any()):  # host read: plain versions only
        idx = near.nonzero(as_tuple=True)
        dx, dy, dz = (x[idx] for x in d)
        within[idx] = (fma_f32(dz, dz, fma_f32(dx, dx, dy * dy))
                       <= r2.expand_as(approx)[idx])
    return within


def _select_rows_plain(q, pts, rows, k: int):
    """q [NB, 4, 128] query rows; rows [NB, R] ids into ``pts`` (w channel =
    validity) -> (total, count, kth, ok) over NB*128 queries."""
    nb = rows.shape[0]
    parts = [torch.stack(_topk_stats(torch.where(pair, d2, torch.inf), k))
             for _, d2, pair in _block_pairs(q, pts, rows)]
    out = torch.cat(parts, dim=1).reshape(3, nb * 128)
    ok = torch.ones(nb * 128, dtype=torch.bool, device=q.device)
    return out[0], out[1], out[2], ok


def _list_rows(rowlist, cap: int, pad_row: int):
    """[NB, R] candidate row ids of each block's list, R = the longest list
    (a host read: plain versions only); blocks with no valid query and
    slots past a list's count read ``pad_row``."""
    n_used = torch.where(rowlist[:, cap] != 0, rowlist[:, cap + 1], 0)
    r = int(n_used.max()) if rowlist.shape[0] else 0
    slot = torch.arange(r, device=rowlist.device)
    return torch.where(slot[None, :] < n_used[:, None],
                       rowlist[:, :r].long(), pad_row)


def sweep_select_rows_plain(pts_padded, rowlist, *, k: int, cap: int):
    rows = _list_rows(rowlist, cap, pts_padded.shape[0] - 1)
    return _select_rows_plain(pts_padded[:rowlist.shape[0]], pts_padded,
                              rows, k)


def _check_aligned16(name: str, t: torch.Tensor):
    """The warp-select kernels (2, 3, 6, 7, 9, 10, 13), the min-label walk
    (4, 8, 16) and the pair walk (5, 11, 12, 14, 15) stage rows with
    16-byte cp.async copies."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must start on a 16-byte boundary")


def _check_k(k: int):
    if not 1 <= k <= 32:
        raise ValueError(f"k={k}: the selection kernels hold at most 32")


def sweep_select_rows(pts_padded, rowlist, *, k: int, cap: int):
    """Per 128-query block b (planar row b), the k smallest masked squared
    distances over the block's flat candidate row list.

    pts_padded f32[NR + 1, 4, 128] with an all-masked pad row at NR;
    rowlist i32[NB, cap + 2] (row ids, block-valid flag, true row count).
    Returns (total, count, kth f32[NB*128], ok bool[NB*128]).

    Replaces `pallas_kernels.sweep_select_rows` (csrc/select.cu)."""
    _check_k(k)
    nb = rowlist.shape[0]
    dev = pts_padded.device
    _check("sweep_select_rows.pts", pts_padded, torch.float32,
           (pts_padded.shape[0], 4, 128))
    _check("sweep_select_rows.rowlist", rowlist, torch.int32, (nb, cap + 2),
           dev)
    if pts_padded.shape[0] < nb + 1:
        raise ValueError("sweep_select_rows: fewer planar rows than blocks")
    if not _on_cuda(pts_padded):
        return sweep_select_rows_plain(pts_padded, rowlist, k=k, cap=cap)
    _check_aligned16("sweep_select_rows.pts", pts_padded)
    out = torch.empty((4, nb * 128), dtype=torch.float32, device=dev)
    _lib().call("pc_sweep_select_rows", pts_padded.data_ptr(),
                rowlist.data_ptr(), out.data_ptr(), nb, cap, k, _stream())
    LAUNCHES["sweep_select_rows"] += 1
    return out[0], out[1], out[2], out[3] > 0.5


def rescue_select_plain(cand_planar, q_planar, active, *, k: int, gr: int):
    # Slots past a block's group count read an all-masked pad row at nr.
    rows = _group_rows(q_planar, active, gr, cand_planar.shape[0])
    return _select_rows_plain(q_planar, _with_pad_row(cand_planar), rows, k)


def rescue_select(cand_planar, q_planar, active, *, k: int, gr: int = 8):
    """Exact k smallest of each compacted query against the candidate
    row-groups in its block's active list.

    cand_planar f32[NR, 4, 128] (NR % gr == 0), q_planar f32[QB, 4, 128],
    active i32[QB, 1 + NR/gr] (count, then ascending group ids; entries past
    the count are never read). Returns (total, count, kth, ok) over QB*128.

    Replaces `pallas_kernels.rescue_select` (csrc/select.cu)."""
    _check_k(k)
    nr = cand_planar.shape[0]
    qb = q_planar.shape[0]
    dev = cand_planar.device
    if nr % gr:
        raise ValueError(f"rescue_select: {nr} rows not a multiple of {gr}")
    _check("rescue_select.cand", cand_planar, torch.float32, (nr, 4, 128))
    _check("rescue_select.q", q_planar, torch.float32, (qb, 4, 128), dev)
    _check("rescue_select.active", active, torch.int32,
           (qb, 1 + nr // gr), dev)
    if not _on_cuda(cand_planar):
        return rescue_select_plain(cand_planar, q_planar, active, k=k, gr=gr)
    _check_aligned16("rescue_select.cand", cand_planar)
    out = torch.empty((4, qb * 128), dtype=torch.float32, device=dev)
    _lib().call("pc_rescue_select", cand_planar.data_ptr(),
                q_planar.data_ptr(), active.data_ptr(), out.data_ptr(), qb,
                1 + nr // gr, gr, k, _stream())
    LAUNCHES["rescue_select"] += 1
    return out[0], out[1], out[2], out[3] > 0.5


# ── 4. Cluster min-label propagation ────────────────────────────────────────

# Rounds `cluster_multisweep` launches between host reads of its per-round
# change counts (as kernel 8's `WINDOW_ROUND_BATCH`).
LIST_ROUND_BATCH = 4


def _cluster_pad(pts_planar):
    """Invalid coordinates masked to 1e9 and a 1e9 all-masked pad row
    appended at index NR (where the row lists' pad slots point)."""
    w = pts_planar[:, 3:4, :]
    masked = torch.cat(
        [torch.where(w > 0.5, pts_planar[:, :3, :], 1e9), w], dim=1)
    pad = torch.zeros((1, 4, 128), dtype=torch.float32,
                      device=pts_planar.device)
    pad[:, :3] = 1e9
    return torch.cat([masked, pad]).contiguous()


def _cluster_round_plain(pts, rows, lab, r2):
    """One round as the kernel computes it (hop + hook + two jumps), in
    Jacobi form; ``rows`` [NB, R] from `_list_rows`. Returns (new labels,
    per-query changed flags)."""
    nb, r = rows.shape
    nq = nb * 128
    big = torch.iinfo(torch.int32).max
    lab2 = lab.reshape(-1, 128)
    hops = []
    for rs, qs, cand in _block_cands(pts, pts, rows):
        pair = (qs[:, 3, :, None] > 0.5) & (cand[:, 3, None, :] > 0.5)
        clab = lab2[rs].reshape(rs.shape[0], 1, r * 128)
        hops.append(torch.where(pair & _within_r2(qs, cand, r2), clab, big)
                    .amin(-1).reshape(-1))
    m = torch.minimum(torch.cat(hops), lab[:nq])
    new = lab.clone()
    new[:nq] = m
    new.scatter_reduce_(0, lab[:nq].long(), m, reduce="amin")
    for _ in range(2):
        new = torch.minimum(new, new[new.long()])
    return new, (new[:nq] != lab[:nq]).to(torch.int32)


def _initial_labels(nr: int, nb: int, labels0, device):
    """Labels over all (nr + 1) * 128 padded rows: own positions, or
    ``labels0`` (i32[nb * 128]) for the query rows to resume from."""
    lab = torch.arange((nr + 1) * 128, dtype=torch.int32, device=device)
    if labels0 is not None:
        lab[: nb * 128] = labels0
    return lab


def _cluster_rounds_plain(pts_planar, rows, r2, nb: int, max_rounds: int,
                          labels0=None):
    nr = pts_planar.shape[0]
    pts = _cluster_pad(pts_planar)
    lab = _initial_labels(nr, nb, labels0, pts_planar.device)
    changed = torch.zeros(nb * 128, dtype=torch.int32,
                          device=pts_planar.device)
    rounds = 0
    while rounds < max_rounds:
        lab, changed = _cluster_round_plain(pts, rows, lab, r2)
        rounds += 1
        if not bool(changed.any()):  # host sync: convergence test
            break
    return lab[: nb * 128], changed, rounds


def cluster_multisweep_plain(pts_planar, rowlist, r2, *, cap: int,
                             max_rounds: int):
    rows = _list_rows(rowlist, cap, pts_planar.shape[0])
    return _cluster_rounds_plain(pts_planar, rows, r2, rowlist.shape[0],
                                 max_rounds)


def cluster_multisweep(pts_planar, rowlist, r2, *, cap: int,
                       max_rounds: int = 64):
    """Connected-component labels over the per-block row lists.

    pts_planar f32[NR, 4, 128]; rowlist i32[NB, cap + 2] with pad slots =
    NR; r2 the squared radius (inclusive). Runs propagation rounds until
    one changes nothing, at most ``max_rounds``. Returns (labels i32[NB*128]
    in sorted order: each valid row gets the smallest sorted position of
    its component, invalid rows their own; changed i32[NB*128], the last
    round's flags -- all zero iff converged; rounds run).

    The CUDA path launches rounds in batches of `LIST_ROUND_BATCH` and
    reads their change counts once a batch (as
    `cluster_multisweep_windows`); its rounds fold the pointer jumps into
    the next round, so ``rounds`` (up to and including the first that
    changed nothing) may differ from the plain version's Jacobi rounds.

    Replaces `pallas_kernels.cluster_multisweep` (csrc/cluster.cu)."""
    nr = pts_planar.shape[0]
    nb = rowlist.shape[0]
    dev = pts_planar.device
    _check("cluster_multisweep.pts", pts_planar, torch.float32, (nr, 4, 128))
    _check("cluster_multisweep.rowlist", rowlist, torch.int32, (nb, cap + 2),
           dev)
    if nb > nr:
        raise ValueError("cluster_multisweep: more blocks than planar rows")
    r2 = float(r2)
    if not _on_cuda(pts_planar):
        out = cluster_multisweep_plain(pts_planar, rowlist, r2, cap=cap,
                                       max_rounds=max_rounds)
        profiling.count("cluster.rounds", out[2])
        return out
    _check_aligned16("cluster_multisweep.pts", pts_planar)

    def launch(state, first, count):
        _lib().call("pc_cluster_rounds_lists", pts_planar.data_ptr(),
                    rowlist.data_ptr(), *state, nb, nr, cap,
                    max_rounds + 1, r2, first, count, _stream())

    return _label_rounds_cuda("cluster_multisweep", launch, LIST_ROUND_BATCH,
                              nb, nr, max_rounds, dev)


def _label_rounds_cuda(name, launch, batch: int, nb: int, nr: int,
                       max_rounds: int, dev):
    """Drive kernel ``name``'s one-launch rounds (csrc/cluster.cu) in
    batches of ``batch``, one ``launch(state pointers, first round,
    rounds)`` and one host read of the counts a batch, until a round
    changed nothing or ``max_rounds`` ran; the first launch also sets the
    state up (labels, round stamps per row and per query, per-round change
    counts after the walked-pairs count). Counts the rounds, the host reads
    of the counts (``cluster.round_batches``) and the query-candidate pairs
    the hops walked, frontier and row prune applied
    (``cluster.pairs_visited``), into the open frame."""
    nq = nb * 128
    lab = torch.empty(nr * 128, dtype=torch.int32, device=dev)
    stamp = torch.empty(nr, dtype=torch.int32, device=dev)
    last = torch.empty(nq, dtype=torch.int32, device=dev)
    counts = torch.empty(1 + max_rounds, dtype=torch.int64, device=dev)
    state = [lab.data_ptr(), stamp.data_ptr(), last.data_ptr(),
             counts.data_ptr()]
    launched, reads, rounds = 0, 0, max_rounds
    while True:  # the first launch sets the state up, even for no round
        n = min(batch, max_rounds - launched)
        launch(state, launched + 1, n)
        launched += n
        with profiling.host_read("cluster.round_counts"):  # once a batch
            got = counts[: launched + 1].tolist()
        reads += 1
        if 0 in got[1:]:
            rounds = got.index(0, 1)
            break
        if launched >= max_rounds:
            break
    LAUNCHES[name] += rounds
    profiling.count("cluster.rounds", rounds)
    profiling.count("cluster.round_batches", reads)
    profiling.count("cluster.pairs_visited", 128 * got[0])
    # Lowered in the last round (none if it converged); all zero (`last`)
    # when no round ran.
    changed = last == rounds if rounds else last
    return lab[:nq], changed.to(torch.int32), rounds


# ── 5. RANSAC inlier counts ─────────────────────────────────────────────────


def ransac_score_counts_plain(hyp, pts_planar):
    """Counts with the kernel's pinned distance form
    |fma(z, nz, fma(x, nx, y*ny)) + d|, over chunks of points."""
    nh = hyp.shape[1]
    x, y, z, w = (pts_planar[:, i, :].reshape(-1) for i in range(4))
    nx, ny, nz, dd, th = (hyp[i][None, :] for i in range(5))
    counts = torch.zeros(nh, dtype=torch.int64, device=hyp.device)
    step = max(1, _CHUNK_ELEMS // max(nh, 1))
    for s in range(0, x.shape[0], step):
        px, py, pz = (a[s:s + step, None] for a in (x, y, z))
        dist = (fma_f32(pz, nz, fma_f32(px, nx, py * ny)) + dd).abs()
        hit = (w[s:s + step, None] > 0.5) & (dist <= th)
        counts += hit.sum(dim=0)
    return counts.to(torch.float32)


def ransac_score_counts(hyp, pts_planar):
    """Inlier counts per plane hypothesis over the whole masked cloud.

    hyp f32[5, NH] (rows nx, ny, nz, d, threshold; NH a multiple of 128,
    pad slots carry threshold -1), pts_planar f32[NR, 4, 128] (w =
    validity). Returns f32[NH] counts, exact.

    Replaces `pallas_kernels.ransac_score_counts` (csrc/ransac.cu)."""
    nh = hyp.shape[1]
    nr = pts_planar.shape[0]
    dev = hyp.device
    if nh % 128:
        raise ValueError(f"ransac_score_counts: NH={nh} not a multiple of 128")
    _check("ransac_score_counts.hyp", hyp, torch.float32, (5, nh))
    _check("ransac_score_counts.pts", pts_planar, torch.float32, (nr, 4, 128),
           dev)
    if not _on_cuda(hyp):
        return ransac_score_counts_plain(hyp, pts_planar)
    _check_aligned16("ransac_score_counts.pts", pts_planar)
    out = torch.empty(nh, dtype=torch.float32, device=dev)
    counts, arrived = _block_scratch("ransac_score_counts", dev, nh // 128,
                                     torch.int32, 0)
    _lib().call("pc_ransac_score_counts", hyp.data_ptr(),
                pts_planar.data_ptr(), out.data_ptr(), nh, nr,
                counts.data_ptr(), arrived.data_ptr(), _stream())
    LAUNCHES["ransac_score_counts"] += 1
    return out


# ── Window row lists (plain versions of the window kernels) ────────────────


def _window_rows(starts, pad_row: int):
    """[NB, R] candidate rows of each block's windows [start + skip, start +
    length), in window order, pad slots (``pad_row``) after the real rows;
    blocks with no valid query get none. R is the longest list, at least 1
    (a host read: plain versions only)."""
    nb = starts.shape[0]
    st = starts[:, :9, None].long()
    sk = starts[:, 9:18, None].long()
    ln = starts[:, 18:27, None].long()
    wr = int(ln.max()) if nb else 0
    r = torch.arange(wr, device=starts.device)
    keep = (r >= sk) & (r < ln) & (starts[:, 27, None, None] != 0)
    keep = keep.reshape(nb, 9 * wr)
    rows = (st + r).reshape(nb, 9 * wr)
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    n_keep = keep.sum(dim=1)
    width = max(int(n_keep.max()) if nb else 0, 1)
    rows = torch.gather(rows, 1, order[:, :width])
    slot = torch.arange(width, device=starts.device)
    return torch.where(slot[None, :] < n_keep[:, None], rows, pad_row)


# ── 6. kNN moments over the windows ────────────────────────────────────────


def sweep_moments_plain(pts_planar, starts, *, k: int):
    nr = pts_planar.shape[0]
    nb = starts.shape[0]
    dev = pts_planar.device
    out = torch.zeros((16, nb * 128), dtype=torch.float32, device=dev)
    out[12] = 1.0
    rows = _window_rows(starts, nr)
    pts = _with_pad_row(pts_planar)
    band1 = torch.tensor(np.float32(1.0 + D2_BAND), device=dev)
    band3 = torch.tensor(np.float32(1.0 + 3.0 * D2_BAND), device=dev)
    at = 0
    for rs, qs, cand in _block_cands(pts, pts, rows):
        b, ncand = rs.shape[0], cand.shape[2]
        d2 = _d2(qs[:, 0], qs[:, 1], qs[:, 2], cand[:, 0], cand[:, 1],
                 cand[:, 2])
        pair = (qs[:, 3, :, None] > 0.5) & (cand[:, 3, None, :] > 0.5)
        _, count, kth = _topk_stats(torch.where(pair, d2, torch.inf), k)
        le = pair & (d2 <= (kth * band1)[..., None])
        cle = (pair & (d2 <= (kth * band3)[..., None])).sum(-1)
        # Included candidates in ascending candidate order, summed one at
        # a time from 0.0, as the kernel adds them.
        m = int(le.sum(-1).max())
        key = torch.where(le, torch.arange(ncand, device=dev), ncand)
        idx = torch.topk(key, m, dim=-1, largest=False, sorted=True).values
        slot_ok = idx < ncand
        idx = torch.clamp(idx, max=ncand - 1)
        rel = [torch.gather(cand[:, i, None, :].expand(b, 128, ncand), 2, idx)
               - qs[:, i, :, None] for i in range(3)]
        rx, ry, rz = rel
        terms = (rx, ry, rz, rx * rx, ry * ry, rz * rz, rx * ry, rx * rz,
                 ry * rz)
        acc = [torch.zeros((b, 128), dtype=torch.float32, device=dev)
               for _ in terms]
        for j in range(m):
            ok = slot_ok[..., j]
            acc = [torch.where(ok, a + t[..., j], a) for a, t in zip(acc, terms)]
        cols = slice(at * 128, (at + b) * 128)
        for i, a in enumerate(acc):
            out[i, cols] = a.reshape(-1)
        out[9, cols] = cle.to(torch.float32).reshape(-1)
        out[10, cols] = count.reshape(-1)
        out[11, cols] = kth.reshape(-1)
        at += b
    return out


def sweep_moments(pts_planar, starts, *, k: int):
    """Exact kNN selection + banded query-centred neighbour moments over
    each 128-query block's nine sorted windows.

    pts_planar f32[NR, 4, 128] (query block b = row b); starts i32[NB, 28]
    (the `_window_starts` pack). Returns f32[16, NB*128]: rows 0-2 sum of
    (c - q), 3-8 sums of products (xx, yy, zz, xy, xz, yz) over the
    candidates with d2 <= kth*(1 + D2_BAND), 9 cle (candidates with d2 <=
    kth*(1 + 3 D2_BAND)), 10 count, 11 kth d2, 12 cert (1), 13-15 zero.

    Replaces `pallas_kernels.sweep_moments` (csrc/moments.cu)."""
    _check_k(k)
    nr = pts_planar.shape[0]
    nb = starts.shape[0]
    dev = pts_planar.device
    _check("sweep_moments.pts", pts_planar, torch.float32, (nr, 4, 128))
    _check("sweep_moments.starts", starts, torch.int32, (nb, 28), dev)
    if nb > nr:
        raise ValueError("sweep_moments: more blocks than planar rows")
    if not _on_cuda(pts_planar):
        return sweep_moments_plain(pts_planar, starts, k=k)
    _check_aligned16("sweep_moments.pts", pts_planar)
    out = torch.empty((16, nb * 128), dtype=torch.float32, device=dev)
    _lib().call("pc_sweep_moments", pts_planar.data_ptr(), starts.data_ptr(),
                out.data_ptr(), nb, k, float(np.float32(1.0 + D2_BAND)),
                float(np.float32(1.0 + 3.0 * D2_BAND)), _stream())
    LAUNCHES["sweep_moments"] += 1
    return out


# ── 7. Group-pruned exact kNN with positions ───────────────────────────────


def _group_rows(q_planar, active, gr: int, pad_row: int, live=None):
    """[QB, G*gr] candidate rows of each query block's active groups, in
    ascending group order (pad slots ``pad_row``; at least one group's
    width); blocks with no valid query (``live`` False; default: no w >
    0.5) get none."""
    if live is None:
        live = q_planar[:, 3, :].amax(dim=1) > 0.5
    cnt = torch.where(live, active[:, 0], 0)
    g = max(int(cnt.max()) if active.shape[0] else 0, 1)
    slot = torch.arange(g * gr, device=active.device)
    groups = active[:, 1:1 + g].long().repeat_interleave(gr, dim=1)
    return torch.where(slot[None, :] < cnt[:, None] * gr,
                       groups * gr + slot % gr, pad_row)


def _knn_out(vals, pos):
    """[B, 128, 2k + 3] kNN output rows from the k smallest d2 ``vals``
    (ascending, +inf = none) and their positions: sqrt d2 (+inf pad),
    positions (-1 pad), count, kth d2 (0 if none), certificate 1."""
    found = torch.isfinite(vals)
    count = found.sum(-1)
    last = torch.clamp(count - 1, min=0).unsqueeze(-1)
    kth = torch.where(count > 0, torch.gather(vals, -1, last)[..., 0], 0.0)
    return torch.cat([
        torch.where(found, _sqrt_f32(torch.clamp(vals, min=0.0)), torch.inf),
        torch.where(found, pos.to(torch.float32), -1.0),
        count[..., None].to(torch.float32), kth[..., None],
        torch.ones(vals.shape[:-1] + (1,), device=vals.device)], dim=-1)


def _knn_rows_plain(q, cands, rows, k: int):
    """f32[2k + 3, NB*128]: the exact k nearest of each block's queries
    over its candidate rows [NB, R] (ids into ``cands``, an all-masked pad
    row last), ties at equal d2 to the smaller position row*128 + lane."""
    parts = []
    for rs, d2, pair in _block_pairs(q, cands, rows):
        b = rs.shape[0]
        pos = (rs[:, None, :, None] * 128
               + torch.arange(128, device=rs.device)).reshape(b, 1, -1)
        vals, p = _topk_lex(torch.where(pair, d2, torch.inf), k, pos)
        parts.append(_knn_out(vals, p))
    return torch.cat(parts).reshape(-1, 2 * k + 3).T.contiguous()


def rescue_knn_idx_plain(cand_planar, q_planar, active, *, k: int, gr: int):
    rows = _group_rows(q_planar, active, gr, cand_planar.shape[0])
    return _knn_rows_plain(q_planar, _with_pad_row(cand_planar), rows, k)


def rescue_knn_idx(cand_planar, q_planar, active, *, k: int, gr: int = 8):
    """Exact k nearest candidates, with their positions, of each compacted
    query against the candidate row-groups in its block's active list.

    cand_planar f32[NR, 4, 128] (NR % gr == 0), q_planar f32[QB, 4, 128],
    active i32[QB, 1 + NR/gr] (count, then ascending group ids). Returns
    f32[2k + 3, QB*128]: rows [0, k) sqrt d2 ascending (+inf pad), [k, 2k)
    positions row*128 + lane in the candidate frame (-1 pad; ties at equal
    d2 to the smaller position), then count, kth d2, cert (1).

    Replaces `pallas_kernels.rescue_knn_idx` (csrc/knn.cu)."""
    _check_k(k)
    nr = cand_planar.shape[0]
    qb = q_planar.shape[0]
    dev = cand_planar.device
    if nr % gr:
        raise ValueError(f"rescue_knn_idx: {nr} rows not a multiple of {gr}")
    if nr * 128 >= 1 << 24:
        raise ValueError("rescue_knn_idx: positions must stay exact in f32")
    _check("rescue_knn_idx.cand", cand_planar, torch.float32, (nr, 4, 128))
    _check("rescue_knn_idx.q", q_planar, torch.float32, (qb, 4, 128), dev)
    _check("rescue_knn_idx.active", active, torch.int32, (qb, 1 + nr // gr),
           dev)
    if not _on_cuda(cand_planar):
        return rescue_knn_idx_plain(cand_planar, q_planar, active, k=k, gr=gr)
    _check_aligned16("rescue_knn_idx.cand", cand_planar)
    out = torch.empty((2 * k + 3, qb * 128), dtype=torch.float32, device=dev)
    _lib().call("pc_rescue_knn_idx", cand_planar.data_ptr(),
                q_planar.data_ptr(), active.data_ptr(), out.data_ptr(), qb,
                1 + nr // gr, gr, k, _stream())
    LAUNCHES["rescue_knn_idx"] += 1
    return out


# ── 8. Cluster labels over the windows ─────────────────────────────────────

# Rounds `cluster_multisweep_windows` launches between host reads of its
# per-round change counts (csrc/cluster.cu): rounds after the first that
# changed nothing return at once.
WINDOW_ROUND_BATCH = 4


def cluster_multisweep_windows_plain(pts_planar, starts, r2, *,
                                     max_rounds: int, labels0=None):
    rows = _window_rows(starts, pts_planar.shape[0])
    return _cluster_rounds_plain(pts_planar, rows, r2, starts.shape[0],
                                 max_rounds, labels0)


def cluster_multisweep_windows(pts_planar, starts, r2, *,
                               max_rounds: int = 12, labels0=None):
    """Connected-component labels over each block's nine sorted windows
    (no row cap: the dense backend).

    pts_planar f32[NR, 4, 128]; starts i32[NB, 28]; r2 the squared radius
    (inclusive); ``labels0`` i32[NB*128] labels to resume from (default:
    own positions). Runs rounds until one changes nothing, at most
    ``max_rounds``. Returns (labels i32[NB*128] in sorted order, changed
    i32[NB*128] -- the last round's flags, all zero iff converged; rounds
    run).

    The CUDA path launches rounds in batches of `WINDOW_ROUND_BATCH` and
    reads their change counts once a batch; rounds after the first that
    changed nothing write nothing, and ``rounds`` counts the rounds up to
    and including that one.

    Replaces `pallas_kernels.cluster_multisweep_windows` (csrc/cluster.cu)."""
    nr = pts_planar.shape[0]
    nb = starts.shape[0]
    dev = pts_planar.device
    _check("cluster_multisweep_windows.pts", pts_planar, torch.float32,
           (nr, 4, 128))
    _check("cluster_multisweep_windows.starts", starts, torch.int32,
           (nb, 28), dev)
    if labels0 is not None:
        _check("cluster_multisweep_windows.labels0", labels0, torch.int32,
               (nb * 128,), dev)
    if nb > nr:
        raise ValueError("cluster_multisweep_windows: more blocks than rows")
    r2 = float(r2)
    if not _on_cuda(pts_planar):
        out = cluster_multisweep_windows_plain(
            pts_planar, starts, r2, max_rounds=max_rounds, labels0=labels0)
        profiling.count("cluster.rounds", out[2])
        return out
    _check_aligned16("cluster_multisweep_windows.pts", pts_planar)
    labels0_ptr = None if labels0 is None else labels0.data_ptr()

    def launch(state, first, count):
        _lib().call("pc_cluster_rounds_windows", pts_planar.data_ptr(),
                    starts.data_ptr(), labels0_ptr, *state, nb, nr,
                    max_rounds + 1, r2, first, count, _stream())

    return _label_rounds_cuda("cluster_multisweep_windows", launch,
                              WINDOW_ROUND_BATCH, nb, nr, max_rounds, dev)


# ── 9. Exact k-smallest selection over the windows (SOR, no row cap) ───────


def _with_pad_row(pts_planar):
    """Planar rows with an all-zero (masked) row appended at index NR,
    where the plain versions' pad slots point."""
    return torch.cat([pts_planar, torch.zeros((1, 4, 128),
                                              device=pts_planar.device)])


def sweep_select_plain(pts_planar, starts, *, k: int):
    nr, nb = pts_planar.shape[0], starts.shape[0]
    return _select_rows_plain(pts_planar[:nb], _with_pad_row(pts_planar),
                              _window_rows(starts, nr), k)


def sweep_select(pts_planar, starts, *, k: int):
    """Per 128-query block b (planar row b), the k smallest masked squared
    distances over the block's nine deduplicated windows [start + skip,
    start + length) (`sweep_select_rows` without a row cap).

    pts_planar f32[NR, 4, 128] (w = validity); starts i32[NB, 28] (the
    `_window_starts` pack). Returns (total, count, kth f32[NB*128], ok
    bool[NB*128]; ok always True: the selection is exact).

    Replaces `pallas_kernels.sweep_select` (csrc/select.cu)."""
    _check_k(k)
    nr, nb = pts_planar.shape[0], starts.shape[0]
    dev = pts_planar.device
    _check("sweep_select.pts", pts_planar, torch.float32, (nr, 4, 128))
    _check("sweep_select.starts", starts, torch.int32, (nb, 28), dev)
    if nb > nr:
        raise ValueError("sweep_select: more blocks than planar rows")
    if not _on_cuda(pts_planar):
        return sweep_select_plain(pts_planar, starts, k=k)
    _check_aligned16("sweep_select.pts", pts_planar)
    out = torch.empty((4, nb * 128), dtype=torch.float32, device=dev)
    _lib().call("pc_sweep_select", pts_planar.data_ptr(), starts.data_ptr(),
                out.data_ptr(), nb, k, _stream())
    LAUNCHES["sweep_select"] += 1
    return out[0], out[1], out[2], out[3] > 0.5


# ── 11./12./14. Inclusive radius counts ─────────────────────────────────────


def _count_hits(q, pts, rows, r2_of):
    """Per query of each block, the candidates with pinned d2 <= r2, where
    ``r2_of(qs, cand)`` gives r2 broadcasting to [B, 128, C] (or -1 / 0
    where no hit may count). Returns f32[NB*128]."""
    parts = [_within_r2(qs, cand, r2_of(qs, cand)).sum(-1)
             for _, qs, cand in _block_cands(q, pts, rows)]
    return torch.cat(parts).reshape(-1).to(torch.float32)


def count_within_plain(pts_planar, starts):
    nr, nb = pts_planar.shape[0], starts.shape[0]

    def r2_of(qs, cand):  # the candidate's r2 where both are valid
        cw = cand[:, 3, None, :]
        return torch.where((qs[:, 3, :, None] > 0.0) & (cw > 0.0), cw, -1.0)

    return _count_hits(pts_planar[:nb], _with_pad_row(pts_planar),
                       _window_rows(starts, nr), r2_of)


def count_within(pts_planar, starts):
    """Per query, the candidates within its radius over the block's nine
    deduplicated windows (inclusive, self included).

    pts_planar f32[NR, 4, 128] with w = r2 (valid) or 0 (masked): a
    query counts candidate c iff both are valid and d2 <= w_c; starts
    i32[NB, 28]. Returns f32[NB*128] counts.

    Replaces `pallas_kernels.count_within` (csrc/radius.cu)."""
    nr, nb = pts_planar.shape[0], starts.shape[0]
    dev = pts_planar.device
    _check("count_within.pts", pts_planar, torch.float32, (nr, 4, 128))
    _check("count_within.starts", starts, torch.int32, (nb, 28), dev)
    if nb > nr:
        raise ValueError("count_within: more blocks than planar rows")
    if not _on_cuda(pts_planar):
        return count_within_plain(pts_planar, starts)
    _check_aligned16("count_within.pts", pts_planar)
    out = torch.empty(nb * 128, dtype=torch.float32, device=dev)
    _lib().call("pc_count_within", pts_planar.data_ptr(), starts.data_ptr(),
                out.data_ptr(), nb, _stream())
    LAUNCHES["count_within"] += 1
    return out


def _radius_r2(qs, cand):
    """The query's r2 (w channel; -1 = invalid) where the candidate is
    valid."""
    return torch.where(cand[:, 3, None, :] > 0.5, qs[:, 3, :, None], -1.0)


def _radius_live(q_planar):
    """Query blocks holding a valid radius query (w = r2 >= 0)."""
    return q_planar[:, 3, :].amax(dim=1) >= 0.0


def rescue_radius_count_groups_plain(cand_planar, q_planar, active, *,
                                     gr: int):
    nr = cand_planar.shape[0]
    rows = _group_rows(q_planar, active, gr, nr, _radius_live(q_planar))
    return _count_hits(q_planar, _with_pad_row(cand_planar), rows,
                       _radius_r2)


def rescue_radius_count_groups(cand_planar, q_planar, active, *,
                               gr: int = 8):
    """Exact inclusive within-radius counts of compacted query blocks
    against the candidate row-groups in each block's active list.

    cand_planar f32[NR, 4, 128] (NR % gr == 0, w = validity), q_planar
    f32[QB, 4, 128] with w = r2 (-1 marks an invalid query), active
    i32[QB, 1 + NR/gr] (count, then ascending group ids). Returns
    f32[QB*128].

    Replaces `pallas_kernels.rescue_radius_count_groups`
    (csrc/radius.cu)."""
    nr, qb = cand_planar.shape[0], q_planar.shape[0]
    dev = cand_planar.device
    if nr % gr:
        raise ValueError(f"rescue_radius_count_groups: {nr} rows not a "
                         f"multiple of {gr}")
    _check("rescue_radius_count_groups.cand", cand_planar, torch.float32,
           (nr, 4, 128))
    _check("rescue_radius_count_groups.q", q_planar, torch.float32,
           (qb, 4, 128), dev)
    _check("rescue_radius_count_groups.active", active, torch.int32,
           (qb, 1 + nr // gr), dev)
    if not _on_cuda(cand_planar):
        return rescue_radius_count_groups_plain(cand_planar, q_planar, active,
                                                gr=gr)
    _check_aligned16("rescue_radius_count_groups.cand", cand_planar)
    out = torch.empty(qb * 128, dtype=torch.float32, device=dev)
    counts, arrived = _block_scratch("rescue_radius_count_groups", dev, qb,
                                     torch.int32, 0)
    _lib().call("pc_rescue_radius_count", cand_planar.data_ptr(),
                q_planar.data_ptr(), active.data_ptr(), out.data_ptr(), qb,
                1 + nr // gr, gr, counts.data_ptr(), arrived.data_ptr(),
                _stream())
    LAUNCHES["rescue_radius_count_groups"] += 1
    return out


def _live_only(q_planar, live, fill, fn):
    """``fn(q_live)`` -> f32[R, L*128] on the live query blocks only, into
    a [R, QB*128] output holding ``fill`` (f32[R]) on the others (a host
    read: plain versions only)."""
    blocks = live.nonzero(as_tuple=True)[0]
    qb = q_planar.shape[0]
    out = fill[:, None, None].expand(fill.shape[0], qb, 128).clone()
    if blocks.numel():
        got = fn(q_planar[blocks])
        out[:, blocks] = got.reshape(fill.shape[0], -1, 128)
    return out.reshape(fill.shape[0], qb * 128)


def _every_row(qb: int, nr: int, device):
    return torch.arange(nr, device=device).expand(qb, nr)


def brute_radius_count_plain(q_planar, cand_planar):
    nr = cand_planar.shape[0]
    pts = _with_pad_row(cand_planar)
    zero = torch.zeros(1, device=cand_planar.device)
    return _live_only(
        q_planar, _radius_live(q_planar), zero,
        lambda q: _count_hits(q, pts, _every_row(q.shape[0], nr, q.device),
                              _radius_r2)[None])[0]


def _check_brute(name, q_planar, cand_planar):
    nr, qb = cand_planar.shape[0], q_planar.shape[0]
    _check(f"{name}.cand", cand_planar, torch.float32, (nr, 4, 128))
    _check(f"{name}.q", q_planar, torch.float32, (qb, 4, 128),
           cand_planar.device)
    if nr * 128 >= 1 << 24:
        raise ValueError(f"{name}: positions must stay exact in f32")
    return nr, qb


# Scratch of the kernels whose CTAs combine a query block's results
# (kernels 5, 12, 14 and 15; kernel 5's blocks are hypothesis tiles), per
# kernel and (device, stream): a value per query [cap * 128], made equal
# to `fill`, and one int32 arrival counter a query block [cap], zeroed.
# Every call leaves both so (the last CTA of each block resets what it
# used), so a call makes one launch and no memset. Calls on one stream
# never overlap.
_BLOCK_SCRATCH = {}


def _block_scratch(kernel: str, dev, qb: int, dtype, fill: int):
    key = (kernel, dev, _stream())
    t = _BLOCK_SCRATCH.get(key)
    if t is None or t[1].numel() < qb:
        cap = max(qb, 32)
        t = (torch.full((cap * 128,), fill, dtype=dtype, device=dev),
             torch.zeros(cap, dtype=torch.int32, device=dev))
        _BLOCK_SCRATCH[key] = t
    return t


def brute_radius_count(q_planar, cand_planar):
    """Exact inclusive within-radius counts of every query over the whole
    candidate array.

    q_planar f32[QB, 4, 128] with w = r2 (-1 marks an invalid query),
    cand_planar f32[NR, 4, 128] (w = validity). Returns f32[QB*128].

    Replaces `pallas_kernels.brute_radius_count` (csrc/brute.cu)."""
    nr, qb = _check_brute("brute_radius_count", q_planar, cand_planar)
    if not _on_cuda(cand_planar):
        return brute_radius_count_plain(q_planar, cand_planar)
    _check_aligned16("brute_radius_count.cand", cand_planar)
    dev = cand_planar.device
    out = torch.empty(qb * 128, dtype=torch.float32, device=dev)
    counts, arrived = _block_scratch("brute_radius_count", dev, qb,
                                     torch.int32, 0)
    _lib().call("pc_brute_radius_count", q_planar.data_ptr(),
                cand_planar.data_ptr(), out.data_ptr(), qb, nr,
                counts.data_ptr(), arrived.data_ptr(), _stream())
    LAUNCHES["brute_radius_count"] += 1
    return out


# ── 13. Exact kNN over the whole cloud, with positions ─────────────────────


def _brute_knn_live(q_planar, cand_planar, k: int):
    nr = cand_planar.shape[0]
    dev = cand_planar.device
    rows = _every_row(q_planar.shape[0], nr, dev)
    parts = []
    for _, d2, pair in _block_pairs(q_planar, _with_pad_row(cand_planar),
                                    rows):
        w = torch.where(pair, d2, torch.inf)
        if w.shape[2] < k:
            w = torch.nn.functional.pad(w, (0, k - w.shape[2]),
                                        value=torch.inf)
        # Candidates are in position order: ties to the smaller position.
        vals, pos = _topk_lex(w, k)
        found = torch.isfinite(vals)
        pos = pos.to(torch.float32)
        parts.append(torch.cat([
            torch.where(found, _sqrt_f32(torch.clamp(vals, min=0.0)),
                        torch.inf),
            torch.where(found, pos, -1.0),
            found.sum(-1, keepdim=True).to(torch.float32)], dim=2))
    return torch.cat(parts).reshape(-1, 2 * k + 1).T


def brute_knn_idx_plain(q_planar, cand_planar, *, k: int):
    dev = cand_planar.device
    fill = torch.tensor([torch.inf] * k + [-1.0] * k + [0.0], device=dev)
    return _live_only(q_planar, q_planar[:, 3, :].amax(dim=1) > 0.5, fill,
                      lambda q: _brute_knn_live(q, cand_planar, k))


def brute_knn_idx(q_planar, cand_planar, *, k: int):
    """Exact k nearest valid candidates of every query over the whole
    candidate array.

    q_planar f32[QB, 4, 128], cand_planar f32[NR, 4, 128] (w = validity).
    Returns f32[2k + 1, QB*128]: rows [0, k) distances sqrt(d2) ascending
    (+inf pad), [k, 2k) flat candidate positions row*128 + lane (-1 pad;
    ties at equal d2 to the smaller position), row 2k the count found.

    Replaces `pallas_kernels.brute_knn_idx` (csrc/brute.cu)."""
    _check_k(k)
    nr, qb = _check_brute("brute_knn_idx", q_planar, cand_planar)
    if not _on_cuda(cand_planar):
        return brute_knn_idx_plain(q_planar, cand_planar, k=k)
    _check_aligned16("brute_knn_idx.cand", cand_planar)
    out = torch.empty((2 * k + 1, qb * 128), dtype=torch.float32,
                      device=cand_planar.device)
    _lib().call("pc_brute_knn_idx", q_planar.data_ptr(),
                cand_planar.data_ptr(), out.data_ptr(), qb, nr, k, _stream())
    LAUNCHES["brute_knn_idx"] += 1
    return out


# ── 10. kNN with positions over the windows ────────────────────────────────


def sweep_knn_select_plain(pts_planar, starts, *, k: int, q_planar=None):
    nr, nb = pts_planar.shape[0], starts.shape[0]
    q = pts_planar if q_planar is None else q_planar
    return _knn_rows_plain(q[:nb], _with_pad_row(pts_planar),
                           _window_rows(starts, nr), k)


def sweep_knn_select(pts_planar, starts, *, k: int, q_planar=None):
    """Exact k nearest candidates, with their positions, of each 128-query
    block over its nine deduplicated windows [start + skip, start +
    length) of the cell-sorted candidate rows.

    pts_planar f32[NR, 4, 128] (w = validity); starts i32[NB, 28] (the
    `_window_starts` pack); ``q_planar`` f32[QB >= NB, 4, 128], a separately
    sorted query frame whose block b walks starts[b] (the cross-cloud
    sweep; default: ``pts_planar``, query block b = row b). Returns f32[2k
    + 3, NB*128]: rows [0, k) sqrt d2 ascending (+inf pad), [k, 2k)
    positions row*128 + lane in the candidate frame (-1 pad; ties at equal
    d2 to the smaller position), then count, kth d2 (0 if none), cert (1).

    Replaces `pallas_kernels.sweep_knn_select` (csrc/sweepknn.cu)."""
    _check_k(k)
    nr, nb = pts_planar.shape[0], starts.shape[0]
    dev = pts_planar.device
    q = pts_planar if q_planar is None else q_planar
    _check("sweep_knn_select.pts", pts_planar, torch.float32, (nr, 4, 128))
    _check("sweep_knn_select.q", q, torch.float32, (q.shape[0], 4, 128), dev)
    _check("sweep_knn_select.starts", starts, torch.int32, (nb, 28), dev)
    if nb > q.shape[0]:
        raise ValueError("sweep_knn_select: more blocks than query rows")
    if nr * 128 >= 1 << 24:
        raise ValueError("sweep_knn_select: positions must stay exact in f32")
    if not _on_cuda(pts_planar):
        return sweep_knn_select_plain(pts_planar, starts, k=k,
                                      q_planar=q_planar)
    _check_aligned16("sweep_knn_select.pts", pts_planar)
    out = torch.empty((2 * k + 3, nb * 128), dtype=torch.float32, device=dev)
    _lib().call("pc_sweep_knn_select", pts_planar.data_ptr(), q.data_ptr(),
                starts.data_ptr(), out.data_ptr(), nb, k, _stream())
    LAUNCHES["sweep_knn_select"] += 1
    return out


# ── 15. Exact 1-NN over the whole target (ICP correspondences) ─────────────

# Relative band around the smallest plain f32 d2 within which the plain
# version re-derives the pinned d2: both forms are within a few ulp of the
# true value (a sum of squares, no cancellation).
_NN_BAND = 1e-5


def _query_use(q_planar):
    """[QB*128] queries the 1-NN serves: w > 0.5 and finite coordinates."""
    q = q_planar.permute(1, 0, 2).reshape(4, -1)
    return (q[3] > 0.5) & torch.isfinite(q[:3]).all(dim=0)


def nn_argmin_plain(q_planar, cand_planar):
    q = q_planar.permute(1, 0, 2).reshape(4, -1)
    c = cand_planar.permute(1, 0, 2).reshape(4, -1)
    n = c.shape[1]
    cvalid = c[3] > 0.5
    use = _query_use(q_planar)
    at = torch.arange(n, device=c.device)
    d2_out, pos_out = [], []
    step = max(1, _CHUNK_ELEMS // max(n, 1))
    for s in range(0, q.shape[1], step):
        qs = torch.where(use[s:s + step], q[:3, s:s + step], 0.0)
        d = [qs[i][:, None] - c[i][None, :] for i in range(3)]
        approx = torch.where(cvalid, d[0] * d[0] + d[1] * d[1] + d[2] * d[2],
                             torch.inf)
        lo = approx.amin(dim=1, keepdim=True)
        # The pinned d2 where the plain sum is near the smallest (every
        # candidate of a query whose candidates are all invalid: +inf).
        near = approx <= lo * (1.0 + _NN_BAND) + 1e-30
        exact = torch.full_like(approx, torch.inf)
        idx = (near & cvalid).nonzero(as_tuple=True)
        dx, dy, dz = (a[idx] for a in d)
        exact[idx] = fma_f32(dz, dz, fma_f32(dx, dx, dy * dy))
        best = exact.amin(dim=1)
        # Ties (and the all-invalid case) to the last position.
        tie = exact == best[:, None]
        d2_out.append(best)
        pos_out.append(torch.where(tie, at, -1).amax(dim=1))
    d2 = torch.cat(d2_out)
    pos = torch.cat(pos_out).to(torch.float32)
    return torch.where(use, d2, torch.inf), torch.where(use, pos, -1.0)


def nn_argmin(q_planar, cand_planar):
    """For every query, the exact squared distance to its nearest valid
    candidate and that candidate's flat position.

    q_planar f32[QB, 4, 128], cand_planar f32[NR, 4, 128] (w channels =
    validity). Returns (d2 f32[QB*128], position f32[QB*128]): d2 pinned to
    fma(dz, dz, fma(dx, dx, dy*dy)), +inf with no valid candidate; among
    equal d2 the LAST position (with no valid candidate, the last of the
    target); a query with w <= 0.5 or a non-finite coordinate gets (+inf,
    -1).

    Replaces `pallas_kernels.nn_argmin` (csrc/nn.cu)."""
    nr, qb = _check_brute("nn_argmin", q_planar, cand_planar)
    if not _on_cuda(cand_planar):
        return nn_argmin_plain(q_planar, cand_planar)
    _check_aligned16("nn_argmin.cand", cand_planar)
    dev = cand_planar.device
    out = torch.empty((2, qb * 128), dtype=torch.float32, device=dev)
    # Keys all-ones: int64 -1.
    keys, arrived = _block_scratch("nn_argmin", dev, qb, torch.int64, -1)
    _lib().call("pc_nn_argmin", q_planar.data_ptr(), cand_planar.data_ptr(),
                out.data_ptr(), qb, nr, keys.data_ptr(), arrived.data_ptr(),
                _stream())
    LAUNCHES["nn_argmin"] += 1
    return out[0], out[1]


# ── 16. One min-label hop over the windows (the cluster hop loop) ──────────

# Label of an invalid query in a block that runs (the reference's 2^25).
HOP_BIGLAB = 1 << 25


def _hop_rows(starts, pad_row: int):
    """[NB, 9 * wr] rows [start, start + length) of each block's windows
    (the reference's hop reads no skip: a candidate read twice cannot lower
    a minimum twice), ``pad_row`` past a window's length and for blocks
    that do not run (no valid query, or not active). A host read: plain
    versions only."""
    nb = starts.shape[0]
    run = (starts[:, 27] != 0) & (starts[:, 28] != 0)
    ln = starts[:, 18:27, None].long()
    wr = max(int(ln.max()) if nb else 0, 1)
    r = torch.arange(wr, device=starts.device)
    keep = (r < ln) & run[:, None, None]
    rows = starts[:, :9, None].long() + r
    return torch.where(keep, rows, pad_row).reshape(nb, 9 * wr), run


def cluster_propagate_plain(pts_planar, labels, starts, r2):
    nr, nb = pts_planar.shape[0], starts.shape[0]
    dev = pts_planar.device
    rows, run = _hop_rows(starts, nr)
    pts = _with_pad_row(pts_planar)
    labx = torch.cat([labels, torch.full((128,), HOP_BIGLAB,
                                         dtype=torch.int32, device=dev)])
    labx = labx.reshape(nr + 1, 128)
    qlab = labels[: nb * 128]
    best = []
    for rs, qs, cand in _block_cands(pts[:nb], pts, rows):
        pair = (qs[:, 3, :, None] > 0.5) & (cand[:, 3, None, :] > 0.5)
        clab = labx[rs].reshape(rs.shape[0], 1, -1)
        best.append(torch.where(pair & _within_r2(qs, cand, r2), clab,
                                HOP_BIGLAB).amin(-1).reshape(-1))
    qm = pts_planar[:nb, 3, :].reshape(-1) > 0.5
    hop = torch.where(qm, torch.minimum(torch.cat(best), qlab), HOP_BIGLAB)
    runq = run.repeat_interleave(128)
    changed = runq & qm & (hop < qlab)
    return torch.where(runq, hop, qlab), changed.to(torch.int32)


def cluster_propagate(pts_planar, labels, starts, r2):
    """One min-label hop over each 128-query block's nine sorted windows:
    every valid query of a block that runs takes the smallest label among
    its own and those of the valid candidates within ``r2`` (inclusive, d2
    pinned to fma(dz, dz, fma(dx, dx, dy*dy))).

    pts_planar f32[NR, 4, 128] (w = validity); labels i32[NR*128], every
    planar row's current label (exact below 2^24); starts i32[NB, 29]: the
    `_window_starts` pack plus a per-block ACTIVE column (blocks without a
    valid query or not active pass their labels through); r2 the squared
    radius. Returns (labels i32[NB*128], changed i32[NB*128]): an invalid
    query of a running block gets `HOP_BIGLAB`; changed = 1 where a valid
    query's label decreased.

    Replaces `pallas_kernels.cluster_propagate` (csrc/propagate.cu)."""
    nr, nb = pts_planar.shape[0], starts.shape[0]
    dev = pts_planar.device
    _check("cluster_propagate.pts", pts_planar, torch.float32, (nr, 4, 128))
    _check("cluster_propagate.labels", labels, torch.int32, (nr * 128,), dev)
    _check("cluster_propagate.starts", starts, torch.int32, (nb, 29), dev)
    if nb > nr:
        raise ValueError("cluster_propagate: more blocks than planar rows")
    r2 = float(np.float32(r2))
    if not _on_cuda(pts_planar):
        return cluster_propagate_plain(pts_planar, labels, starts, r2)
    _check_aligned16("cluster_propagate.pts", pts_planar)
    _check_aligned16("cluster_propagate.labels", labels)
    out = torch.empty((2, nb * 128), dtype=torch.int32, device=dev)
    _lib().call("pc_cluster_propagate", pts_planar.data_ptr(),
                labels.data_ptr(), starts.data_ptr(), out.data_ptr(), nb, r2,
                _stream())
    LAUNCHES["cluster_propagate"] += 1
    return out[0], out[1]


# ── 17. Per-cell k+1 smallest over the 27-cell slab (cell-grid SOR) ────────


def sor_select_plain(q, qm, cand, cv, *, k: int):
    c, _, m = q.shape
    ncand = cand.shape[1]
    out = torch.zeros((3, c, m), dtype=torch.float32, device=q.device)
    # Only cells with a valid query have anything to select (a host read).
    cells = qm.any(dim=1).nonzero(as_tuple=True)[0]
    step = max(1, _CHUNK_ELEMS // max(m * ncand, 1))
    for s in range(0, cells.numel(), step):
        at = cells[s:s + step]
        qs, cs = q[at], cand[at]
        d = [cs[:, None, :, i] - qs[:, i, :, None] for i in range(3)]
        d2 = fma_f32(d[2], d[2], fma_f32(d[0], d[0], d[1] * d[1]))
        pair = qm[at][:, :, None] & cv[at][:, None, :]
        out[:, at] = torch.stack(_topk_stats(
            torch.where(pair, d2, torch.inf), k + 1))
    return out[0], out[1].to(torch.int32), out[2]


def sor_select(q, qm, cand, cv, *, k: int):
    """Per cell, the k+1 smallest squared distances of each of its queries
    to the valid candidates of its gathered slab (d2 pinned to fma(dz, dz,
    fma(dx, dx, dy*dy)), the Pallas kernel's form on the CPU).

    q f32[C, 3, M] planar cell query blocks, qm bool[C, M], cand f32[C,
    CAND, 3] candidate slabs, cv bool[C, CAND]. Returns (total f32[C, M]
    sum of the square roots, added in ascending order; count i32[C, M];
    kth f32[C, M] the last extracted d2, 0 if none).

    Replaces `pallas_kernels.sor_select` (csrc/cellsel.cu)."""
    c, _, m = q.shape
    ncand = cand.shape[1]
    dev = q.device
    _check("sor_select.q", q, torch.float32, (c, 3, m))
    _check("sor_select.qm", qm, torch.bool, (c, m), dev)
    _check("sor_select.cand", cand, torch.float32, (c, ncand, 3), dev)
    _check("sor_select.cv", cv, torch.bool, (c, ncand), dev)
    if not _on_cuda(q):
        return sor_select_plain(q, qm, cand, cv, k=k)
    _check_k(k + 1)
    if ncand >= 1 << 16:
        raise ValueError(f"sor_select: {ncand} candidate slots a cell; the "
                         "kernel indexes at most 65,535")
    total = torch.empty((c, m), dtype=torch.float32, device=dev)
    count = torch.empty((c, m), dtype=torch.int32, device=dev)
    kth = torch.empty((c, m), dtype=torch.float32, device=dev)
    _lib().call("pc_sor_select", q.data_ptr(), qm.data_ptr(), cand.data_ptr(),
                cv.data_ptr(), total.data_ptr(), count.data_ptr(),
                kth.data_ptr(), c, m, ncand, k + 1, _stream())
    LAUNCHES["sor_select"] += 1
    return total, count, kth


# ── 18. k smallest of each work row (cell-grid SOR, point-centric) ─────────


def segmented_select_plain(work, *, k: int):
    total, count, kth = _topk_stats(work, k)
    return total, count, kth, torch.ones_like(total, dtype=torch.bool)


def segmented_select(work, *, k: int):
    """The k smallest finite values of each row of ``work`` f32[Q, W]
    (squared distances, +inf where masked): (total f32[Q] sum of their
    square roots, added in ascending order; count f32[Q]; kth f32[Q] the
    last of them, 0 if none; ok bool[Q], always True: the selection is
    exact, so it certifies every row the reference's segment certificate
    does, with equal values).

    Replaces `pallas_kernels.segmented_select` (csrc/cellsel.cu)."""
    q, w = work.shape
    _check("segmented_select.work", work, torch.float32, (q, w))
    if not _on_cuda(work):
        return segmented_select_plain(work, k=k)
    _check_k(k)
    out = torch.empty((4, q), dtype=torch.float32, device=work.device)
    _lib().call("pc_segmented_select", work.data_ptr(), out.data_ptr(), q, w,
                k, _stream())
    LAUNCHES["segmented_select"] += 1
    return out[0], out[1], out[2], out[3] > 0.5


# ── 19. RANSAC plane hypotheses ─────────────────────────────────────────────


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


def ransac_hypotheses_plain(xyz, cnt, seed: int, iterations: int,
                            order=None):
    """The torch version: the threefry draw, the triples, one gather and
    the planes as whole-tensor operations (~380 on the card)."""
    samples = _sample_three_distinct(seed, iterations, cnt)
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
    return normal, d, degenerate


def ransac_hypotheses(xyz, cnt, seed: int, iterations: int, order=None):
    """RANSAC's plane hypotheses, the JAX package's bit for bit: for
    hypothesis t, three distinct sample positions drawn from
    ``jax.random.bits(PRNGKey(seed), (3, iterations))[:, t]`` modulo the
    valid count ``cnt`` (int64 0-d, read on the device; at least 3), mapped
    to rows by ``order`` int64[N] (None: position p is row p), and the plane
    through the three points of ``xyz`` f32[N, 3] in the pinned f32 forms.

    Returns (normal f32[I, 3], d f32[I], degenerate bool[I]): a triple
    whose cross product is shorter than 1e-10 is degenerate and keeps its
    unnormalised cross product as the normal. A NaN point gives NaNs.

    Replaces no Pallas kernel: the XLA code of the JAX package's
    `ransac_plane_masked` (csrc/ransac.cu)."""
    n = xyz.shape[0]
    dev = xyz.device
    _check("ransac_hypotheses.xyz", xyz, torch.float32, (n, 3))
    _check("ransac_hypotheses.cnt", cnt, torch.int64, (), dev)
    if order is not None:
        _check("ransac_hypotheses.order", order, torch.int64, (n,), dev)
    if n < 3:
        raise ValueError(f"ransac_hypotheses: {n} rows; a triple needs 3")
    if not _on_cuda(xyz):
        return ransac_hypotheses_plain(xyz, cnt, seed, iterations, order)
    k1, k2 = prng_key(seed)
    # One allocation: normal, d, then the flags' bytes.
    out = torch.empty(4 * iterations + -(-iterations // 4),
                      dtype=torch.float32, device=dev)
    _lib().call("pc_ransac_hypotheses", xyz.data_ptr(), cnt.data_ptr(),
                None if order is None else order.data_ptr(), out.data_ptr(),
                iterations, k1, k2, _stream())
    LAUNCHES["ransac_hypotheses"] += 1
    return (out[:3 * iterations].view(iterations, 3),
            out[3 * iterations:4 * iterations],
            out[4 * iterations:].view(torch.bool)[:iterations])
