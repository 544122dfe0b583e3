"""The port's hand-written CUDA kernels, each beside its plain torch version.

Counterparts of the four Pallas kernels on the KITTI pipeline's path
(`pointclouds_tpu/spatial/pallas_kernels.py`). Each wrapper checks its
inputs, runs the plain version for CPU tensors, and for CUDA tensors
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

import torch

LAUNCHES = {
    "segmented_scan_sums": 0,
    "sweep_select_rows": 0,
    "rescue_select": 0,
    "cluster_multisweep": 0,
}

# Blocks that share one rescue query block's group list (csrc/select.cu).
_RESCUE_SPLIT = 16
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
    ins = [torch.nn.functional.pad(a, (0, total - n)).contiguous()
           for a in (first, x, y, z, c)]
    scratch = torch.empty((2, 5, total), dtype=torch.float32,
                          device=first.device)
    out = torch.empty((4, total), dtype=torch.float32, device=first.device)
    _lib().call("pc_segscan5", *[a.data_ptr() for a in ins],
                scratch.data_ptr(), out.data_ptr(), total, tl, _stream())
    LAUNCHES["segmented_scan_sums"] += 1
    return tuple(out[i, :n] for i in range(4))


# ── 2./3. Exact k-smallest selection (SOR passes 1 and 2) ──────────────────


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
            fin[..., j], torch.sqrt(torch.clamp(vals[..., j], min=0.0)), 0.0
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
    out = s.to(torch.float32)
    if bool(half.any()):  # rare: fix up only those elements
        idx = half.nonzero(as_tuple=True)
        ps, cs, ss = p[idx], c[idx], s[idx]
        bb = ss - ps
        err = (ps - (ss - bb)) + (cs - bb)
        toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
        fixed = torch.where(err != 0, torch.nextafter(ss, toward), ss)
        out[idx] = fixed.to(torch.float32)
    return out


def _d2(qx, qy, qz, cx, cy, cz):
    """[B, 128, C] squared distances, contracted as the kernels (and XLA's
    CPU backend) compute them: fma(dz, dz, fma(dx, dx, dy*dy))."""
    dx = qx[:, :, None] - cx[:, None, :]
    dy = qy[:, :, None] - cy[:, None, :]
    dz = qz[:, :, None] - cz[:, None, :]
    return fma_f32(dz, dz, fma_f32(dx, dx, dy * dy))


def _block_pairs(q, pts, rows):
    """Chunks of query blocks against their candidate rows: yields (rows
    [B, R], d2 [B, 128, R*128], both-valid mask) for q [NB, 4, 128]
    and rows [NB, R] ids into ``pts`` (w channel = validity)."""
    nb, r = rows.shape
    step = max(1, _CHUNK_ELEMS // (128 * 128 * max(r, 1)))
    for s in range(0, nb, step):
        rs = rows[s:s + step]
        cand = pts[rs]  # [B, R, 4, 128]
        b = cand.shape[0]

        def ch(i):
            return cand[:, :, i, :].reshape(b, r * 128)

        qs = q[s:s + b]
        d2 = _d2(qs[:, 0], qs[:, 1], qs[:, 2], ch(0), ch(1), ch(2))
        pair = (qs[:, 3, :, None] > 0.5) & (ch(3)[:, None, :] > 0.5)
        yield rs, d2, pair


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
    out = torch.empty((4, nb * 128), dtype=torch.float32, device=dev)
    _lib().call("pc_sweep_select_rows", pts_padded.data_ptr(),
                rowlist.data_ptr(), out.data_ptr(), nb, cap, k, _stream())
    LAUNCHES["sweep_select_rows"] += 1
    return out[0], out[1], out[2], out[3] > 0.5


def rescue_select_plain(cand_planar, q_planar, active, *, k: int, gr: int):
    nr = cand_planar.shape[0]
    # Slots past a block's group count read an all-masked pad row at nr.
    pts = torch.cat([cand_planar, torch.zeros((1, 4, 128),
                                              device=cand_planar.device)])
    cnt = torch.where(q_planar[:, 3, :].amax(dim=1) > 0.5, active[:, 0], 0)
    g = int(cnt.max()) if active.shape[0] else 0
    slot = torch.arange(g * gr, device=active.device)
    groups = active[:, 1:1 + g].long().repeat_interleave(gr, dim=1)
    rows = torch.where(slot[None, :] < cnt[:, None] * gr,
                       groups * gr + slot % gr, nr)
    return _select_rows_plain(q_planar, pts, rows, k)


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
    out = torch.empty((4, qb * 128), dtype=torch.float32, device=dev)
    part = torch.empty((_RESCUE_SPLIT, k, qb * 128), dtype=torch.float32,
                       device=dev)
    _lib().call("pc_rescue_select", cand_planar.data_ptr(),
                q_planar.data_ptr(), active.data_ptr(), part.data_ptr(),
                out.data_ptr(), qb, 1 + nr // gr, gr, k, _RESCUE_SPLIT,
                _stream())
    LAUNCHES["rescue_select"] += 1
    return out[0], out[1], out[2], out[3] > 0.5


# ── 4. Cluster min-label propagation ────────────────────────────────────────


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
    for rs, d2, pair in _block_pairs(pts, pts, rows):
        clab = lab2[rs].reshape(rs.shape[0], 1, r * 128)
        hops.append(torch.where(pair & (d2 <= r2), clab, big)
                    .amin(-1).reshape(-1))
    m = torch.minimum(torch.cat(hops), lab[:nq])
    new = lab.clone()
    new[:nq] = m
    new.scatter_reduce_(0, lab[:nq].long(), m, reduce="amin")
    for _ in range(2):
        new = torch.minimum(new, new[new.long()])
    return new, (new[:nq] != lab[:nq]).to(torch.int32)


def cluster_multisweep_plain(pts_planar, rowlist, r2, *, cap: int,
                             max_rounds: int):
    nr = pts_planar.shape[0]
    nb = rowlist.shape[0]
    pts = _cluster_pad(pts_planar)
    lab = torch.arange((nr + 1) * 128, dtype=torch.int32,
                       device=pts_planar.device)
    changed = torch.zeros(nb * 128, dtype=torch.int32,
                          device=pts_planar.device)
    rows = _list_rows(rowlist, cap, nr)
    rounds = 0
    while rounds < max_rounds:
        lab, changed = _cluster_round_plain(pts, rows, lab, r2)
        rounds += 1
        if not bool(changed.any()):  # host sync: convergence test
            break
    return lab[: nb * 128], changed, rounds


def cluster_multisweep(pts_planar, rowlist, r2, *, cap: int,
                       max_rounds: int = 64):
    """Connected-component labels over the per-block row lists.

    pts_planar f32[NR, 4, 128]; rowlist i32[NB, cap + 2] with pad slots =
    NR; r2 the squared radius (inclusive). Runs propagation rounds until
    one changes nothing, at most ``max_rounds``. Returns (labels i32[NB*128]
    in sorted order: each valid row gets the smallest sorted position of
    its component, invalid rows their own; changed i32[NB*128], the last
    round's flags -- all zero iff converged; rounds run).

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
        return cluster_multisweep_plain(pts_planar, rowlist, r2, cap=cap,
                                        max_rounds=max_rounds)
    pts = _cluster_pad(pts_planar)
    lab = torch.arange((nr + 1) * 128, dtype=torch.int32, device=dev)
    changed = torch.zeros(nb * 128, dtype=torch.int32, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _lib()
    rounds = 0
    while rounds < max_rounds:
        lib.call("pc_cluster_round", pts.data_ptr(), rowlist.data_ptr(),
                 lab.data_ptr(), changed.data_ptr(), counter.data_ptr(), nb,
                 cap, r2, _stream())
        LAUNCHES["cluster_multisweep"] += 1
        rounds += 1
        if int(counter.item()) == 0:  # host sync: convergence test
            break
    return lab[: nb * 128], changed, rounds
