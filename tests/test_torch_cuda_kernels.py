"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU with nvcc (the kernels build at first use)
and skip without one. They import no JAX, so they also run where JAX is
not installed; from the repository root:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

import pointclouds_tpu_torch as port
from pointclouds_tpu_torch.pipelines.aerial import extract_clusters
from pointclouds_tpu_torch.pipelines.scenes import aerial_scene, kitti_scene
from pointclouds_tpu_torch.spatial import kernels, sweep
from pointclouds_tpu_torch.utils import profiling

from _hypotheses import assert_same_bits, hypothesis_cloud, position_map

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _planar(rng, nr, frac_valid=0.9, scale=5.0):
    p = rng.random((nr, 4, 128)).astype(np.float32) * scale
    p[:, 3] = rng.random((nr, 128)) < frac_valid
    p[:, :3] *= p[:, 3:4]
    return torch.from_numpy(p)


@pytest.mark.parametrize("n,starts", [
    (128, "random"), (640, "random"), (2 * 512 * 128 + 384, "random"),
    (10_112, "random"), (1 << 20, "random"), (1 << 20, "one"),
    (3 * 512 * 128 + 77, "every")])
def test_segmented_scan_sums(dev, n, starts):
    """Bitwise against the plain version: one tile of 79 rows (10,112, not
    a power of two), a tile shorter than the pass-A span (640), 16 tiles
    (1M), a segment spanning every tile ("one": a start at 0 only), and a
    start at every element."""
    rng = np.random.default_rng(n)
    first = (rng.random(n) < 0.3).astype(np.float32)
    if starts == "one":
        first[:] = 0.0
    if starts == "every":
        first[:] = 1.0
    first[0] = 1.0
    vals = [rng.normal(size=n).astype(np.float32) for _ in range(3)]
    vals[0][rng.random(n) < 0.05] = -0.0
    args = [torch.from_numpy(a).to(dev) for a in
            (first, *vals, np.ones(n, np.float32))]
    got = _count_launch("segmented_scan_sums",
                        lambda: kernels.segmented_scan_sums(*args))
    want = kernels.segmented_scan_sums_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def _select_planar(rng, nr, case):
    """Planar rows for the selection kernels: "dup" puts the points on a
    0.5 m lattice (many exact duplicates, so d2 = 0 and equal d2 values
    tie at the kth), "few" leaves ~0.4% of them valid (fewer than k valid
    candidates per query)."""
    if case == "few":
        return _planar(rng, nr, frac_valid=0.004)
    p = _planar(rng, nr)
    if case == "dup":
        p[:, :3] = torch.round(p[:, :3] * 2.0) / 2.0 * p[:, 3:4]
    return p


# (case, cap): random rows, duplicate points, few valid candidates, and
# the largest row list (cap 32) of random rows.
SELECT_ROWS_CASES = [("random", 12), ("dup", 12), ("few", 12),
                     ("random", 32)]


@pytest.mark.parametrize("case,cap", SELECT_ROWS_CASES)
@pytest.mark.parametrize("k", [1, 11, 21, 32])
def test_sweep_select_rows(dev, k, case, cap):
    rng = np.random.default_rng(k)
    nb = 40
    pts = torch.cat([_select_planar(rng, nb, case),
                     torch.zeros((1, 4, 128))]).to(dev)
    pts[nb, :3] = 1e9
    n_rows = rng.integers(0, cap + 1, nb)
    n_rows[0] = cap  # one full list
    rows = rng.integers(0, nb, (nb, cap))
    rows[np.arange(cap)[None, :] >= n_rows[:, None]] = nb
    rl = np.concatenate([rows, (rng.random((nb, 1)) < 0.9),
                         n_rows[:, None]], axis=1).astype(np.int32)
    rl = torch.from_numpy(rl).to(dev)
    before = kernels.LAUNCHES["sweep_select_rows"]
    got = kernels.sweep_select_rows(pts, rl, k=k, cap=cap)
    assert kernels.LAUNCHES["sweep_select_rows"] == before + 1
    want = kernels.sweep_select_rows_plain(pts, rl, k=k, cap=cap)
    assert bool(got[3].all())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["random", "unbalanced", "dup", "few"])
@pytest.mark.parametrize("k", [1, 11, 21, 32])
def test_rescue_select(dev, k, case):
    """Every case has an all-invalid query block (the last); "unbalanced"
    gives block 0 every group and the others 0-2 of them."""
    rng = np.random.default_rng(k)
    nr, qb, gr = 64, 5, 8
    cand = _select_planar(rng, nr, case).to(dev)
    q = _select_planar(rng, qb, "dup" if case == "dup" else "random").to(dev)
    q[qb - 1, 3] = 0.0
    ng = nr // gr
    act = np.full((qb, 1 + ng), 12345, np.int32)  # garbage past the count
    for b in range(qb):
        n = rng.integers(0, ng + 1)
        if case == "unbalanced":
            n = ng if b == 0 else rng.integers(0, 3)
        g = np.sort(rng.choice(ng, n, replace=False))
        act[b, 0] = len(g)
        act[b, 1:1 + len(g)] = g
    act = torch.from_numpy(act).to(dev)
    before = kernels.LAUNCHES["rescue_select"]
    got = kernels.rescue_select(cand, q, act, k=k, gr=gr)
    assert kernels.LAUNCHES["rescue_select"] == before + 1
    want = kernels.rescue_select_plain(cand, q, act, k=k, gr=gr)
    assert bool(got[3].all())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("gr", [4, 16])
def test_rescue_select_group_height(dev, gr):
    """Groups of another height than the staging tile (8 rows)."""
    rng = np.random.default_rng(gr)
    nr, qb = 64, 3
    cand = _select_planar(rng, nr, "dup").to(dev)
    q = _select_planar(rng, qb, "random").to(dev)
    act = np.zeros((qb, 1 + nr // gr), np.int32)
    for b in range(qb):
        g = np.sort(rng.choice(nr // gr, rng.integers(1, nr // gr + 1),
                               replace=False))
        act[b, 0] = len(g)
        act[b, 1:1 + len(g)] = g
    act = torch.from_numpy(act).to(dev)
    got = kernels.rescue_select(cand, q, act, k=21, gr=gr)
    want = kernels.rescue_select_plain(cand, q, act, k=21, gr=gr)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_select_misaligned_raises(dev):
    """The warp-select kernels (2, 3, 6, 7, 13) stage rows with 16-byte copies:
    a tensor whose data starts off that boundary raises instead of being
    copied."""
    flat = torch.zeros(9 * 4 * 128 + 1, device=dev)
    pts = flat[1:].view(9, 4, 128)
    rl = torch.zeros((8, 14), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.sweep_select_rows(pts, rl, k=5, cap=12)
    act = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.rescue_select(pts[:8], pts[8:], act, k=5, gr=8)
    starts = torch.zeros((8, 28), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.sweep_moments(pts, starts, k=5)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.rescue_knn_idx(pts[:8], pts[8:].contiguous(), act, k=5, gr=8)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.brute_knn_idx(pts[8:].contiguous(), pts[:8], k=5)


def test_sweep_cluster_labels_gpu_equals_cpu(dev):
    data = kitti_scene(seed=5, scale=0.05)
    xyz = np.zeros((4096, 3), np.float32)
    xyz[: len(data)] = data
    valid = np.zeros(4096, bool)
    valid[: len(data)] = True
    args = dict(wr=12, row_cap=32)
    lab_c, ex_c = sweep.sweep_cluster_labels(
        torch.from_numpy(xyz), torch.from_numpy(valid), np.float32(0.8),
        **args)
    lab_g, ex_g = sweep.sweep_cluster_labels(
        torch.from_numpy(xyz).to(dev), torch.from_numpy(valid).to(dev),
        np.float32(0.8), **args)
    assert bool(ex_c) and bool(ex_g)
    assert torch.equal(lab_g.cpu(), lab_c)


def _count_launch(name, fn):
    before = kernels.LAUNCHES[name]
    out = fn()
    assert kernels.LAUNCHES[name] > before
    return out


def _structure(dev, seed=0, n=4096, wr=4, cell=1.3, lattice=False):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    if lattice:  # a 0.5 m lattice: duplicates and equal d2
        xyz = np.round(xyz * 2.0) / np.float32(2.0)
    valid = rng.random(n) > 0.1
    xyz[~valid & (rng.random(n) > 0.5)] = np.nan
    return sweep._sorted_structure(
        torch.from_numpy(xyz).to(dev), torch.from_numpy(valid).to(dev),
        torch.tensor(np.float32(cell), device=dev), wr,
        sweep.SWEEP_TABLE_SIZE)


def _window_starts(rng, nb, nr, span=6, lo=0):
    """A starts pack with random windows from row ``lo`` on: overlapping
    (the same rows in two windows), skips inside and past a window's
    length, empty windows, and a block whose flag is 0."""
    st = rng.integers(lo, nr - span, (nb, 9))
    ln = rng.integers(0, span + 1, (nb, 9))
    sk = rng.integers(0, span + 2, (nb, 9))
    sk[rng.random((nb, 9)) < 0.5] = 0
    flag = np.ones((nb, 1), np.int64)
    flag[nb - 1] = 0
    return np.concatenate([st, sk, ln, flag], axis=1).astype(np.int32)


def _edge_offset(qc, edge):
    """A candidate coordinate c near ``qc`` with f32 (qc - c)^2 == edge
    exactly (the d2 of a candidate shifted along one axis), or None."""
    qc = np.float32(qc)
    c = np.float32(qc - np.float32(np.sqrt(np.float64(edge))))
    for _ in range(64):
        d = np.float32(qc - c)
        sq = np.float32(d * d)
        if sq == edge:
            return c
        c = np.nextafter(c, np.float32(np.inf if sq > edge else -np.inf))
    return None


def _band_edges(planar, starts, k):
    """Put two candidates exactly on one query's band edges, d2 = kth *
    f32(1 + D2_BAND) and kth * f32(1 + 3 D2_BAND), into masked slots of
    rows of its windows (each shifted from the query along one axis). The
    query has k candidates at or below its kth (lattice d2), so neither
    changes its count or kth. Returns whether both were placed."""
    want = kernels.sweep_moments_plain(planar, starts, k=k)
    rows = kernels._window_rows(starts, planar.shape[0])
    bands = [np.float32(1.0 + kernels.D2_BAND),
             np.float32(1.0 + 3.0 * kernels.D2_BAND)]
    for col in ((want[10] == k) & (want[11] > 0)).nonzero().flatten():
        b, lane = divmod(int(col), 128)
        free = [(int(r), int(j)) for r in rows[b] if r < planar.shape[0]
                for j in (planar[r, 3] <= 0.5).nonzero().flatten()]
        q = planar[b, :3, lane].numpy()
        kth = np.float32(want[11, col])
        shifts = [next(((a, c) for a in range(3) if (c := _edge_offset(
            q[a], np.float32(kth * band))) is not None), None)
            for band in bands]
        if len(free) < 2 or None in shifts:
            continue
        for (row, slot), (a, c) in zip(free, shifts):
            planar[row, :3, slot] = torch.from_numpy(q)
            planar[row, a, slot] = float(c)
            planar[row, 3, slot] = 1.0
        return True
    return False


@pytest.mark.parametrize("case", ["random", "dup", "few", "windows"])
@pytest.mark.parametrize("k", [1, 5, 15, 32])
def test_sweep_moments(dev, k, case):
    """"dup": lattice points (ties at the kth) and, for k > 1, two
    candidates exactly on one query's band edges; "windows": random rows
    under random, overlapping and skipped windows; "few": the same over
    rows with ~0.4% of their points valid (fewer than k candidates for
    most valid queries)."""
    if case in ("windows", "few"):
        rng = np.random.default_rng(k)
        nb, nr = 12, 40
        planar = _select_planar(rng, nr, "dup" if case == "windows" else
                                "few")
        lo = 0
        if case == "few":  # valid queries; their windows past them
            planar[:nb] = _planar(rng, nb)
            lo = nb
        starts = torch.from_numpy(_window_starts(rng, nb, nr, lo=lo))
    else:
        s = _structure(torch.device("cpu"), lattice=case == "dup")
        planar, starts = s["planar"].clone(), s["starts_skip"]
    if case == "dup" and k > 1:  # at k 1 the kth is the query: d2 0
        assert _band_edges(planar, starts, k)
    planar, starts = planar.to(dev), starts.to(dev)
    got = _count_launch("sweep_moments", lambda: kernels.sweep_moments(
        planar, starts, k=k))
    want = kernels.sweep_moments_plain(planar, starts, k=k)
    assert torch.equal(got, want)  # the same adds in the same order
    if case == "few":
        qv = planar[:starts.shape[0], 3].reshape(-1) > 0.5
        few = got[10][qv] < k
        assert few.all() if k >= 15 else few.any()
    else:
        assert (got[10] == k).float().mean() > 0.5
    if case == "dup":
        assert (got[9] > got[10]).any()  # ties at the kth, the band edges


def _active_groups(rng, qb, ng, case):
    """[qb, 1 + ng] active lists (garbage past the count): "unbalanced"
    gives block 0 every group and the others 0-2."""
    act = np.full((qb, 1 + ng), 12345, np.int32)
    for b in range(qb):
        n = rng.integers(0, ng + 1)
        if case == "unbalanced":
            n = ng if b == 0 else rng.integers(0, 3)
        g = np.sort(rng.choice(ng, n, replace=False))
        act[b, 0] = len(g)
        act[b, 1:1 + len(g)] = g
    return torch.from_numpy(act)


@pytest.mark.parametrize("case", ["random", "unbalanced", "dup", "few"])
@pytest.mark.parametrize("k", [1, 10, 15, 32])
def test_rescue_knn_idx(dev, k, case):
    """Every case has an all-invalid query block (the last). "dup": lattice
    points, so equal d2 straddle the kth at positions in different rows,
    tiles and slices of the walk; the positions must be the smallest."""
    rng = np.random.default_rng(k)
    nr, qb, gr = 64, 5, 8
    cand = _select_planar(rng, nr, case).to(dev)
    q = _select_planar(rng, qb, "dup" if case == "dup" else "random").to(dev)
    q[qb - 1, 3] = 0.0
    act = _active_groups(rng, qb, nr // gr, case).to(dev)
    got = _count_launch("rescue_knn_idx", lambda: kernels.rescue_knn_idx(
        cand, q, act, k=k, gr=gr))
    want = kernels.rescue_knn_idx_plain(cand, q, act, k=k, gr=gr)
    assert torch.equal(got, want)
    assert (got[2 * k + 2] == 1.0).all()
    assert (got[2 * k, (qb - 1) * 128:] == 0).all()


@pytest.mark.parametrize("gr", [4, 16])
def test_rescue_knn_idx_group_height(dev, gr):
    """Groups of another height than the staging tile (8 rows)."""
    rng = np.random.default_rng(gr)
    nr, qb = 64, 3
    cand = _select_planar(rng, nr, "dup").to(dev)
    q = _select_planar(rng, qb, "random").to(dev)
    act = _active_groups(rng, qb, nr // gr, "random").to(dev)
    got = kernels.rescue_knn_idx(cand, q, act, k=15, gr=gr)
    want = kernels.rescue_knn_idx_plain(cand, q, act, k=15, gr=gr)
    assert torch.equal(got, want)


def test_cluster_multisweep_windows(dev):
    s = _structure(dev, seed=2, n=4096, wr=12, cell=0.4)
    r2 = float(np.float32(0.4) * np.float32(0.4))
    got = _count_launch("cluster_multisweep_windows",
                        lambda: kernels.cluster_multisweep_windows(
                            s["planar"], s["starts_skip"], r2,
                            max_rounds=64))
    want = kernels.cluster_multisweep_windows_plain(
        s["planar"], s["starts_skip"], r2, max_rounds=64)
    assert not got[1].any() and not want[1].any()
    assert torch.equal(got[0], want[0])
    cut = kernels.cluster_multisweep_windows(s["planar"], s["starts_skip"],
                                             r2, max_rounds=1)
    resumed = kernels.cluster_multisweep_windows(
        s["planar"], s["starts_skip"], r2, max_rounds=64, labels0=cut[0])
    assert torch.equal(resumed[0], want[0])


def test_aerial_pipeline_gpu_equals_cpu(dev):
    data = aerial_scene(seed=3, scale=0.05)
    args = (np.float32(0.5), np.float32(12.0), np.float32(0.3), 0,
            np.float32(2.0), [0.0, 0.0, 10000.0])
    outs = []
    for d in ("cpu", dev):
        c = port.make_cloud_arrays(data, device=d)
        outs.append(port.aerial_pipeline(c.xyz, c.valid, *args))
    cpu, gpu = outs
    assert torch.equal(gpu.centroids.cpu(), cpu.centroids)
    assert torch.equal(gpu.normals_ok.cpu(), cpu.normals_ok)
    assert bool(gpu.cluster_exact) and bool(cpu.cluster_exact)
    assert extract_clusters(gpu, 20, 100_000) == extract_clusters(cpu, 20,
                                                                  100_000)


@pytest.mark.parametrize("case", ["structure", "windows"])
@pytest.mark.parametrize("k", [1, 11, 21, 32])
def test_sweep_select(dev, k, case):
    """"structure": the sorted structure of a uniform cloud (dedup skips
    from the structure); "windows": `_knn_windows_case`'s lattice rows
    (ties at d2 0) under random windows with nonzero skips, more planar
    rows than blocks, a block whose flag is 0 and a block with no valid
    query, both written as total 0, count 0, kth 0, ok 1."""
    if case == "structure":
        s = _structure(dev, seed=3, wr=6, cell=0.9)
        planar, starts = s["planar"], s["starts_skip"]
    else:
        planar, starts = (a.to(dev) for a in _knn_windows_case(case))
    before = kernels.LAUNCHES["sweep_select"]
    got = kernels.sweep_select(planar, starts, k=k)
    assert kernels.LAUNCHES["sweep_select"] == before + 1
    want = kernels.sweep_select_plain(planar, starts, k=k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[3].all()) and (got[1] == k).float().mean() > 0.5
    if case == "windows":
        nb = starts.shape[0]
        for b in (1, nb - 1):
            cols = slice(b * 128, (b + 1) * 128)
            assert (got[0][cols] == 0).all() and (got[1][cols] == 0).all()
            assert (got[2][cols] == 0).all()


def _device_launches(fn):
    """Device kernels one call of ``fn`` launches (torch.profiler, after a
    warm-up call; a window in which the profiler saw no kernel is taken
    again). The tests that call this stay together: on the H100 (torch
    2.11), when a process's first profiler window came many tests
    earlier, later windows came back empty; grouped, they did not."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.device_type == torch.autograd.DeviceType.CUDA
                for e in prof.events())
        if n:
            return n
    return 0


def _count_within_case(dev, case):
    """Kernel 11's (planar, starts): the sorted structure of a uniform
    cloud with each candidate's r2 0.25, or on every third row the d2 to
    the next sorted point (a pair on its radius); "small_r2": r2 0.04 on
    every candidate, all below the 0.5 validity threshold of the other
    walks; "dup_masked": the structure with one row's second half copied
    onto its first as masked twins (w = 0, d2 0 to a valid point) and one
    query block all invalid; "windows": random rows under random,
    overlapping windows with nonzero skips, block 1 with no valid query
    and the last block's flag 0."""
    if case == "windows":
        rng = np.random.default_rng(13)
        nb, nr = 12, 40
        planar = _planar(rng, nr, scale=2.0)
        planar[:, 3] *= 0.3
        planar[1, 3] = 0.0
        starts = torch.from_numpy(_window_starts(rng, nb, nr))
        assert (starts[:, 9:18] > 0).any()
        return planar.to(dev), starts.to(dev)
    s = _structure(dev, seed=4, wr=4, cell=0.5)
    planar = s["planar"].clone()
    pts = planar[:, :3, :].permute(0, 2, 1).reshape(-1, 3)
    w = planar[:, 3, :].reshape(-1)
    if case == "small_r2":
        r2 = torch.full_like(w, 0.04)
    else:
        nxt = torch.roll(pts, -1, 0)
        d2 = _pinned_d2(pts, nxt)
        r2 = torch.where((torch.arange(len(w), device=dev) % 3 == 0)
                         & (d2 > 0) & (d2 < 0.25), d2, 0.25)
    planar[:, 3, :] = (w * r2).reshape(-1, 128)
    if case == "dup_masked":
        planar[3, :3, :64] = planar[3, :3, 64:]
        planar[3, 3, :64] = 0.0
        planar[5, 3] = 0.0
    return planar, s["starts_skip"]


@pytest.mark.parametrize("case", ["structure", "small_r2", "dup_masked",
                                  "windows"])
def test_count_within(dev, case):
    """Bitwise against the plain version, one launch a call; a block with
    no valid query or with flag 0 counts nothing."""
    planar, starts = _count_within_case(dev, case)
    before = kernels.LAUNCHES["count_within"]
    got = kernels.count_within(planar, starts)
    assert kernels.LAUNCHES["count_within"] == before + 1
    assert torch.equal(got, kernels.count_within_plain(planar, starts))
    assert got.sum() > 0
    assert _device_launches(lambda: kernels.count_within(planar,
                                                         starts)) == 1
    dead = (planar[:starts.shape[0], 3] <= 0).all(dim=1) | (starts[:, 27]
                                                           == 0)
    assert (got.reshape(-1, 128)[dead] == 0).all()
    if case in ("dup_masked", "windows"):
        assert dead.any()


def _groups(rng, qb, ng, dev):
    act = np.full((qb, 1 + ng), 12345, np.int32)  # garbage past the count
    for b in range(qb):
        g = np.sort(rng.choice(ng, rng.integers(0, ng + 1), replace=False))
        act[b, 0] = len(g)
        act[b, 1:1 + len(g)] = g
    return torch.from_numpy(act).to(dev)


def _radius_queries(rng, qb, dev, dead_block=True):
    q = _planar(rng, qb).to(dev)
    r2 = torch.from_numpy(rng.uniform(0.1, 4.0, (qb, 128)).astype(np.float32))
    q[:, 3] = torch.where(q[:, 3] > 0.5, r2.to(dev), -1.0)
    if dead_block:
        q[qb - 1, 3] = -1.0  # an all-invalid block
    return q


def _ransac_case(case, dev):
    """(hyp, pts) for kernel 5: "random": 256 slots (200 hypotheses, the
    rest pads) over 40 rows; "nh128", "nh512", "nh4096": 128, 512 and
    4,096 slots (the last `_KERNEL_MAX_ITERS`); "nr1", "nr79", "nr203": 1,
    79 and 203 rows (79 holds 10K points, 203 is no multiple of a split);
    "masked": every point masked. Outside "masked", a point lies exactly
    on hypothesis 0's threshold (in the pinned distance form)."""
    rng = np.random.default_rng(5)
    nr = {"nr1": 1, "nr79": 79, "nr203": 203}.get(case, 40)
    nh = {"nh128": 128, "nh512": 512, "nh4096": 4096}.get(case, 256)
    real = nh * 200 // 256
    pts = _planar(rng, nr, scale=20.0).to(dev)
    hyp = np.zeros((5, nh), np.float32)
    nrm = rng.normal(size=(3, real))
    hyp[:3, :real] = nrm / np.linalg.norm(nrm, axis=0)
    hyp[3, :real] = rng.normal(size=real) * 5
    hyp[4, :real] = 0.3
    hyp[4, real:] = -1.0
    hyp = torch.from_numpy(hyp).to(dev)
    if case == "masked":
        pts[:, 3] = 0.0
    else:
        x, y, z = pts[0, 0, 0], pts[0, 1, 0], pts[0, 2, 0]
        pts[0, 3, 0] = 1.0
        hyp[4, 0] = (kernels.fma_f32(z, hyp[2, 0], kernels.fma_f32(
            x, hyp[0, 0], y * hyp[1, 0])) + hyp[3, 0]).abs()
    return hyp, pts, real


@pytest.mark.parametrize("case", ["random", "nh128", "nh512", "nh4096",
                                  "nr1", "nr79", "nr203", "masked"])
def test_ransac_score_counts(dev, case):
    """Bitwise against the plain version, one device launch a call; pads
    and masked points count nothing, the point on the threshold counts."""
    hyp, pts, real = _ransac_case(case, dev)
    got = _count_launch("ransac_score_counts",
                        lambda: kernels.ransac_score_counts(hyp, pts))
    want = kernels.ransac_score_counts_plain(hyp, pts)
    assert torch.equal(got, want)
    assert (got[real:] == 0).all()
    if case == "masked":
        assert (got == 0).all()
    else:
        assert got[0] >= 1 and got[:real].sum() > 0
    assert _device_launches(lambda: kernels.ransac_score_counts(hyp,
                                                                pts)) == 1


def _rescue_radius_case(case, dev):
    """(cand, q, active, gr) for kernel 12: "random": 5 query blocks over
    64 rows in 8-row groups with random lists, the last block all invalid;
    "empty": no valid query at all; "edge": each valid query's r2 is the
    pinned d2 to a valid candidate of its block's groups (on its radius:
    it counts); "zero": r2 0 at queries copied from such candidates, with
    duplicate candidates; "uneven": block 0 lists every group, the others
    0 or 1; "full": 32 live blocks with lists of 12-20 groups (more rows
    than the split's CTAs hold tiles); "gr4", "gr16": the random case in
    4- and 16-row groups (GroupRows' division)."""
    rng = np.random.default_rng(6)
    gr = {"gr4": 4, "gr16": 16}.get(case, 8)
    nr, qb = {"full": (160, 32), "uneven": (64, 6)}.get(case, (64, 5))
    ng = nr // gr
    cpu = torch.device("cpu")
    cand = _planar(rng, nr)
    q = _radius_queries(rng, qb, cpu, dead_block=case != "full")
    if case in ("random", "empty", "gr4", "gr16"):
        act = _groups(rng, qb, ng, cpu)
    else:
        lo, hi = {"full": (12, 21), "uneven": (0, 2)}.get(case, (1, ng + 1))
        act = torch.full((qb, 1 + ng), 12345, dtype=torch.int32)
        for b in range(qb):
            n = ng if case == "uneven" and b == 0 else int(rng.integers(lo,
                                                                        hi))
            act[b, 0] = n
            act[b, 1:1 + n] = torch.from_numpy(np.sort(rng.choice(
                ng, n, replace=False)))
    if case == "empty":
        q[:, 3] = -1.0
    if case in ("edge", "zero"):
        cand[nr // 2, :3, :64] = cand[nr // 2, :3, 64:]  # duplicates
        pts = cand[:, :3].permute(0, 2, 1).reshape(-1, 3)
        valid = (cand[:, 3] > 0.5).reshape(-1)
        for b in range(qb):
            rows = (act[b, 1:1 + act[b, 0]].long()[:, None] * gr
                    + torch.arange(gr)).reshape(-1)
            pos = (rows[:, None] * 128 + torch.arange(128)).reshape(-1)
            pos = pos[valid[pos]]
            pick = pos[torch.from_numpy(rng.integers(0, len(pos), 128))]
            if case == "zero":
                q[b, :3] = pts[pick].T
            r2 = 0.0 if case == "zero" else _pinned_d2(q[b, :3].T, pts[pick])
            q[b, 3] = torch.where(q[b, 3] >= 0, r2, -1.0)
    return cand.to(dev), q.to(dev), act.to(dev), gr


@pytest.mark.parametrize("case", ["random", "empty", "edge", "zero",
                                  "uneven", "full", "gr4", "gr16"])
def test_rescue_radius_count_groups(dev, case):
    """Bitwise against the plain version, one device launch a call; an
    invalid query counts nothing, a candidate on the radius counts."""
    cand, q, act, gr = _rescue_radius_case(case, dev)
    got = _count_launch("rescue_radius_count_groups",
                        lambda: kernels.rescue_radius_count_groups(
                            cand, q, act, gr=gr))
    want = kernels.rescue_radius_count_groups_plain(cand, q, act, gr=gr)
    assert torch.equal(got, want)
    live = q[:, 3].reshape(-1) >= 0
    assert (got[~live] == 0).all()
    if case == "empty":
        assert not live.any()
    else:
        assert got.sum() > 0
    if case in ("edge", "zero"):
        assert (got[live] >= 1).all()
    assert _device_launches(lambda: kernels.rescue_radius_count_groups(
        cand, q, act, gr=gr)) == 1


@pytest.mark.parametrize("kernel", ["rescue_radius_count_groups",
                                    "ransac_score_counts"])
def test_block_scratch_left_reset(dev, kernel):
    """Calls in a row with different block (hypothesis tile) counts: each
    bitwise against the plain version, and every call leaves its stream's
    count scratch and arrival counters zero."""
    if kernel == "ransac_score_counts":
        calls = [(lambda h=h, p=p: kernels.ransac_score_counts(h, p),
                  lambda h=h, p=p: kernels.ransac_score_counts_plain(h, p))
                 for h, p, _ in (_ransac_case(c, dev)
                                 for c in ("nh4096", "nh128", "nh512"))]
    else:
        calls = [(lambda c=c, q=q, a=a, g=g:
                  kernels.rescue_radius_count_groups(c, q, a, gr=g),
                  lambda c=c, q=q, a=a, g=g:
                  kernels.rescue_radius_count_groups_plain(c, q, a, gr=g))
                 for c, q, a, g in (_rescue_radius_case(case, dev)
                                    for case in ("full", "random", "gr16"))]
    for fn, plain in calls:
        got = fn()
        assert torch.equal(got, plain())
        torch.cuda.synchronize()
        used = [t for key, t in kernels._BLOCK_SCRATCH.items()
                if key[0] == kernel and key[1] == got.device]
        assert used
        for counts, arrived in used:
            assert (counts == 0).all() and (arrived == 0).all()


# Kernel 19's cases: (case, mapping, seed, iterations, rows, valid rows).
# "kitti" is the KITTI frame's call (500 hypotheses over the 98,304-row
# buffer through `position_rows`), "aerial" the aerial tile's (300 over
# 524,288 rows, the leading 457,000 valid, `assume_compact`).
HYPOTHESIS_CASES = {
    "kitti": ("kitti", "rows", 2**31 - 1, 500, 98_304, 93_388),
    "aerial": ("aerial", "compact", 2_200_000_033 % 2**31, 300, 524_288,
               457_000),
    "cnt0": ("cnt0", "rows", 7, 500, 2048, 0),
    "cnt1": ("cnt1", "rows", 7, 500, 2048, 0),
    "cnt2": ("cnt2", "compact", 7, 500, 2048, 0),
    "cnt3": ("cnt3", "rows", 7, 500, 2048, 0),
    "iters1": ("iters1", "rows", 7, 1, 2048, 1945),
    "iters4097": ("iters4097", "rows", 7, 4097, 2048, 1945),
    "compaction": ("compaction", "compaction", 7, 500, 2048, 1945),
    "degenerate": ("degenerate", "rows", 7, 500, 2048, 0),
    "nan": ("nan", "rows", 7, 500, 2048, 0),
}


@pytest.mark.parametrize("case", list(HYPOTHESIS_CASES))
def test_ransac_hypotheses(dev, case):
    """Kernel 19 bitwise against the plain version on the card and on the
    CPU, one device launch a call, and no host read (sync debug mode
    "error"): KITTI- and aerial-sized inputs and the edge cases."""
    name, mapping, seed, iterations, n, n_valid = HYPOTHESIS_CASES[case]
    xyz, valid, rows = hypothesis_cloud(name, mapping, seed, n, n_valid)
    xyz, valid = torch.from_numpy(xyz), torch.from_numpy(valid)
    order = position_map(mapping, valid, rows)
    want = kernels.ransac_hypotheses_plain(xyz, valid.sum(), seed,
                                           iterations, order)
    x, cnt = xyz.to(dev), valid.to(dev).sum()
    o = None if order is None else order.to(dev)

    def call():
        return kernels.ransac_hypotheses(x, cnt, seed, iterations, o)

    got = _count_launch("ransac_hypotheses", call)
    plain = kernels.ransac_hypotheses_plain(x, cnt, seed, iterations, o)
    for g, p, w in zip(got, plain, want):
        assert_same_bits(g, p)
        assert_same_bits(g, w)
    assert got[2].any() == (case == "degenerate")
    assert torch.isnan(got[0]).any() == (case == "nan")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, g in zip(again, got):
        assert_same_bits(a, g)
    assert _device_launches(call) == 1


def _pinned_d2(q, c):
    """The kernels' d2, fma(dz, dz, fma(dx, dx, dy*dy)), of query points q
    [..., 3] and candidate points c [..., 3]."""
    d = q - c
    return kernels.fma_f32(d[..., 2], d[..., 2], kernels.fma_f32(
        d[..., 0], d[..., 0], d[..., 1] * d[..., 1]))


def _brute_radius_case(rng, case, dev):
    """(q, cand) for kernel 14. "random": 6 query blocks over 200 rows, the
    last block all invalid; "empty": no valid query at all (every block
    writes zeros); "edge": each valid query's r2 is the pinned d2 to a
    valid candidate, which lies exactly on its radius (inclusive);
    "zero": r2 = 0 at queries copied from candidates, with duplicate
    candidates (coincident points count); "odd": 203 rows, no multiple of
    the split; "short": 3 rows, fewer than the split's CTAs; "full": 32
    query blocks, all live."""
    nr, qb = {"odd": (203, 3), "short": (3, 2), "full": (64, 32)}.get(
        case, (200, 6))
    cand = _planar(rng, nr)
    cand[nr // 2, :3, :64] = cand[nr // 2, :3, 64:]  # duplicates
    q = _radius_queries(rng, qb, torch.device("cpu"),
                        dead_block=case not in ("full", "short"))
    if case == "empty":
        q[:, 3] = -1.0
    if case in ("edge", "zero"):
        pts = cand[:, :3].permute(0, 2, 1).reshape(-1, 3)
        valid = (cand[:, 3] > 0.5).reshape(-1).nonzero().flatten()
        pick = valid[torch.from_numpy(rng.integers(0, len(valid),
                                                   qb * 128))]
        qp = q[:, :3].permute(0, 2, 1).reshape(-1, 3)
        if case == "zero":
            qp = pts[pick].clone()
            q[:, :3] = qp.reshape(qb, 128, 3).permute(0, 2, 1)
        r2 = 0.0 if case == "zero" else _pinned_d2(qp, pts[pick])
        live = q[:, 3].reshape(-1) >= 0
        q[:, 3] = torch.where(live, r2, -1.0).reshape(qb, 128)
    return q.to(dev), cand.to(dev)


@pytest.mark.parametrize("case", ["random", "empty", "edge", "zero", "odd",
                                  "short", "full"])
def test_brute_radius_count(dev, case):
    rng = np.random.default_rng(7)
    q, cand = _brute_radius_case(rng, case, dev)
    before = kernels.LAUNCHES["brute_radius_count"]
    got = kernels.brute_radius_count(q, cand)
    assert kernels.LAUNCHES["brute_radius_count"] == before + 1
    assert torch.equal(got, kernels.brute_radius_count_plain(q, cand))
    live = q[:, 3].reshape(-1) >= 0
    assert (got[~live] == 0).all()
    if case == "empty":
        assert not live.any()
    else:
        assert got.sum() > 0
    if case in ("edge", "zero"):  # the candidate on the radius counts
        assert (got[live] >= 1).all()


@pytest.mark.parametrize("case", ["random", "dup", "dead", "many", "few"])
@pytest.mark.parametrize("k", [1, 11, 24, 32])
def test_brute_knn_idx(dev, k, case):
    """Every case but "many" has an all-invalid block (the last). "dup":
    lattice points (ties at the kth) and rows copied into rows that other
    slices of a query walk; "dead": no valid query at all; "many": 20 live
    blocks; "few": fewer valid candidates than k."""
    rng = np.random.default_rng(k)
    nr, qb = 150, 20 if case == "many" else 6
    cand = _select_planar(rng, nr, "dup" if case == "dup" else "random")
    cand[7, :3, :64] = cand[7, :3, 64:]  # duplicates: ties at equal d2
    if case == "dup":
        cand[8:12] = cand[7]  # the same points in the next tile's rows
        cand[21] = cand[7]
    if case == "few":
        cand[:, 3] = 0.0
        cand[3, 3, [5, 9, 77]] = 1.0
        cand[140, 3, 127] = 1.0
        cand[:, :3] *= cand[:, 3:4]
    cand = cand.to(dev)
    q = _select_planar(rng, qb, "dup" if case == "dup" else "random").to(dev)
    if case != "many":
        q[qb - 1, 3] = 0.0  # an all-invalid block
    if case == "dead":
        q[:, 3] = 0.0
    got = _count_launch("brute_knn_idx",
                        lambda: kernels.brute_knn_idx(q, cand, k=k))
    want = kernels.brute_knn_idx_plain(q, cand, k=k)
    assert torch.equal(got, want)
    live = (q[:, 3] > 0.5).reshape(-1)
    assert (got[2 * k, ~live] == 0).all()
    if case == "dead":
        assert (got[:k] == torch.inf).all() and (got[k:2 * k] == -1).all()
    else:
        assert (got[2 * k, live] == min(k, 4 if case == "few" else k)).all()


def test_api_gpu_equals_cpu(dev):
    """The per-op API on the card against its CPU run: the same points in
    the same order, the same normals, plane and inliers."""
    from pointclouds_tpu_torch import api

    rng = np.random.default_rng(8)
    pts = rng.uniform(0, 10, (6000, 3)).astype(np.float32)
    pts[:300] = rng.uniform(-5, 15, (300, 3))
    out = {}
    for d in ("cpu", dev):
        c = api.PointCloud.from_numpy(pts, device=d)
        out[str(d)] = [
            api.voxel_downsample(c, 0.5).to_numpy(),
            api.passthrough_filter(c, "x", 2.0, 8.0).to_numpy(),
            api.statistical_outlier_removal(c, 10, 2.0).to_numpy(),
            api.radius_outlier_removal(c, 0.5, 5).to_numpy(),
            api.estimate_normals(c, 10)._normals_numpy(),
        ]
        plane = api.ransac_plane_seeded(c, 0.05, 200, 3)
        out[str(d)].append(np.asarray(plane.normal + [plane.d] +
                                      plane.inliers))
        assert api.statistical_outlier_removal(c, 10, 2.0).device == c.device
    for g, w in zip(out[str(dev)], out["cpu"]):
        np.testing.assert_array_equal(g, w)


def _knn_windows_case(case):
    """Kernel 10's inputs (planar, starts) on the CPU: the sorted structure
    of a uniform cloud (dedup skips from the structure) with one row's
    halves equal (ties at equal d2), or "windows": random rows on a 0.5 m
    lattice (duplicates: ties at d2 0) under random, overlapping windows
    with nonzero skips, a block whose flag is 0 (the last) and a block
    with its flag set but no valid query (block 1); ~10% of the queries of
    every other block are invalid."""
    if case == "structure":
        s = _structure(torch.device("cpu"), seed=9, wr=6, cell=0.9)
        planar = s["planar"].clone()
        planar[2, :3, :64] = planar[2, :3, 64:]
        return planar, s["starts_skip"]
    rng = np.random.default_rng(12)
    nb, nr = 12, 40
    planar = _select_planar(rng, nr, "dup")
    planar[1, 3] = 0.0
    starts = _window_starts(rng, nb, nr)
    assert (starts[:, 9:18] > 0).any()
    return planar, torch.from_numpy(starts)


@pytest.mark.parametrize("case", ["structure", "windows"])
@pytest.mark.parametrize("k", [1, 10, 24, 32])
def test_sweep_knn_select(dev, k, case):
    planar, starts = (a.to(dev) for a in _knn_windows_case(case))
    got = _count_launch("sweep_knn_select", lambda: kernels.sweep_knn_select(
        planar, starts, k=k))
    want = kernels.sweep_knn_select_plain(planar, starts, k=k)
    assert torch.equal(got, want)
    assert (got[2 * k] == k).float().mean() > 0.5
    assert (got[2 * k + 2] == 1.0).all()
    if case == "windows":  # the empty fill: no neighbour, count 0, kth 0
        nb = starts.shape[0]
        for b in (1, nb - 1):
            cols = slice(b * 128, (b + 1) * 128)
            assert (got[:k, cols] == torch.inf).all()
            assert (got[k:2 * k, cols] == -1.0).all()
            assert (got[2 * k:2 * k + 2, cols] == 0.0).all()


@pytest.mark.parametrize("k", [10, 32])
def test_sweep_knn_select_cross(dev, k):
    """The query-frame form, on a shuffled query frame against the same
    windows (the positions name candidate rows either way): the frame has
    3 more rows than there are blocks, which the kernel must not read, and
    a block with no valid query."""
    s = _structure(dev, seed=10, wr=6, cell=0.9)
    nb = s["starts_skip"].shape[0]
    rng = np.random.default_rng(10)
    q = _planar(rng, nb + 3, scale=10.0).to(dev)
    q[1, 3] = 0.0
    got = _count_launch("sweep_knn_select", lambda: kernels.sweep_knn_select(
        s["planar"], s["starts_skip"], k=k, q_planar=q))
    want = kernels.sweep_knn_select_plain(s["planar"], s["starts_skip"], k=k,
                                          q_planar=q)
    assert torch.equal(got, want)
    assert got.shape[1] == nb * 128
    assert (got[2 * k, 128:256] == 0).all()


def _nn_case(case):
    """Kernel 15's (q, c, qv, cv) on the CPU: "random" 1,000 queries
    against 3,000 candidates; "lattice": queries at the half-shift of a
    24^3 lattice (108 target rows), each with 8 nearest candidates at equal
    d2 up to 4.5 rows apart, so that many ties fall in different CTAs'
    row ranges; "none": no valid candidate (every served query gets +inf
    and the target's last position); "one_row" and "few_rows": targets of
    1 and 3 rows, fewer than a block's CTAs."""
    rng = np.random.default_rng(11)
    if case == "lattice":
        g = np.arange(24, dtype=np.float32)
        c = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        q = c[::7][:2000] + np.float32(0.5)
    else:
        nc = {"one_row": 100, "few_rows": 300}.get(case, 3000)
        c = rng.uniform(-5, 5, (nc, 3)).astype(np.float32)
        q = rng.uniform(-5, 5, (1000, 3)).astype(np.float32)
    cv = rng.random(len(c)) > (1.0 if case == "none" else 0.1)
    qv = rng.random(len(q)) > 0.1
    q[5] = np.nan  # a non-finite valid query: (+inf, -1)
    return q, c, qv, cv


def _nn_planar(dev, q, c, qv, cv):
    from pointclouds_tpu_torch.ops.registration import _to_planar

    return (_to_planar(torch.from_numpy(q), torch.from_numpy(qv)).to(dev),
            _to_planar(torch.from_numpy(c), torch.from_numpy(cv)).to(dev))


@pytest.mark.parametrize("case", ["random", "lattice", "none", "one_row",
                                  "few_rows"])
def test_nn_argmin(dev, case):
    q, c, qv, cv = _nn_case(case)
    qp, cp = _nn_planar(dev, q, c, qv, cv)
    before = kernels.LAUNCHES["nn_argmin"]
    got = kernels.nn_argmin(qp, cp)
    assert kernels.LAUNCHES["nn_argmin"] == before + 1
    want = kernels.nn_argmin_plain(qp, cp)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert _device_launches(lambda: kernels.nn_argmin(qp, cp)) == 1
    served = torch.from_numpy(qv).to(dev)
    served[5] = False
    d2, pos = got[0][:len(q)], got[1][:len(q)]
    assert pos[5] == -1.0 and (pos[~served] == -1.0).all()
    if case == "none":
        assert torch.isinf(d2[served]).all()
        assert (pos[served] == cp.shape[0] * 128 - 1).all()
    else:
        assert torch.isfinite(d2[served]).all() and (pos[served] >= 0).all()


def test_nn_argmin_scratch_left_reset(dev):
    """Calls in a row with different block counts, then on a second
    stream and back: each bitwise against the plain version, and every
    call leaves its stream's key scratch all-ones and its arrival
    counters zero."""
    q, c, qv, cv = _nn_case("lattice")
    qp, cp = _nn_planar(dev, q, c, qv, cv)
    side = torch.cuda.Stream()
    for blocks, stream in ((16, None), (3, None), (9, side), (1, side),
                           (16, None)):
        with torch.cuda.stream(stream or torch.cuda.current_stream()):
            sub = qp[:blocks].contiguous()
            got = kernels.nn_argmin(sub, cp)
            want = kernels.nn_argmin_plain(sub, cp)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            torch.cuda.current_stream().synchronize()
    used = [t for key, t in kernels._BLOCK_SCRATCH.items()
            if key[0] == "nn_argmin" and key[1] == qp.device]
    assert len(used) >= 2
    for keys, arrived in used:
        assert (keys == -1).all() and (arrived == 0).all()


@pytest.mark.parametrize("active", ["all", "half"])
def test_cluster_propagate(dev, active):
    rng = np.random.default_rng(16)
    xyz = (rng.random((3000, 3)) * 6).astype(np.float32)
    t = torch.from_numpy(xyz)
    cell = sweep.cluster_cell_size(torch.tensor(np.float32(0.4)),
                                   t.abs().amax())
    s = sweep._sorted_structure(t, torch.ones(3000, dtype=torch.bool), cell,
                                7, sweep.SWEEP_TABLE_SIZE)
    nb, nrows = s["nb"], s["nrows"]
    lab = torch.arange(nrows * 128, dtype=torch.int32)
    lab[rng.random(lab.shape[0]) < 0.3] //= 3
    act = torch.ones(nb, dtype=torch.int32) if active == "all" else \
        torch.from_numpy((rng.random(nb) < 0.5).astype(np.int32))
    starts = torch.cat([s["starts_skip"], act[:, None]], dim=1).contiguous()
    args = [a.to(dev) for a in (s["planar"], lab, starts)]
    got = _count_launch("cluster_propagate",
                        lambda: kernels.cluster_propagate(*args, 0.16))
    want = kernels.cluster_propagate_plain(*args, float(np.float32(0.16)))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_hop_loop_gpu_equals_cpu(dev, monkeypatch):
    monkeypatch.setattr(sweep, "CLUSTER_RESIDENT_BYTES", 0)
    data = kitti_scene(seed=5, scale=0.05)
    xyz = np.zeros((4096, 3), np.float32)
    xyz[: len(data)] = data
    valid = np.zeros(4096, bool)
    valid[: len(data)] = True
    lab_c, ex_c = sweep.sweep_cluster_labels(
        torch.from_numpy(xyz), torch.from_numpy(valid), np.float32(0.8), wr=12)
    lab_g, ex_g = _count_launch("cluster_propagate",
                                lambda: sweep.sweep_cluster_labels(
                                    torch.from_numpy(xyz).to(dev),
                                    torch.from_numpy(valid).to(dev),
                                    np.float32(0.8), wr=12))
    assert bool(ex_c) and bool(ex_g)
    assert torch.equal(lab_g.cpu(), lab_c)


def _propagate_case(case):
    """Kernel 16's inputs (planar, labels, starts, r2) on the CPU: a
    uniform cloud at wr 7 with every block active ("all"), none active,
    one valid query in block 2, 400 duplicates of one point, a 0.5 m
    lattice at r 0.5 (duplicates and pairs at exactly d2 == r2), or random
    windows of 12 rows each (108 rows a block: ragged row slices) for 40
    blocks over 200 planar rows (nb < nr)."""
    rng = np.random.default_rng(17)
    if case == "windows108":
        nr, nb, r = 200, 40, 0.3
        planar = _planar(rng, nr, scale=2.0)
        starts = np.concatenate([
            rng.integers(0, nr - 12, (nb, 9)), rng.integers(0, 4, (nb, 9)),
            np.full((nb, 9), 12), np.ones((nb, 2))], axis=1)
        starts = torch.from_numpy(starts.astype(np.int32))
    else:
        xyz = (rng.random((3000, 3)) * 6).astype(np.float32)
        r = 0.4
        if case == "lattice":
            xyz, r = np.round(xyz * 2.0) / np.float32(2.0), 0.5
        if case == "dups":
            xyz[:400] = xyz[0]
        t = torch.from_numpy(xyz)
        cell = sweep.cluster_cell_size(torch.tensor(np.float32(r)),
                                       t.abs().amax())
        s = sweep._sorted_structure(t, torch.ones(3000, dtype=torch.bool),
                                    cell, 7, sweep.SWEEP_TABLE_SIZE)
        nb, nr = s["nb"], s["nrows"]
        planar = s["planar"].clone()
        if case == "one_valid":
            planar[2, 3, 1:] = 0.0
        act = torch.zeros(nb, dtype=torch.int32) if case == "none" else \
            torch.ones(nb, dtype=torch.int32)
        starts = torch.cat([s["starts_skip"], act[:, None]], dim=1)
    lab = torch.arange(nr * 128, dtype=torch.int32)
    lab[rng.random(lab.shape[0]) < 0.3] //= 3
    return planar, lab, starts.contiguous(), float(np.float32(r) ** 2)


@pytest.mark.parametrize("case", ["none", "one_valid", "dups", "lattice",
                                  "windows108"])
def test_cluster_propagate_cases(dev, case):
    """Kernel 16 bitwise against its plain version (labels and changed)."""
    planar, lab, starts, r2 = _propagate_case(case)
    args = [a.to(dev) for a in (planar, lab, starts)]
    got = _count_launch("cluster_propagate",
                        lambda: kernels.cluster_propagate(*args, r2))
    want = kernels.cluster_propagate_plain(*args, r2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[1].any() == (case != "none")


def _one_frame(call, dev):
    """``call()`` as the one call of a traced frame: (its result, the frame's
    record, which sums the cluster loops' counters over the frame)."""
    profiling.set_tracing(True)
    try:
        with profiling.frame("test", dev):
            out = call()
    finally:
        profiling.set_tracing(False)
    return out, profiling.last_frame()


def _serpentine(r, lanes=10, per=110):
    """A chain of points 0.9 r apart: ``lanes`` rows of ``per`` points along
    x, 1.8 r apart in y, joined at alternate ends by one point each."""
    s = np.float32(0.9) * np.float32(r)
    pts = []
    for i in range(lanes):
        xs = np.arange(per) * s
        if i % 2:
            xs = xs[::-1]
        pts += [(x, 2 * i * s) for x in xs]
        if i < lanes - 1:
            pts.append((xs[-1], (2 * i + 1) * s))
    return np.column_stack([np.array(pts), np.zeros(len(pts))]).astype(
        np.float32)


def test_cluster_multisweep_windows_rounds(dev):
    """Kernel 8 on a chain through 9 blocks that needs more rounds than a
    read batch, beside a blob that settles in its first: converged labels
    equal to the plain version's, the launch count equal to the rounds
    run, one host read a batch, fewer pairs walked than every window row
    every round (the frontier and the row prune); a run cut by max_rounds
    reports it, and its resume reaches the fixpoint."""
    rng = np.random.default_rng(5)
    pts = np.vstack([rng.normal([60.0, 60.0, 0.0], 0.05, (100, 3)),
                     _serpentine(0.5)]).astype(np.float32)
    xyz = np.zeros((1280, 3), np.float32)
    xyz[:len(pts)] = pts
    valid = np.arange(1280) < len(pts)
    t = torch.from_numpy(xyz).to(dev)
    cell = sweep.cluster_cell_size(torch.tensor(np.float32(0.5), device=dev),
                                   t.abs().amax())
    s = sweep._sorted_structure(t, torch.from_numpy(valid).to(dev), cell, 12,
                                sweep.SWEEP_TABLE_SIZE)
    planar, starts = s["planar"], s["starts_skip"]
    r2 = float(np.float32(0.5) ** 2)
    want = kernels.cluster_multisweep_windows_plain(planar, starts, r2,
                                                    max_rounds=64)
    before = kernels.LAUNCHES["cluster_multisweep_windows"]
    got, rec = _one_frame(lambda: kernels.cluster_multisweep_windows(
        planar, starts, r2, max_rounds=64), dev)
    rounds = got[2]
    assert kernels.LAUNCHES["cluster_multisweep_windows"] - before == rounds
    assert rounds > kernels.WINDOW_ROUND_BATCH
    assert not got[1].any() and not want[1].any()
    assert torch.equal(got[0], want[0])
    batch = kernels.WINDOW_ROUND_BATCH
    assert rec.count("cluster.round_batches") == -(-rounds // batch)
    assert rec.count("cluster.rounds") == rounds
    rows = (starts[:, 18:27] - starts[:, 9:18]).clamp(min=0).sum(1)
    full = 128 * 128 * int((rows * (starts[:, 27] != 0)).sum()) * rounds
    assert 0 < rec.count("cluster.pairs_visited") < full
    cut = kernels.cluster_multisweep_windows(planar, starts, r2,
                                             max_rounds=2)
    assert cut[2] == 2 and cut[1].any()
    resumed = kernels.cluster_multisweep_windows(planar, starts, r2,
                                                 max_rounds=64,
                                                 labels0=cut[0])
    assert not resumed[1].any() and torch.equal(resumed[0], want[0])


def _list_case(case):
    """Kernel 4's inputs (planar, rowlist, cap, r2) on the CPU, as
    `sweep_cluster_labels` builds them (wr 12): "blobs", three Gaussian
    blobs and scattered points at r 0.5 with cap 16 (KITTI's row cap);
    "chain", the serpentine chain through 9 blocks, which needs more
    rounds than a read batch; "overflow", the blobs with cap 3, so lists
    overflow and are cut at cap; "dead", the blobs with every third block's
    points invalid and its flag 0 (no valid query); "wide", 40,000 uniform
    points in a 30 m cube (313 blocks: too many to split a block's list
    over 2 CTAs). "cap1" is "blobs"."""
    rng = np.random.default_rng(23)
    n = 1280
    if case == "chain":
        pts = _serpentine(0.5)
    elif case == "wide":
        n = 40_064
        pts = (rng.random((40_000, 3)) * 30.0).astype(np.float32)
    else:
        pts = np.vstack([rng.normal(c, 0.3, (300, 3)) for c in
                         ([0.0, 0.0, 0.0], [4.0, 4.0, 0.0], [8.0, 1.0, 1.0])]
                        + [rng.random((300, 3)) * 10.0]).astype(np.float32)
    xyz = np.zeros((n, 3), np.float32)
    xyz[:len(pts)] = pts
    t = torch.from_numpy(xyz)
    cell = sweep.cluster_cell_size(torch.tensor(np.float32(0.5)),
                                   t.abs().amax())
    s = sweep._sorted_structure(t, torch.from_numpy(np.arange(n) < len(pts)),
                                cell, 12, sweep.SWEEP_TABLE_SIZE)
    cap = 3 if case == "overflow" else 16
    rowlist, fits = sweep._window_row_lists(s["starts_skip"], cap, s["nrows"])
    assert bool(fits.all()) == (case != "overflow")
    planar = s["planar"].clone()
    if case == "dead":
        dead = torch.arange(0, rowlist.shape[0], 3)
        planar[dead, 3] = 0.0
        rowlist[dead, cap] = 0
    return planar, rowlist, cap, float(np.float32(0.5) ** 2)


@pytest.mark.parametrize("case", ["blobs", "chain", "overflow", "dead",
                                  "wide", "cap1"])
def test_cluster_multisweep(dev, case):
    """Kernel 4: converged labels equal to the plain version's, the launch
    count equal to the rounds run, one host read a batch; a run cut at one
    round reports one round and a change."""
    planar, rowlist, cap, r2 = _list_case(case)
    planar, rowlist = planar.to(dev), rowlist.to(dev)
    max_rounds = 1 if case == "cap1" else 64
    want = kernels.cluster_multisweep_plain(planar, rowlist, r2, cap=cap,
                                            max_rounds=max_rounds)
    before = kernels.LAUNCHES["cluster_multisweep"]
    got, rec = _one_frame(lambda: kernels.cluster_multisweep(
        planar, rowlist, r2, cap=cap, max_rounds=max_rounds), dev)
    rounds = got[2]
    assert kernels.LAUNCHES["cluster_multisweep"] - before == rounds
    assert rec.count("cluster.round_batches") == -(
        -rounds // kernels.LIST_ROUND_BATCH)
    assert rec.count("cluster.rounds") == rounds
    if case == "cap1":
        assert rounds == 1 and got[1].any() and want[1].any()
        return
    assert not got[1].any() and not want[1].any()
    assert torch.equal(got[0], want[0])
    if case == "chain":
        assert rounds > kernels.LIST_ROUND_BATCH


def _sor_inputs(rng, c, m, ncand, case):
    """Kernel 17's inputs: random masks, or every slot valid ("dense"),
    none ("empty"), one valid query a cell ("one_query"), coordinates on a
    0.5 lattice so that d2 ties at the kth value ("ties"), or a few valid
    slots at the front of each of the 27 neighbour blocks ("sparse", the
    KITTI frame's ~4%; "thin", about half that: cells of one to three
    rows of 32)."""
    scale = 3.0 if case != "ties" else 1.0
    q = (rng.random((c, 3, m)) * scale).astype(np.float32)
    cand = (rng.random((c, ncand, 3)) * scale).astype(np.float32)
    if case == "ties":
        q = np.round(q * 2.0) / 2.0
        cand = np.round(cand * 2.0) / 2.0
    qm = rng.random((c, m)) < 0.7
    cv = rng.random((c, ncand)) < 0.5
    if case == "dense":
        cv[:] = True
    if case == "empty":
        cv[:] = False
        qm[: c // 2] = False
    if case == "one_query":
        qm[:] = False
        qm[np.arange(c), rng.integers(0, m, c)] = True
    if case in ("sparse", "thin"):
        blk = ncand // 27
        fill = rng.integers(0, 6 if case == "sparse" else 3, (c, 27))
        cv = (np.arange(ncand) % blk < np.repeat(fill, blk, 1)) & (
            np.arange(ncand) < 27 * blk)
        qm = np.arange(m) < rng.integers(0, 8, (c, 1))
    qm[c - 5:] = False  # cells past num_cells
    return [torch.from_numpy(a) for a in (q, qm, cand, cv)]


@pytest.mark.parametrize("m,k,ncand,case", [
    (56, 20, 27 * 40, "random"), (8, 3, 27 * 8, "random"),
    (200, 31, 27 * 40, "random"), (56, 20, 1512, "dense"),
    (56, 20, 1512, "empty"), (56, 20, 1512, "one_query"),
    (56, 20, 1512, "ties"), (56, 31, 1512, "random"),
    (56, 20, 1512, "sparse"), (57, 20, 27 * 57, "sparse"),
    (56, 20, 1512, "thin"),
    (7, 5, 27 * 7, "random")])
def test_sor_select(dev, m, k, ncand, case):
    """Bitwise against the plain version. The dense cells (1,512 valid
    slots) and the 200-query cells walk the stage in chunks; ncand 1,539
    and 189 give rows that are not 8-byte aligned."""
    rng = np.random.default_rng(m + k + ncand)
    args = [a.to(dev) for a in _sor_inputs(rng, 40, m, ncand, case)]
    got = _count_launch("sor_select", lambda: kernels.sor_select(*args, k=k))
    want = kernels.sor_select_plain(*args, k=k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _seg_work(rng, q, w):
    """Work rows for kernel 18: random values, 40% masked (+inf), and rows
    with none finite (0-2), with 5 (3-4), all tied (5), ties on a 0.5
    lattice (6-7), a few values tied many times (8), many of the smallest
    in one lane's slots, distinct (9) or equal (10, 11), and a NaN (12)."""
    work = (rng.random((q, w)) * 9.0).astype(np.float32)
    work[rng.random(work.shape) < 0.4] = np.inf
    work[:3] = np.inf
    work[3:5, 5:] = np.inf
    work[5] = 0.25
    work[6:8] = np.round(work[6:8] * 2.0) / 2.0
    work[8, ::3] = 1.5
    work[9, ::128] = np.float32(1e-3) * rng.random(len(range(0, w, 128)))
    work[10, ::128] = 0.125
    work[11, ::32] = 0.125
    work[12, 1] = np.nan
    return work


@pytest.mark.parametrize("w", [40, 1512, 1513, 1536])
@pytest.mark.parametrize("k", [1, 11, 21, 32])
def test_segmented_select(dev, k, w):
    """Also on a work array whose data starts 4 bytes past a 16-byte
    boundary (a contiguous view at a storage offset of one float): it runs
    (one 4-byte load a value) and gives the same bits."""
    rng = np.random.default_rng(w + k)
    work = torch.from_numpy(_seg_work(rng, 777, w)).to(dev)
    got = _count_launch("segmented_select",
                        lambda: kernels.segmented_select(work, k=k))
    want = kernels.segmented_select_plain(work, k=k)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    flat = torch.empty(work.numel() + 1, device=dev)
    shifted = flat[1:].view(work.shape)
    shifted.copy_(work)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    got = _count_launch("segmented_select",
                        lambda: kernels.segmented_select(shifted, k=k))
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def test_cellgrid_pipeline_gpu_equals_cpu(dev):
    """Both cell-grid SOR backends (kernels 17, 18) and the cell-graph
    clustering: the card's frame equals the CPU run's."""
    data = kitti_scene(seed=3, scale=0.1)
    for backend, kname in (("xla", "segmented_select"),
                           ("pallas", "sor_select")):
        outs = []
        for d in ("cpu", dev):
            c = port.make_cloud_arrays(data, device=d)
            before = kernels.LAUNCHES[kname]
            outs.append(port.kitti_obstacle_pipeline(
                c.xyz, c.valid, np.float32(0.15), np.float32(2.0),
                np.float32(0.15), 7, np.float32(0.8), sor_backend=backend,
                ransac_subsample=4096, obstacle_cap=8192))
            assert (kernels.LAUNCHES[kname] > before) == (d == dev)
        for a, b in zip(*outs):
            assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("pipeline", ["kitti", "aerial"])
def test_pipeline_frame_one_hypotheses_launch(dev, pipeline):
    """A traced pipeline frame on the card records one `ransac_hypotheses`
    launch (the CPU run none), and its plane and inliers equal the CPU
    run's."""
    if pipeline == "kitti":
        data = kitti_scene(seed=3, scale=0.1)
        args = (np.float32(0.15), np.float32(2.0), np.float32(0.15), 7,
                np.float32(0.8))
        kw = dict(ransac_subsample=4096, obstacle_cap=8192)
        run = port.kitti_obstacle_pipeline
    else:
        data = aerial_scene(seed=3, scale=0.05)
        args = (np.float32(0.5), np.float32(12.0), np.float32(0.3), 0,
                np.float32(2.0), [0.0, 0.0, 10000.0])
        kw = dict(ransac_subsample=4096)
        run = port.aerial_pipeline
    outs, recs = [], []
    for d in ("cpu", dev):
        c = port.make_cloud_arrays(data, device=d)
        run(c.xyz, c.valid, *args, **kw)  # kernels built, caches warm
        profiling.set_tracing(True)
        try:
            outs.append(run(c.xyz, c.valid, *args, **kw))
        finally:
            profiling.set_tracing(False)
        recs.append(profiling.last_frame())
    assert "ransac_hypotheses" not in recs[0].launches
    assert recs[1].launches["ransac_hypotheses"] == 1
    for f in ("plane_normal", "plane_d", "inlier_mask"):
        assert torch.equal(getattr(outs[1], f).cpu(), getattr(outs[0], f))
