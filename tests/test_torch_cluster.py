"""Euclidean clustering of the PyTorch port against the JAX package: the
plain versions of the `cluster_multisweep` and `cluster_multisweep_windows`
kernels against the Pallas kernels in interpret mode, and
`sweep_cluster_labels` (row-list and window paths) against the JAX one, on
the scenes of tests/test_sweep_cluster.py. Converged labels are the
component minima, so they are equal wherever both sides converged."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.spatial import pallas_kernels as jpk
from pointclouds_tpu.spatial import sweep as jsweep
from pointclouds_tpu_torch.spatial import kernels, sweep
from pointclouds_tpu_torch.utils.interop import to_torch


def _blobs():
    rng = np.random.default_rng(7)
    pts = np.vstack([
        rng.normal([0, 0, 0], 0.3, (300, 3)),
        rng.normal([5, 5, 0], 0.4, (400, 3)),
        rng.normal([9, 1, 1], 0.2, (150, 3)),
        rng.random((150, 3)) * 12,
    ]).astype(np.float32)
    xyz = np.zeros((1024, 3), np.float32)
    xyz[: len(pts)] = pts
    valid = np.zeros(1024, bool)
    valid[: len(pts)] = True
    xyz[50] = np.inf
    valid[60] = False
    return xyz, valid, 0.5


def _chain():
    n = 400
    t = np.linspace(0, 30, n)
    xyz = np.zeros((512, 3), np.float32)
    xyz[:n] = np.column_stack([t, np.sin(t), np.zeros(n)])
    valid = np.zeros(512, bool)
    valid[:n] = True
    return xyz, valid, 0.2


def _boundary():
    xyz = np.zeros((256, 3), np.float32)
    xyz[:3] = [[0, 0, 0], [1.0, 0, 0], [2.5, 0, 0]]
    valid = np.zeros(256, bool)
    valid[:3] = True
    return xyz, valid, 1.0


def _cars():
    """Two dense car-sized boxes and a pedestrian at KITTI voxel density."""
    rng = np.random.default_rng(3)
    pts = np.vstack([
        rng.uniform([6, 2, 0.8], [10, 3.8, 2.3], (1500, 3)),
        rng.uniform([-7, -9, 0.8], [-3, -7.2, 2.3], (1500, 3)),
        rng.uniform([2.75, -2.25, 0.9], [3.25, -1.75, 2.7], (150, 3)),
        rng.uniform([-20, -20, -1], [20, 20, 5], (200, 3)),
    ]).astype(np.float32)
    xyz = np.zeros((4096, 3), np.float32)
    xyz[: len(pts)] = pts
    valid = np.zeros(4096, bool)
    valid[: len(pts)] = True
    return xyz, valid, 0.8


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


def _padded(pts, n):
    xyz = np.zeros((n, 3), np.float32)
    xyz[: len(pts)] = pts
    valid = np.zeros(n, bool)
    valid[: len(pts)] = True
    return xyz, valid


def _long_chain():
    """1,109 points 0.9 r apart through 9 blocks: the labels take more
    rounds to meet than one read batch of the CUDA path."""
    xyz, valid = _padded(_serpentine(0.5), 1280)
    return xyz, valid, 0.5


def _exact_r():
    """Pairs at exactly d2 == r2 in the pinned form fma(dz, dz, fma(dx, dx,
    dy*dy)) (linked: the compare is inclusive) and pairs just beyond it
    (not linked), one of them at r2 in the unfused sum of squares."""
    pts = np.array([
        [3.0, 0.0, 0.0], [3.5, 0.0, 0.0], [4.0, 0.0, 0.0], [4.5, 0.0, 0.0],
        [10.0, 0.0, 0.0], [np.nextafter(np.float32(10.5), np.float32(11)),
                           0.0, 0.0],
        # pinned d2 0.25 == r2
        [20.0, 20.0, 1.0], [20.299903869628906, 20.40007209777832,
                            0.9999980926513672],
        # pinned d2 0.25000003 > r2; the unfused sum gives 0.25
        [30.0, 20.0, 1.0], [30.300079345703125, 20.399940490722656,
                            0.9999980926513672],
    ], np.float32)
    xyz, valid = _padded(pts, 256)
    return xyz, valid, 0.5


def _frontier():
    """A tight blob that converges in its first round beside the long
    chain, which needs many."""
    rng = np.random.default_rng(5)
    blob = rng.normal([60.0, 60.0, 0.0], 0.05, (100, 3)).astype(np.float32)
    xyz, valid = _padded(np.vstack([blob, _serpentine(0.5)]), 1280)
    return xyz, valid, 0.5


SCENES = {"blobs": _blobs, "chain": _chain, "boundary": _boundary,
          "cars": _cars, "long_chain": _long_chain, "exact_r": _exact_r,
          "frontier": _frontier}


def _groups(labels, ok):
    g = collections.defaultdict(list)
    for i in np.nonzero(ok)[0]:
        g[labels[i]].append(i)
    return sorted(tuple(v) for v in g.values())


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_sweep_cluster_labels_matches_jax(scene):
    xyz, valid, r = SCENES[scene]()
    want, exact = jsweep.sweep_cluster_labels(
        jnp.asarray(xyz), jnp.asarray(valid), np.float32(r), wr=12,
        row_cap=32, use_kernel=True, interpret=True)
    assert bool(exact)
    kernels.reset_launch_counts()
    got, t_exact = sweep.sweep_cluster_labels(
        torch.from_numpy(xyz), torch.from_numpy(valid), np.float32(r), wr=12,
        row_cap=32)
    assert kernels.LAUNCHES["cluster_multisweep"] == 0
    assert bool(t_exact)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ok = valid & np.isfinite(xyz).all(axis=1)
    assert len(_groups(got.numpy(), ok)) >= 1


@pytest.mark.parametrize("scene", ["blobs", "cars"])
def test_cluster_multisweep_plain_vs_pallas(scene):
    xyz, valid, r = SCENES[scene]()
    r32 = np.float32(r)
    hi = np.abs(np.where((valid & np.isfinite(xyz).all(1))[:, None], xyz,
                         0)).max()
    cell = jsweep.cluster_cell_size(jnp.float32(r32), jnp.float32(hi))
    s = jsweep._sorted_structure(jnp.asarray(xyz), jnp.asarray(valid), cell,
                                 12, jsweep.SWEEP_TABLE_SIZE)
    rowlist, _ = jsweep._window_row_lists(s["starts_skip"], 32, s["nrows"])
    lab, ch = jpk.cluster_multisweep(s["planar"], rowlist, r32 * r32, cap=32,
                                     sweeps=12, interpret=True)
    assert float(np.asarray(ch).sum()) == 0.0  # the Pallas run converged
    got, changed, rounds = kernels.cluster_multisweep(
        to_torch(s["planar"]), to_torch(rowlist), float(r32 * r32), cap=32)
    assert not changed.any() and rounds <= 64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(lab).astype(np.int32))


def test_cluster_round_cap_reports_not_exact():
    xyz, valid, r = _chain()
    _, exact = sweep.sweep_cluster_labels(
        torch.from_numpy(xyz), torch.from_numpy(valid), np.float32(r), wr=12,
        row_cap=32, max_iters=1)
    assert not bool(exact)


def _list_inputs(xyz, valid, r, cap):
    """Kernel 4's inputs as `sweep_cluster_labels` builds them (wr 12):
    (planar, rowlist, r2)."""
    t = torch.from_numpy(xyz)
    use = torch.from_numpy(valid) & torch.isfinite(t).all(dim=1)
    hi = torch.where(use[:, None], t.abs(), 0.0).amax()
    r32 = np.float32(r)
    cell = sweep.cluster_cell_size(torch.tensor(r32), hi)
    s = sweep._sorted_structure(t, torch.from_numpy(valid), cell, 12,
                                sweep.SWEEP_TABLE_SIZE)
    rowlist, _ = sweep._window_row_lists(s["starts_skip"], cap, s["nrows"])
    return s["planar"], rowlist, float(r32 * r32)


def _one_launch_rounds(planar, rowlist, cap, r2, max_rounds, *, seed,
                       split, jumps=4):
    """The CUDA path's list rounds (csrc/cluster.cu `label_round`) in
    torch, the CTAs of a round run one after another in a random order
    (one of the orders the card may run them in, each reading the labels
    as those before it left them). Round k: CTA 0 of each live block
    jumps its queries' labels ``jumps`` steps; the block skips its hop
    unless its own row or a listed row has a stamp >= k - 1 (a jump that
    lowered a label stamps its own row); CTA p hops over the p-th of
    ``split`` shares of the list and hooks from its minima. Stops after
    the first round that lowered no label, or after ``max_rounds``.
    Returns (labels i32[NB*128], changed, rounds)."""
    nr, nb = planar.shape[0], rowlist.shape[0]
    lab = torch.arange(nr * 128)
    stamp = torch.zeros(nr, dtype=torch.long)
    last = torch.zeros(nb * 128, dtype=torch.long)
    valid = planar[:, 3] > 0.5
    big = torch.iinfo(torch.int32).max
    order = np.random.default_rng(seed)

    def lower(idx, vals, k):
        """atomicMins of ``vals`` into the labels at ``idx`` (in any order:
        the same minima); stamps the labels they lowered and returns how
        many there are."""
        before = lab[idx]
        lab.scatter_reduce_(0, idx, vals, reduce="amin")
        hit = idx[lab[idx] < before]
        stamp[hit // 128] = k
        last[hit] = k
        return len(hit)

    for k in range(1, max_rounds + 1):
        n = 0
        for c in order.permutation(nb * split).tolist():
            b, part = divmod(c, split)
            if rowlist[b, cap] == 0:
                continue
            own = torch.arange(b * 128, (b + 1) * 128)
            if part == 0:
                to = lab[own]
                for _ in range(jumps):
                    to = lab[to]
                n += lower(own, to, k)
            rows = rowlist[b, :min(int(rowlist[b, cap + 1]), cap)].long()
            if k > 1 and not (stamp[b] >= k - 1 or
                              bool((stamp[rows] >= k - 1).any())):
                continue
            share = rows[len(rows) * part // split:
                         len(rows) * (part + 1) // split]
            start = torch.where(valid[b], lab[own], big)
            m = start
            if len(share):
                cand = planar[share].permute(1, 0, 2).reshape(4, -1)
                near = kernels._within_r2(planar[b][None], cand[None], r2)[0]
                clab = lab[(share[:, None] * 128
                            + torch.arange(128)).reshape(-1)]
                m = torch.minimum(m, torch.where(near & (cand[3] > 0.5),
                                                 clab, big).amin(1))
            hop = valid[b] & (m < start)
            n += lower(own[hop], m[hop], k)
            n += lower(start[hop], m[hop], k)  # hook the old roots
        if n == 0:
            break
    changed = (last == k).to(torch.int32)
    return lab[:nb * 128].to(torch.int32), changed, k


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("scene", ["blobs", "cars", "exact_r", "frontier"])
def test_one_launch_list_rounds_reach_the_plain_fixpoint(scene, split):
    """The CUDA path's round schedule (jumps folded into the next round,
    the frontier of round stamps, a block's list split over CTAs) reaches
    the plain version's fixpoint in any block order; a run cut after one
    round reports a change."""
    xyz, valid, r = SCENES[scene]()
    planar, rowlist, r2 = _list_inputs(xyz, valid, r, 16)
    want, wch, _ = kernels.cluster_multisweep_plain(planar, rowlist, r2,
                                                    cap=16, max_rounds=64)
    assert not wch.any()
    for seed in range(2):
        got, ch, rounds = _one_launch_rounds(planar, rowlist, 16, r2, 64,
                                             seed=seed, split=split)
        assert not ch.any() and rounds < 64
        assert torch.equal(got, want)
    cut = _one_launch_rounds(planar, rowlist, 16, r2, 1, seed=0, split=split)
    assert cut[2] == 1 and cut[1].any()


def _slab():
    """The dense slab of tests/test_sweep_cluster.py: per-block candidate
    rows overflow any practical flat row list."""
    rng = np.random.default_rng(11)
    xyz = np.vstack([
        (rng.random((3500, 3)) * [2.0, 2.0, 0.05]).astype(np.float32),
        (rng.random((596, 3)) * 12.0 + 8.0).astype(np.float32),
    ]).astype(np.float32)
    return xyz, np.ones(len(xyz), bool), 0.5


def _window_inputs(xyz, valid, r, wr):
    r32 = np.float32(r)
    hi = np.abs(np.where((valid & np.isfinite(xyz).all(1))[:, None], xyz,
                         0)).max()
    cell = jsweep.cluster_cell_size(jnp.float32(r32), jnp.float32(hi))
    s = jsweep._sorted_structure(jnp.asarray(xyz), jnp.asarray(valid), cell,
                                 wr, jsweep.SWEEP_TABLE_SIZE)
    return s, float(r32 * r32)


def test_cluster_windows_plain_vs_pallas():
    xyz, valid, r = _slab()
    s, r2 = _window_inputs(xyz, valid, r, 32)
    lab, ch = jpk.cluster_multisweep_windows(s["planar"], s["starts_skip"],
                                             r2, sweeps=12, interpret=True)
    assert float(np.asarray(ch).sum()) == 0.0  # the Pallas run converged
    kernels.reset_launch_counts()
    got, changed, rounds = kernels.cluster_multisweep_windows(
        to_torch(s["planar"]), to_torch(s["starts_skip"]), r2, max_rounds=64)
    assert kernels.LAUNCHES["cluster_multisweep_windows"] == 0  # CPU: plain
    assert not changed.any() and rounds <= 64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(lab).astype(np.int32))
    # Resuming from the fixpoint: one round, no change, the same labels.
    again, changed, rounds = kernels.cluster_multisweep_windows(
        to_torch(s["planar"]), to_torch(s["starts_skip"]), r2, max_rounds=64,
        labels0=got)
    assert rounds == 1 and not changed.any()
    assert torch.equal(again, got)


def test_cluster_windows_resume_reaches_fixpoint():
    """A run cut after one round, resumed from its labels, ends where an
    uncut run ends."""
    xyz, valid, r = _chain()
    s, r2 = _window_inputs(xyz, valid, r, 12)
    planar, starts = to_torch(s["planar"]), to_torch(s["starts_skip"])
    full, _, full_rounds = kernels.cluster_multisweep_windows(
        planar, starts, r2, max_rounds=64)
    cut, changed, _ = kernels.cluster_multisweep_windows(planar, starts, r2,
                                                         max_rounds=1)
    assert full_rounds > 1 and changed.any()
    resumed, changed, _ = kernels.cluster_multisweep_windows(
        planar, starts, r2, max_rounds=64, labels0=cut)
    assert not changed.any()
    assert torch.equal(resumed, full)


@pytest.mark.parametrize("rep_labels", [True, False])
def test_sweep_cluster_labels_windows_matches_jax(rep_labels):
    xyz, valid, r = _slab()
    want, exact = jsweep.sweep_cluster_labels(
        jnp.asarray(xyz), jnp.asarray(valid), np.float32(r), wr=32,
        row_cap=None, use_kernel=True, interpret=True, rep_labels=rep_labels)
    assert bool(exact)
    got, t_exact = sweep.sweep_cluster_labels(
        torch.from_numpy(xyz), torch.from_numpy(valid), np.float32(r), wr=32,
        row_cap=None, rep_labels=rep_labels)
    assert bool(t_exact)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sweep_cluster_labels_windows_burst_cap_not_exact(monkeypatch):
    """A chain that needs several rounds: one round and no resume cannot
    converge, and says so; the resume bursts finish it."""
    xyz, valid, r = _chain()
    args = (torch.from_numpy(xyz), torch.from_numpy(valid), np.float32(r))
    with monkeypatch.context() as m:
        m.setattr(sweep, "_RESUME_BURSTS", 0)
        _, exact = sweep.sweep_cluster_labels(*args, wr=12, row_cap=None,
                                              sweeps=1)
    assert not bool(exact)
    labels, exact = sweep.sweep_cluster_labels(*args, wr=12, row_cap=None,
                                               sweeps=1)
    assert bool(exact) and (labels[:400] == 0).all()


# "dead_block": the long chain with block 4's row marked invalid by the
# test: a block with no valid query, and a candidate row whose 128
# candidates are all invalid (the chain splits there).
WINDOW_SCENES = {"long_chain": _long_chain, "exact_r": _exact_r,
                 "dead_block": _long_chain, "frontier": _frontier}


@pytest.mark.parametrize("scene", sorted(WINDOW_SCENES))
def test_cluster_windows_scenes_plain_vs_pallas(scene):
    """The window rounds' plain version against the Pallas kernel, labels
    equal at the fixpoint; on the long chain a run cut after one round
    reports it and resumes to the same fixpoint."""
    xyz, valid, r = WINDOW_SCENES[scene]()
    s, r2 = _window_inputs(xyz, valid, r, 12)
    planar, starts = np.array(s["planar"]), np.array(s["starts_skip"])
    if scene == "dead_block":
        assert planar[4, 3].all() and starts[4, 27] != 0
        planar[4, 3] = 0.0
        starts[4, 27] = 0
    lab, ch = jpk.cluster_multisweep_windows(jnp.asarray(planar),
                                             jnp.asarray(starts), r2,
                                             sweeps=12, interpret=True)
    assert float(np.asarray(ch).sum()) == 0.0  # the Pallas run converged
    tp, ts = torch.from_numpy(planar), torch.from_numpy(starts)
    got, changed, rounds = kernels.cluster_multisweep_windows(
        tp, ts, r2, max_rounds=64)
    assert not changed.any() and 1 < rounds <= 64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(lab).astype(np.int32))
    if scene == "long_chain":
        assert rounds > 4  # more than one read batch of the CUDA path
        cut, changed, _ = kernels.cluster_multisweep_windows(tp, ts, r2,
                                                             max_rounds=1)
        assert changed.any()
        again, changed, _ = kernels.cluster_multisweep_windows(
            tp, ts, r2, max_rounds=64, labels0=cut)
        assert not changed.any() and torch.equal(again, got)


@pytest.mark.parametrize("scene", ["long_chain", "exact_r", "frontier"])
def test_sweep_cluster_labels_windows_scenes_match_jax(scene):
    """The window path (`cluster_multisweep_windows`, no row cap) of
    `sweep_cluster_labels` against the JAX one."""
    xyz, valid, r = SCENES[scene]()
    want, exact = jsweep.sweep_cluster_labels(
        jnp.asarray(xyz), jnp.asarray(valid), np.float32(r), wr=12,
        row_cap=None, sweeps=12, use_kernel=True, interpret=True)
    assert bool(exact)
    got, t_exact = sweep.sweep_cluster_labels(
        torch.from_numpy(xyz), torch.from_numpy(valid), np.float32(r), wr=12,
        row_cap=None, sweeps=12)
    assert bool(t_exact)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if scene == "exact_r":  # linked at r2, apart just beyond it
        g = got.numpy()
        assert g[0] == g[1] == g[2] == g[3] and g[6] == g[7]
        assert g[4] != g[5] and g[8] != g[9]
