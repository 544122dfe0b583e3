"""Inclusive radius counts of the PyTorch port against the JAX package: the
plain versions of the `count_within`, `rescue_radius_count_groups` and
`brute_radius_count` kernels against the Pallas kernels in interpret mode
and their XLA mirrors, then `sweep_radius_count_two_pass` and
`engine.radius_count_sweep` end to end.

Counts are equal. Each input holds pairs whose pinned squared distance
fma(dz, dz, fma(dx, dx, dy*dy)) is exactly the radius^2 they are tested
against, so a kernel that computed d2 in another order would miscount
some of them (XLA's CPU backend gives the Pallas kernels and the mirrors
this form; measured).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.ops.registration import _to_planar as jplanar
from pointclouds_tpu.spatial import engine as jengine
from pointclouds_tpu.spatial import pallas_kernels as jpk
from pointclouds_tpu.spatial import sweep as jsweep
from pointclouds_tpu_torch.spatial import engine, kernels, sweep
from pointclouds_tpu_torch.utils.interop import to_torch

RADIUS = np.float32(0.5)


def _cloud(seed, n, frac_far=0.1):
    rng = np.random.default_rng(seed)
    nf = int(n * frac_far)
    xyz = np.vstack([rng.uniform(0, 6, (n - nf, 3)),
                     rng.uniform(-20, 30, (nf, 3))]).astype(np.float32)
    valid = rng.random(n) > 0.05
    xyz[~valid & (rng.random(n) > 0.5)] = np.nan
    return xyz, valid


def _pinned_d2(q, c):
    """[..., 3] f32 pairs -> the pinned d2 as float32 numpy."""
    q, c = torch.from_numpy(q), torch.from_numpy(c)
    d = q - c
    return kernels.fma_f32(d[..., 2], d[..., 2], kernels.fma_f32(
        d[..., 0], d[..., 0], d[..., 1] * d[..., 1])).numpy()


def _planar_points(planar):
    """[NR, 4, 128] -> ([NR*128, 3] coordinates, [NR*128] w)."""
    p = np.asarray(planar)
    return p[:, :3, :].transpose(0, 2, 1).reshape(-1, 3), p[:, 3, :].reshape(-1)


def _boundary_r2(q_xyz, q_live, cand_xyz, cand_live):
    """Per query, the pinned d2 to its nearest live candidate other than
    itself (a point exactly on that radius), or -1 for a dead query."""
    r2 = np.full(len(q_xyz), -1.0, np.float32)
    cx = cand_xyz[cand_live]
    for i in np.nonzero(q_live)[0]:
        d = _pinned_d2(np.broadcast_to(q_xyz[i], cx.shape).copy(), cx)
        d = d[d > 0]
        if d.size:
            r2[i] = d.min()
    return r2


@pytest.mark.parametrize("seed,radius", [
    pytest.param(0, RADIUS, id="0"), pytest.param(1, RADIUS, id="1"),
    pytest.param(2, np.float32(0.2), id="small_r2")])
def test_count_within_plain_matches_pallas_and_mirror(seed, radius):
    """"small_r2": r 0.2 (r2 0.04, far below the 0.5 validity threshold
    of the other walks) on the cloud scaled by 0.4, with one row's first
    half turned into masked duplicates (w = 0) of its second half."""
    xyz, valid = _cloud(seed, 3000)
    xyz = xyz * np.float32(radius / RADIUS)
    s = jsweep._radius_structure(jnp.asarray(xyz), jnp.asarray(valid),
                                 radius, 4, jsweep.SWEEP_TABLE_SIZE)
    planar = np.array(s["planar"])
    pts, w = _planar_points(planar)
    live = w > 0.5
    # Candidate j's radius^2 (its w) is its pinned d2 to the next sorted
    # point: an exact boundary pair wherever that point is in range.
    nxt = np.roll(pts, -1, axis=0)
    d2 = _pinned_d2(pts, nxt)
    on = live & np.roll(live, -1) & (d2 > 0) & (d2 <= radius * radius)
    wr2 = np.where(live, radius * radius, 0.0).astype(np.float32)
    wr2[on] = d2[on]
    planar[:, 3, :] = wr2.reshape(-1, 128)
    if radius < RADIUS:
        planar[2, :3, :64] = planar[2, :3, 64:]
        planar[2, 3, :64] = 0.0
    assert on.sum() > 1000
    starts = s["starts_skip"]
    pal = np.asarray(jpk.count_within(jnp.asarray(planar), starts, wr=4,
                                      interpret=True))
    mir = np.asarray(jsweep._count_within_xla(jnp.asarray(planar), starts,
                                              wr=4))
    kernels.reset_launch_counts()
    got = kernels.count_within(to_torch(planar), to_torch(starts)).numpy()
    assert kernels.LAUNCHES["count_within"] == 0  # CPU: plain
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(got, mir)
    assert got.sum() > 0


def _flagged_rescue_inputs(xyz, valid, wr, fix_cap):
    """JAX's pass-2 inputs of `sweep_radius_count_two_pass` (a small wr
    overflows many blocks' windows)."""
    s = jsweep._radius_structure(jnp.asarray(xyz), jnp.asarray(valid),
                                 RADIUS, wr, jsweep.SWEEP_TABLE_SIZE)
    _, ok = jsweep._radius_pass1(s, RADIUS, wr=wr, interpret=False,
                                 use_kernel=False)
    flagged = jnp.logical_and(s["use"], jnp.logical_not(ok))
    return jsweep._rescue_structure(s["planar"], s["order"], flagged,
                                    fix_cap, xyz.shape[0], RADIUS)


@pytest.mark.parametrize("case", ["boundary", "group_edge", "dead_block"])
def test_rescue_radius_count_plain_matches_pallas_and_mirror(case):
    """"boundary": each flagged query's r2 is the pinned d2 to its nearest
    live candidate (a point exactly on its radius, counted where the
    AABB prune kept its group); "group_edge": the pinned d2 to a random
    valid candidate of the query's own active groups (on the radius, so
    it always counts); "dead_block": the boundary case with one live query
    block made all invalid (r2 -1: it counts nothing)."""
    xyz, valid = _cloud(2, 4000)
    planar_g, q_planar, active, qvalid, _ = _flagged_rescue_inputs(
        xyz, valid, wr=1, fix_cap=512)
    qv = np.array(qvalid)
    assert qv.sum() > 200
    qp = np.array(q_planar)
    qxyz, _ = _planar_points(qp)
    gxyz, gw = _planar_points(planar_g)
    act = np.asarray(active)
    if case == "group_edge":
        rng = np.random.default_rng(2)
        r2 = np.full(len(qxyz), -1.0, np.float32)
        for b in range(act.shape[0]):
            rows = (act[b, 1:1 + act[b, 0], None] * 8
                    + np.arange(8)).reshape(-1)
            pos = (rows[:, None] * 128 + np.arange(128)).reshape(-1)
            pos = pos[gw[pos] > 0.5]
            live = np.nonzero(qv[b * 128:(b + 1) * 128])[0] + b * 128
            if live.size:
                pick = pos[rng.integers(0, len(pos), live.size)]
                r2[live] = _pinned_d2(qxyz[live], gxyz[pick])
    else:
        r2 = _boundary_r2(qxyz, qv, gxyz, gw > 0.5)
    if case == "dead_block":
        b = int(np.nonzero(qv.reshape(-1, 128).any(1))[0][0])
        r2[b * 128:(b + 1) * 128] = -1.0
        qv[b * 128:(b + 1) * 128] = False
    qp[:, 3, :] = r2.reshape(-1, 128)
    pal = np.asarray(jpk.rescue_radius_count_groups(
        planar_g, jnp.asarray(qp), active, gr=8, interpret=True))
    mir = np.asarray(jsweep._rescue_radius_count_xla(
        planar_g, jnp.asarray(qp), active, gr=8))
    got = kernels.rescue_radius_count_groups(
        to_torch(planar_g), to_torch(qp), to_torch(active), gr=8).numpy()
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(got, mir)
    if case == "group_edge":
        assert (got[qv] >= 1).all()
    else:
        assert (got[qv] >= 1).mean() > 0.9  # the boundary neighbour counted
    assert (got[~qv] == 0).all()


def test_brute_radius_count_plain_matches_pallas():
    xyz, valid = _cloud(3, 2500)
    use = valid & np.isfinite(xyz).all(1)
    rng = np.random.default_rng(3)
    rows = np.nonzero(use)[0][rng.permutation(use.sum())[:300]]
    sub = np.zeros((512, 3), np.float32)
    sub[:300] = xyz[rows]
    sub_valid = np.arange(512) < 300
    qp = np.array(jplanar(jnp.asarray(sub), jnp.asarray(sub_valid)))
    cand = jplanar(jnp.asarray(xyz), jnp.asarray(use))
    cxyz, cw = _planar_points(cand)
    qp[:, 3, :] = _boundary_r2(sub, sub_valid, cxyz, cw > 0.5).reshape(-1,
                                                                      128)
    pal = np.asarray(jpk.brute_radius_count(jnp.asarray(qp), cand,
                                            interpret=True))
    got = kernels.brute_radius_count(to_torch(qp), to_torch(cand)).numpy()
    np.testing.assert_array_equal(got, pal)
    assert (got[:300] >= 2).all()  # self and the boundary neighbour
    assert (got[300:] == 0).all()


@pytest.mark.parametrize("wr,fix_cap", [(4, 4096), (1, 256)])
def test_sweep_radius_count_two_pass_matches_jax(wr, fix_cap):
    xyz, valid = _cloud(4, 5000)
    want_c, want_ok = (np.asarray(a) for a in
                       jsweep.sweep_radius_count_two_pass(
                           jnp.asarray(xyz), jnp.asarray(valid), RADIUS,
                           fix_cap=fix_cap, wr=wr, use_kernel=False))
    got_c, got_ok = (a.numpy() for a in sweep.sweep_radius_count_two_pass(
        torch.from_numpy(xyz), torch.from_numpy(valid), RADIUS,
        fix_cap=fix_cap, wr=wr))
    np.testing.assert_array_equal(got_ok, want_ok)
    np.testing.assert_array_equal(got_c[want_ok], want_c[want_ok])
    if fix_cap < 4096:
        assert (~want_ok & valid).any()  # the rescue overflowed


def test_radius_count_sweep_matches_jax():
    xyz, valid = _cloud(5, 5000)
    want = np.asarray(jengine.radius_count_sweep(
        jnp.asarray(xyz), jnp.asarray(valid), float(RADIUS)))
    got = engine.radius_count_sweep(torch.from_numpy(xyz),
                                    torch.from_numpy(valid),
                                    float(RADIUS)).numpy()
    np.testing.assert_array_equal(got, want)
