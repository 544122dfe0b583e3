"""The cell-grid kNN rungs of the PyTorch port against the JAX package on
the CPU: `cellgrid.point_knn`, `slab_knn` and `point_radius_count`, the
rungs `engine.knn` takes (spied in both packages), and
`engine.radius_count`.

Tolerances: both packages take the cell grid's d2 form, fma(dz, dz, fma(dy,
dy, dx*dx)), over the same candidates, so `nvalid`, `point_ok` and counts
are equal, and distances agree to rtol 2e-7 (rows patched by a brute
force may come from its other preselection). Index sets are compared
sorted, on the rows whose kth neighbour is not tied with the (k+1)th (the
reference's k-step argmin keeps candidate order at a tie, the port orders
ties by row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.core.cloud import make_cloud_arrays as jax_cloud
from pointclouds_tpu.ops import fusedops as jfused
from pointclouds_tpu.spatial import cellgrid as jcg
from pointclouds_tpu.spatial import engine as jengine
import pointclouds_tpu_torch as port
from pointclouds_tpu_torch.ops import fusedops
from pointclouds_tpu_torch.spatial import cellgrid as tcg
from pointclouds_tpu_torch.spatial import engine, kernels


def _uniform(seed, n, box, far=0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, box, (n, 3)).astype(np.float32)
    if far:
        xyz[-far:] = rng.uniform(-0.5 * box, 1.5 * box, (far, 3))
    return xyz, rng.random(n) > 0.05


def _lattice(step=0.25, side=14):
    g = np.arange(side, dtype=np.float32) * np.float32(step)
    xyz = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    return xyz, np.ones(len(xyz), bool)


def _queries(seed, n, lo, hi):
    """Queries with NaN rows and masked rows."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    qv = rng.random(n) > 0.1
    q[::37] = np.nan
    return q, qv


def _decided(pts, pvalid, q, qvalid, k):
    """Rows whose kth and (k+1)th float64 distances differ (or with fewer
    than k + 1 valid points in reach: all of their k are the set)."""
    p = pts[pvalid & np.isfinite(pts).all(1)].astype(np.float64)
    d = np.sqrt(((q[:, None, :].astype(np.float64) - p[None]) ** 2).sum(-1))
    d = np.sort(d, axis=1)
    use = qvalid & np.isfinite(q).all(1)
    return ~use | (d[:, k] - d[:, k - 1] > 1e-6 * np.maximum(d[:, k], 1e-30))


def _close_rows(got, want, decided):
    """(dists, idx, nvalid[, point_ok]) against the reference's."""
    np.testing.assert_array_equal(got[2], want[2])
    if len(want) > 3:
        np.testing.assert_array_equal(got[3], want[3])
    fin = want[2]
    np.testing.assert_allclose(got[0][fin], want[0][fin], rtol=2e-7, atol=0)
    assert (~np.isfinite(got[0][~fin])).all()
    gi, wi = (np.sort(np.where(x[2], x[1], -1), axis=1) for x in (got, want))
    np.testing.assert_array_equal(gi[decided], wi[decided])


def _grids(xyz, valid, cell, m, cap=4096):
    jg = jcg.build_cellgrid(jnp.asarray(xyz), jnp.asarray(valid),
                            jnp.float32(cell), m_per_cell=m, cell_cap=cap)
    tg = tcg.build_cellgrid(torch.from_numpy(xyz), torch.from_numpy(valid),
                            np.float32(cell), m_per_cell=m, cell_cap=cap)
    return jg, tg


GRID_CASES = {
    # name: (cloud, cell, m, k, queries)
    "uniform_k10": (_uniform(0, 3000, 6.0), 0.8, 16, 10, (1, 700, -1, 7)),
    "uniform_k30": (_uniform(1, 3000, 6.0), 0.8, 16, 30, (2, 700, -1, 7)),
    "lattice_ties": (_lattice(), 0.6, 32, 10, (3, 500, 0.0, 3.25)),
    "k_above_27m": (_uniform(4, 2500, 6.0), 0.5, 1, 30, (5, 300, 0, 6)),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_point_and_slab_knn_match_jax(case):
    (xyz, valid), cell, m, k, qspec = GRID_CASES[case]
    q, qv = _queries(*qspec)
    jg, tg = _grids(xyz, valid, cell, m)
    kernels.reset_launch_counts()
    for jfn, tfn, (qq, qqv) in ((jcg.point_knn, tcg.point_knn, (q, qv)),
                                (jcg.slab_knn, tcg.slab_knn, (xyz, valid))):
        want = [np.asarray(a) for a in jfn(jg, jnp.asarray(qq),
                                           jnp.asarray(qqv), k=k)]
        got = [a.numpy() for a in tfn(tg, torch.from_numpy(qq),
                                      torch.from_numpy(qqv), k=k)]
        assert got[0].shape == (len(qq), k) and got[1].dtype == np.int32
        _close_rows(got, want, _decided(xyz, valid, qq, qqv, k))
        if case == "k_above_27m":  # padded and flagged
            assert not got[3][qqv & np.isfinite(qq).all(1)].any()
        else:
            assert got[3].mean() > 0.1
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # torch ops


@pytest.mark.parametrize("radius", [0.3, 0.8])
def test_point_radius_count_matches_jax(radius):
    xyz, valid = _lattice(0.2, 16)  # pairs at exactly d2 == r2 at r 0.8
    q, qv = _queries(6, 600, -0.5, 3.5)
    q[:50] = xyz[::80][:50]  # queries on the lattice
    qv[:50] = True
    jg, tg = _grids(xyz, valid, radius * 1.001, 64)
    want = np.asarray(jcg.point_radius_count(jg, jnp.asarray(q),
                                             jnp.asarray(qv), radius))
    got = tcg.point_radius_count(tg, torch.from_numpy(q),
                                 torch.from_numpy(qv), radius).numpy()
    assert got.dtype == np.int32 and got[:50].min() >= 1
    np.testing.assert_array_equal(got, want)


# ── engine.knn's rungs, spied in both packages ───────────────────────────────


def _spy(monkeypatch, eng, fused_mod, cg_build, to_np):
    """Record the rungs ``eng.knn`` takes: the sweeps, each grid built
    (capacity, cell cap), each grid query with its flagged rows, and each
    brute force with its valid queries."""
    log = []

    def wrap(mod, name, record):
        orig = getattr(mod, name)

        def fn(*a, **kw):
            out = orig(*a, **kw)
            log.append(record(a, kw, out))
            return out
        monkeypatch.setattr(mod, name, fn)

    wrap(fused_mod, "knn_fused", lambda a, kw, out: "sweep same")
    wrap(eng, "build_cellgrid", lambda a, kw, out: (
        "grid", kw["m_per_cell"], kw["cell_cap"], round(float(a[2]), 6)))
    for name in ("point_knn", "slab_knn"):
        wrap(eng, name, lambda a, kw, out, name=name: (
            name, int((~to_np(out[3])).sum())))
    wrap(eng, "bruteforce_knn", lambda a, kw, out: (
        "brute", int(to_np(a[3]).sum())))
    return log


def _engine_case(case):
    """(points, point mask, queries or None for the same cloud, k)."""
    pxyz, pvalid = _uniform(10, 4096, 10.0)
    if case == "k30_same":
        return pxyz, pvalid, None, 30
    if case == "cross_1000":
        return pxyz, pvalid, _queries(11, 1000, 1.5, 8.5), 10
    if case == "coarse_then_brute":  # queries past the faces, and far ones
        q, qv = _queries(12, 1500, -1.0, 11.0)
        q[1:40] += 30.0
        return pxyz, pvalid, (q, qv), 8
    if case == "sweep_same_gives_up":
        return pxyz, pvalid, None, 8
    # sweep_cross_gives_up: more than 4,096 of 6,000 queries far outside.
    q, qv = _queries(13, 6000, 20.0, 60.0)
    q[:600] = _queries(14, 600, 0.0, 10.0)[0]
    return pxyz, pvalid, (q, qv), 6


# The rungs each case takes (the grids built between them left out). At
# 4,096 points in a 10 m box the faces flag rows: a 1,000-query batch takes
# the coarse pass (2.5x cell) for them; at k 30 the coarse grid holds more
# than 128 points a cell, so the flagged rows go to the brute force.
ENGINE_RUNGS = {
    "k30_same": ("slab_knn", "brute"),
    "cross_1000": ("point_knn", "point_knn"),
    "coarse_then_brute": ("point_knn", "point_knn", "brute"),
    "sweep_same_gives_up": ("sweep same", "slab_knn", "point_knn"),
    "sweep_cross_gives_up": ("point_knn", "brute"),
}


@pytest.mark.parametrize("case", sorted(ENGINE_RUNGS))
def test_engine_knn_rungs_match_jax(case, monkeypatch):
    pxyz, pvalid, qs, k = _engine_case(case)
    if case == "sweep_same_gives_up":  # the fused rescue cap overflows
        monkeypatch.setattr(fusedops, "fused_rescue_cap", lambda n: 4)
        monkeypatch.setattr(jfused, "fused_rescue_cap", lambda n: 4)
    jlog = _spy(monkeypatch, jengine, jfused, jcg, np.asarray)
    tlog = _spy(monkeypatch, engine, fusedops, tcg, lambda t: t.numpy())
    pj = (jnp.asarray(pxyz), jnp.asarray(pvalid))
    pt = (torch.from_numpy(pxyz), torch.from_numpy(pvalid))
    if qs is None:
        qj, qt, (q, qv) = pj, pt, (pxyz, pvalid)
    else:
        q, qv = qs
        qj = (jnp.asarray(q), jnp.asarray(qv))
        qt = (torch.from_numpy(q), torch.from_numpy(qv))
    want = [np.asarray(a) for a in jengine.knn(*pj, *qj, k)]
    kernels.reset_launch_counts()
    got = [a.numpy() for a in engine.knn(*pt, *qt, k)]
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # CPU: plain
    assert tlog == jlog
    names = tuple(e if isinstance(e, str) else e[0] for e in tlog
                  if e[0] != "grid")
    assert names == ENGINE_RUNGS[case], tlog
    flagged = [e[1] for e in tlog if e[0] in ("point_knn", "slab_knn")]
    if len(flagged) == 2:  # pass 1 flagged rows, the coarse pass fewer
        assert flagged[0] > flagged[1]
    decided = _decided(pxyz, pvalid, q, qv, k)
    _close_rows(got, want, decided)


# ── engine.radius_count ──────────────────────────────────────────────────────


def _both(data):
    a = jax_cloud(data)
    t = port.make_cloud_arrays(data, device="cpu")
    return (a.xyz, a.valid), (t.xyz, t.valid)


def test_radius_count_differential():
    rng = np.random.default_rng(9)
    data = (rng.random((3000, 3)) * 5).astype(np.float32)
    r = 0.35
    (jx, jv), (tx, tv) = _both(data)
    counts = engine.radius_count(tx, tv, tx, tv, r).numpy()
    assert counts.dtype == np.int32
    np.testing.assert_array_equal(
        counts, np.asarray(jengine.radius_count(jx, jv, jx, jv, r)))
    d = np.linalg.norm(data[None, :, :].astype(np.float64)
                       - data[:, None, :].astype(np.float64), axis=2)
    np.testing.assert_array_equal(counts[: len(data)], (d <= r).sum(axis=1))


def test_radius_count_boundary_inclusive_and_degenerate():
    data = np.array([[0, 0, 0], [1.0, 0, 0], [2.0001, 0, 0]], np.float32)
    (jx, jv), (tx, tv) = _both(data)
    counts = engine.radius_count(tx, tv, tx, tv, 1.0).numpy()
    np.testing.assert_array_equal(counts[:3], [2, 2, 1])
    np.testing.assert_array_equal(
        counts, np.asarray(jengine.radius_count(jx, jv, jx, jv, 1.0)))
    for r in (0.0, -1.0, float("inf"), float("nan")):
        got = engine.radius_count(tx, tv, tx, tv, r).numpy()
        assert got.dtype == np.int32 and not got.any()


def test_radius_count_grid_rungs_match_jax(monkeypatch):
    """A lattice with pairs at exactly the radius (the grid rung, capacity
    grown past 16), NaN and masked queries, and the int64 grid with the
    limit lowered to 4096 in both packages."""
    xyz, valid = _lattice(0.25, 18)
    q, qv = _queries(15, 900, -0.5, 4.5)
    q[:100] = xyz[::50][:100]
    qv[:100] = True
    calls = []
    orig = tcg.point_radius_count
    monkeypatch.setattr(engine, "point_radius_count",
                        lambda *a: calls.append(1) or orig(*a))
    jp, jq = (jnp.asarray(xyz), jnp.asarray(valid)), (jnp.asarray(q),
                                                      jnp.asarray(qv))
    tp, tq = (torch.from_numpy(xyz), torch.from_numpy(valid)), (
        torch.from_numpy(q), torch.from_numpy(qv))
    for r in (0.5, 0.75):
        got = engine.radius_count(*tp, *tq, r).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jengine.radius_count(*jp, *jq, r)))
        assert got[:100].min() > 1
    assert len(calls) == 2
    monkeypatch.setattr(engine, "CELLGRID_MAX_N", 4096)
    monkeypatch.setattr(jengine, "CELLGRID_MAX_N", 4096)
    got = engine.radius_count(*tp, *tq, 0.5).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jengine.radius_count(*jp, *jq, 0.5)))
    assert len(calls) == 2
