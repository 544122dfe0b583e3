"""The int64-keyed grid of the PyTorch port against the JAX package on the
CPU: `build_grid`, `grid_knn`, `grid_radius_count`,
`grid_radius_neighbors`, `segmentation.propagate_labels`,
`engine.radius_neighbors`, and the clustering rung they form ahead of the
brute force.

Tolerances: both sides gather the same candidates in the same sorted order
with the same pinned d2 (fma(dz, dz, fma(dy, dy, dx*dx))), so keys,
orders, counts, lists, flags and labels are equal, and distances bitwise;
kNN indices are compared where ``nvalid`` holds (an empty slot carries an
arbitrary row in the JAX package).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu import api as japi
from pointclouds_tpu.ops import segmentation as jseg
from pointclouds_tpu.spatial import engine as jengine
from pointclouds_tpu.spatial import grid as jgrid
from pointclouds_tpu.spatial import knn as jknn
from pointclouds_tpu_torch import api
from pointclouds_tpu_torch.ops import segmentation
from pointclouds_tpu_torch.spatial import engine, grid, knn


def _cloud(seed, n, box=10.0, offset=0.0):
    """Uniform points with invalid and NaN rows and a duplicate pair."""
    rng = np.random.default_rng(seed)
    xyz = (rng.uniform(0, box, (n, 3)) + offset).astype(np.float32)
    valid = rng.random(n) > 0.05
    xyz[~valid & (rng.random(n) > 0.5)] = np.nan
    xyz[3] = xyz[4]
    valid[3] = valid[4] = True
    return xyz, valid


def _both(xyz, valid):
    return ((torch.from_numpy(xyz), torch.from_numpy(valid)),
            (jnp.asarray(xyz), jnp.asarray(valid)))


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.mark.parametrize("seed,n,cell,offset", [
    (0, 3000, 0.7, 0.0), (1, 2500, 0.05, -5.0), (2, 4000, 2.3, 1e5)])
def test_build_grid_matches_jax(seed, n, cell, offset):
    xyz, valid = _cloud(seed, n, offset=offset)
    (t, tv), (j, jv) = _both(xyz, valid)
    got = grid.build_grid(t, tv, cell)
    want = jgrid.build_grid(j, jv, cell)
    for name in ("sorted_keys", "sorted_idx", "num_valid", "cell_size"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      _np(getattr(want, name)), name)
    np.testing.assert_array_equal(_np(got.sorted_xyz), _np(want.sorted_xyz))
    s, e = grid.candidate_ranges(got, t[:200])
    js, je = jgrid.candidate_ranges(want, j[:200])
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))


@pytest.mark.parametrize("seed,n,k,cell,m,offset", [
    (3, 3000, 10, 1.4, 16, 0.0),     # certified
    (4, 2000, 10, 0.05, 16, 0.0),    # a tiny cell: insufficient
    (5, 5000, 8, 2.5, 16, 0.0),      # cells over M: overflow
    (6, 3000, 40, 0.4, 1, 0.0),      # 27 slots < k: padded columns
    (7, 2500, 6, 1.2, 32, 2e5),      # far from the origin: the f32 margin
])
def test_grid_knn_matches_jax(seed, n, k, cell, m, offset):
    xyz, valid = _cloud(seed, n, offset=offset)
    (t, tv), (j, jv) = _both(xyz, valid)
    rng = np.random.default_rng(seed + 50)
    q = np.concatenate([xyz[:n // 2], (rng.uniform(-1, 11, (300, 3))
                                       + offset).astype(np.float32)])
    qv = rng.random(len(q)) > 0.1
    q[7] = np.nan
    got = knn.grid_knn(grid.build_grid(t, tv, cell), torch.from_numpy(q),
                       torch.from_numpy(qv), k, m)
    want = jknn.grid_knn(jgrid.build_grid(j, jv, cell), jnp.asarray(q),
                         jnp.asarray(qv), k, m)
    d, i, v, over, insuff = (_np(a) for a in got)
    jd, ji, jv_, jover, jinsuff = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(v, jv_)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(np.where(v, i, -1), np.where(jv_, ji, -1))
    assert (bool(over), bool(insuff)) == (bool(jover), bool(jinsuff))
    if cell == 0.05:
        assert bool(insuff)  # as tests/test_spatial.py's tiny-cell case
    if m == 16 and cell == 2.5:
        assert bool(over)


@pytest.mark.parametrize("seed,r,m", [(8, 0.6, 16), (9, 1.0, 8),
                                      (10, 0.35, 64)])
def test_grid_radius_queries_match_jax(seed, r, m):
    xyz, valid = _cloud(seed, 4000)
    (t, tv), (j, jv) = _both(xyz, valid)
    cell = jengine._fp_safe_radius_cell(r, 10.0)
    assert engine._fp_safe_radius_cell(r, 10.0) == cell
    tg, jg = grid.build_grid(t, tv, cell), jgrid.build_grid(j, jv, cell)
    for radius in (r, np.float32(r)):
        c, over = knn.grid_radius_count(tg, t, tv, radius, m)
        jc, jover = jknn.grid_radius_count(jg, j, jv, radius, m)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        assert bool(over) == bool(jover)
        idx, within, over = knn.grid_radius_neighbors(tg, t, tv, radius, m)
        jidx, jwithin, jover = jknn.grid_radius_neighbors(jg, j, jv, radius,
                                                          m)
        np.testing.assert_array_equal(within.numpy(), np.asarray(jwithin))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert bool(over) == bool(jover)


def _chain(n=300, step=0.5):
    return np.column_stack([np.arange(n) * step, np.zeros(n),
                            np.zeros(n)]).astype(np.float32)


@pytest.mark.parametrize("case", ["blobs", "chain"])
def test_propagate_labels_on_jax_lists(case):
    if case == "chain":
        xyz, r = _chain(), 0.5
        valid = np.ones(len(xyz), bool)
    else:
        xyz, valid = _cloud(11, 3000, box=12.0)
        r = 0.45
    j, jv = jnp.asarray(xyz), jnp.asarray(valid)
    jidx, jwithin = jengine.radius_neighbors(j, jv, r)
    want = np.asarray(jseg.propagate_labels(jidx, jwithin, jv))
    got = segmentation.propagate_labels(
        torch.tensor(np.asarray(jidx)), torch.tensor(np.asarray(jwithin)),
        torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "chain":
        assert (got.numpy() == 0).all()
    else:
        assert len(np.unique(want)) > 100


@pytest.mark.parametrize("case", ["uniform", "far", "pathological"])
def test_radius_neighbors_matches_jax(case):
    if case == "pathological":
        # tests/test_segmentation.py's case: one cell above every capacity.
        rng = np.random.default_rng(77)
        xyz = np.vstack([rng.random((2000, 3)) * 0.05,
                         rng.random((50, 3)) * 0.05 + 100.0]).astype(
                             np.float32)
        valid, r = np.ones(len(xyz), bool), 1.0
    else:
        xyz, valid = _cloud(12, 3000, offset=1e5 if case == "far" else 0.0)
        r = 0.5
    (t, tv), (j, jv) = _both(xyz, valid)
    got = engine.radius_neighbors(t, tv, r)
    want = jengine.radius_neighbors(j, jv, r)
    if case == "pathological":
        assert got is None and want is None
        return
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_cluster_rung_before_bruteforce(monkeypatch):
    """Near 1e6 m the cell-graph rung's cell is <= 0, so the reference
    takes the int64 grid's lists and propagation; the port must too, not
    the O(N^2) brute force."""
    rng = np.random.default_rng(13)
    pts = (np.float64(1e6) + rng.uniform(0, 6, (480, 3))).astype(np.float32)
    ext = engine._extent(torch.from_numpy(pts), torch.ones(480, dtype=bool))
    assert 0.5 * 0.5 * (1 - 1e-5) - ext[2] * 3e-7 <= 0
    calls = []

    def spy(*a, **k):
        calls.append(1)
        raise AssertionError("bruteforce_cluster_labels called")

    monkeypatch.setattr(segmentation, "bruteforce_cluster_labels", spy)
    got = api.euclidean_cluster(api.PointCloud.from_numpy(pts, device="cpu"),
                                0.5, 1, 10**9)
    want = japi.euclidean_cluster(japi.PointCloud.from_numpy(pts), 0.5, 1,
                                  10**9)
    assert not calls
    assert got == want
    assert 1 < len(got) < 480
