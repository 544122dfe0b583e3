"""The PyTorch port's public API against the JAX package's, on the same numpy
clouds, with the port on the CPU (its plain kernels).

SOR, ROR, voxel, passthrough and the transform give bitwise equal points
in the same order; the RANSAC plane and inlier list are equal; normals
agree within atol 1e-5 with the same orientation (on noisy surfaces, where
a normal is defined to f32 precision whichever exact path computed it).
The clouds exceed `engine.BRUTE_THRESHOLD` rows, so the sweeps run; small
clouds take the brute-force branches. Forcing a small rescue capacity in
both packages sends the fused ops down their exact engine fallbacks.
"""

import numpy as np
import pytest
import torch

import pointclouds_tpu.api as japi
from pointclouds_tpu.ops import fusedops as jfused
from pointclouds_tpu.spatial import engine as jengine
from pointclouds_tpu_torch import api
from pointclouds_tpu_torch.ops import fusedops
from pointclouds_tpu_torch.spatial import engine, kernels


def _noisy(seed, n, n_out):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    pts[:n_out] = rng.uniform(-20, 30, (n_out, 3))
    pts[n_out] = pts[n_out + 1]  # a duplicate point
    return pts


def _surface(seed, n):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 12, (n, 2))
    z = 0.4 * np.sin(xy[:, 0] * 0.7) * np.cos(xy[:, 1] * 0.5) + rng.normal(
        0, 0.01, n)
    return np.column_stack([xy, z]).astype(np.float32)


def _pair(pts):
    return (japi.PointCloud.from_numpy(pts),
            api.PointCloud.from_numpy(pts, device="cpu"))


OPS = {
    "voxel_downsample": lambda m, c: m.voxel_downsample(c, 0.5),
    "passthrough_filter": lambda m, c: m.passthrough_filter(c, "y", 2.0,
                                                            8.0),
    "statistical_outlier_removal": lambda m, c:
        m.statistical_outlier_removal(c, 10, 2.0),
    "radius_outlier_removal": lambda m, c: m.radius_outlier_removal(c, 0.5,
                                                                    5),
    "apply_transform": lambda m, c: m.apply_transform(
        c, [[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]],
        [1.5, -2.0, 0.25]),
}


@pytest.mark.parametrize("n", [5000, 1500])
@pytest.mark.parametrize("op", sorted(OPS))
def test_filters_bitwise_equal_jax(op, n):
    j, t = _pair(_noisy(n, n, n // 50))
    kernels.reset_launch_counts()
    got, want = OPS[op](api, t), OPS[op](japi, j)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert got.device == torch.device("cpu")
    assert got.len() == want.len() and 0 < got.len() <= t.len()
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("n,k", [(5000, 10), (1500, 6)])
def test_estimate_normals_matches_jax(n, k):
    pts = _surface(n, n)
    j, t = _pair(pts)
    vp = (3.0, -2.0, 40.0)
    for got, want in (
            (api.estimate_normals_with_viewpoint(t, k, vp),
             japi.estimate_normals_with_viewpoint(j, k, vp)),
            (api.estimate_normals(t, k), japi.estimate_normals(j, k))):
        assert got.len() == n
        np.testing.assert_array_equal(got.to_numpy(), pts)
        np.testing.assert_allclose(got._normals_numpy(),
                                   want._normals_numpy(), atol=1e-5)
    assert api.estimate_normals(t, 0)._normals_numpy() is None


@pytest.mark.parametrize("n,iters,sub", [(5000, 200, None), (5000, 200, 512),
                                         (600, 50, None)])
def test_ransac_plane_seeded_matches_jax(n, iters, sub):
    pts = _surface(n + 1, n)
    pts[: n // 5] = np.random.default_rng(n).uniform(-5, 15, (n // 5, 3))
    j, t = _pair(pts)
    got = api.ransac_plane_seeded(t, 0.05, iters, 7, score_subsample=sub)
    want = japi.ransac_plane_seeded(j, 0.05, iters, 7, score_subsample=sub)
    assert (got.normal, got.d, got.inliers) == (want.normal, want.d,
                                                want.inliers)
    assert len(got.inliers) > 0 and repr(got) == repr(want)


def test_ransac_plane_finds_the_plane():
    pts = _surface(9, 3000)
    pts[:, 2] = 0.0
    t = api.PointCloud.from_numpy(pts, device="cpu")
    res = api.ransac_plane(t, 0.01, 100)
    assert abs(res.normal[2]) > 0.999 and len(res.inliers) == 3000


@pytest.mark.parametrize("call,exc", [
    (lambda m, c: m.voxel_downsample(c, 0.0), ValueError),
    (lambda m, c: m.voxel_downsample(c, float("inf")), ValueError),
    (lambda m, c: m.passthrough_filter(c, "w", 0.0, 1.0), ValueError),
    (lambda m, c: m.statistical_outlier_removal(c, -1, 1.0), ValueError),
    (lambda m, c: m.statistical_outlier_removal(c, 5, -1.0), ValueError),
    (lambda m, c: m.radius_outlier_removal(c, 0.0, 3), ValueError),
    (lambda m, c: m.radius_outlier_removal(c, float("nan"), 3), ValueError),
])
def test_validation_matches_jax(call, exc):
    j, t = _pair(_noisy(0, 20, 2))
    for m, c in ((japi, j), (api, t)):
        with pytest.raises(exc):
            call(m, c)


def test_edge_cases_match_jax():
    one = np.array([[1.0, 2.0, 3.0]], np.float32)
    j, t = _pair(one)
    for m, c in ((api, t), (japi, j)):
        assert m.statistical_outlier_removal(c, 3, 1.0).len() == 1
        assert m.statistical_outlier_removal(c, 0, 1.0).len() == 0
        assert m.ransac_plane_seeded(c, 0.1, 10, 1).inliers == []
    je, te = japi.PointCloud(), api.PointCloud(device="cpu")
    for name in ("voxel_downsample", "passthrough_filter",
                 "statistical_outlier_removal", "radius_outlier_removal"):
        out = OPS[name](api, te)
        assert out.len() == 0 and out.device == torch.device("cpu")
        assert OPS[name](japi, je).len() == 0


@pytest.mark.parametrize("op", ["sor", "ror", "normals"])
def test_rescue_cap_overflow_takes_the_engine_path(op, monkeypatch):
    """A rescue capacity below the flagged rows: both packages rerun the
    op through the exact engine path, with the same result."""
    rng = np.random.default_rng(3)
    pts = _surface(3, 5000) if op == "normals" else _noisy(3, 5000, 300)
    if op == "normals":
        pts[:300] = rng.uniform(-8, 20, (300, 3))
    elif op == "ror":
        # ROR flags only overflowing windows: a blob denser than the
        # window budget holds.
        pts[:3000] = rng.uniform(4.0, 4.4, (3000, 3))
    j, t = _pair(pts)
    calls = []
    engine_fn = {"sor": "sor_means", "ror": "radius_count_sweep",
                 "normals": "normals"}[op]
    for mod, fused in ((jengine, jfused), (engine, fusedops)):
        monkeypatch.setattr(fused, "fused_rescue_cap", lambda n: 8)
        orig = getattr(mod, engine_fn)

        def spy(*a, _orig=orig, **kw):
            calls.append(engine_fn)
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, engine_fn, spy)
    if op == "sor":
        got = api.statistical_outlier_removal(t, 10, 2.0)
        want = japi.statistical_outlier_removal(j, 10, 2.0)
    elif op == "ror":
        got = api.radius_outlier_removal(t, 0.5, 5)
        want = japi.radius_outlier_removal(j, 0.5, 5)
    else:
        got = api.estimate_normals(t, 10)
        want = japi.estimate_normals(j, 10)
    assert calls == [engine_fn, engine_fn]  # both fell back
    if op == "normals":
        surf = np.arange(5000) >= 300
        g, w = got._normals_numpy(), want._normals_numpy()
        np.testing.assert_allclose(g[surf], w[surf], atol=1e-5)
        assert (np.sum(g[~surf] * w[~surf].astype(np.float64), 1)
                > 0.999).all()
    else:
        np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
