"""Euclidean clustering of the PyTorch port against the JAX package on the
CPU: `euclidean_cluster` end to end, the engine's surviving-component
ranks, and the exact brute-force labels of the last resort.

Clusters are canonical (size descending, then first member; members
ascending), so any exact backend gives the same lists: they are compared
exactly, as are the labels (the smallest row of each component).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu import api as japi
from pointclouds_tpu.ops import segmentation as jseg
from pointclouds_tpu.spatial import engine as jengine
from pointclouds_tpu_torch import api
from pointclouds_tpu_torch.ops import segmentation
from pointclouds_tpu_torch.spatial import engine, kernels


def _blobs(seed, n_blobs, per, spread=0.3, noise=0, box=30.0):
    """Gaussian blobs (some of them touching), uniform noise and a NaN row."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, box, (n_blobs, 3))
    centers[1] = centers[0] + [0.9, 0, 0]  # two blobs that may merge
    pts = [c + rng.normal(0, spread, (per, 3)) for c in centers]
    pts.append(rng.uniform(0, box, (noise, 3)))
    out = np.vstack(pts).astype(np.float32)
    out[5] = np.nan
    return out


@pytest.mark.parametrize("n_blobs,per,noise,r,mn,mx", [
    (12, 60, 400, 0.5, 5, 100_000),   # the sweep's row-list rung
    (6, 400, 200, 0.9, 10, 500),      # a max_size cut
    (3, 100, 50, 0.6, 1, 1000),       # min_size 1: noise singletons too
    (4, 80, 30, 0.5, 3, 100),         # at most 512 points: brute force
])
def test_euclidean_cluster_matches_jax(n_blobs, per, noise, r, mn, mx):
    pts = _blobs(n_blobs * per, n_blobs, per, noise=noise)
    kernels.reset_launch_counts()
    got = api.euclidean_cluster(api.PointCloud.from_numpy(pts, device="cpu"),
                                r, mn, mx)
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # CPU: plain
    want = japi.euclidean_cluster(japi.PointCloud.from_numpy(pts), r, mn, mx)
    assert got == want
    assert len(got) >= 2


def test_euclidean_cluster_dense_windows_rung():
    """A dense slab overflows the 16-row lists: the windows rung runs."""
    rng = np.random.default_rng(4)
    pts = np.vstack([rng.random((6000, 3)) * [12, 12, 0.05],
                     rng.random((800, 3)) * 12]).astype(np.float32)
    got = api.euclidean_cluster(api.PointCloud.from_numpy(pts, device="cpu"),
                                0.5, 3, 10**6)
    want = japi.euclidean_cluster(japi.PointCloud.from_numpy(pts), 0.5, 3,
                                  10**6)
    assert got == want and len(got[0]) > 6000


def test_euclidean_cluster_argument_checks():
    c = api.PointCloud.from_numpy(_blobs(0, 2, 20), device="cpu")
    for args in ((0.0, 2, 10), (-1.0, 2, 10), (float("inf"), 2, 10),
                 (0.5, 0, 10)):
        assert api.euclidean_cluster(c, *args) == []
    assert api.euclidean_cluster(api.PointCloud(device="cpu"), 0.5, 1, 9) == []


def test_surviving_component_ranks_match_jax():
    rng = np.random.default_rng(5)
    labels = np.sort(rng.integers(0, 300, 2000)).astype(np.int32)
    labels = labels[rng.permutation(2000)]
    for mn, mx in ((1, 10**6), (5, 9), (8, 8)):
        comp, ns = engine._surviving_component_ranks(torch.from_numpy(labels),
                                                     mn, mx)
        jcomp, jns = jengine._surviving_component_ranks(jnp.asarray(labels),
                                                        mn, mx)
        np.testing.assert_array_equal(comp.numpy(), np.asarray(jcomp))
        assert int(ns) == int(jns)


def test_bruteforce_cluster_labels_match_jax():
    pts = _blobs(7, 5, 40, noise=60)
    valid = np.ones(len(pts), bool)
    valid[::17] = False
    # An isolated pair exactly one radius apart: connected (inclusive).
    pts[10], pts[11] = [100.0, 100.0, 100.0], [100.5, 100.0, 100.0]
    valid[10] = valid[11] = True
    r = np.float32(0.5)
    got = segmentation.bruteforce_cluster_labels(
        torch.from_numpy(pts), torch.from_numpy(valid), r).numpy()
    want = np.asarray(jseg.bruteforce_cluster_labels(
        jnp.asarray(pts), jnp.asarray(valid), jnp.float32(r)))
    np.testing.assert_array_equal(got, want)
    assert got[11] == 10
    assert len(np.unique(got[valid & np.isfinite(pts).all(1)])) > 5


def test_cluster_labels_large_cloud_int64_grid(monkeypatch):
    """Clouds of `CELLGRID_MAX_N` points or more skip the sweep and
    cell-graph rungs and take the int64-keyed grid's lists with label
    propagation, in both packages: the limit lowered to 4096 in both so a
    5,000-point cloud takes it. Labels and clusters equal."""
    monkeypatch.setattr(engine, "CELLGRID_MAX_N", 4096)
    monkeypatch.setattr(jengine, "CELLGRID_MAX_N", 4096)
    calls = []
    orig = segmentation.propagate_labels
    monkeypatch.setattr(segmentation, "propagate_labels",
                        lambda *a: calls.append(1) or orig(*a))
    pts = _blobs(23, 10, 420, noise=800)
    valid = np.isfinite(pts).all(axis=1)
    labels, filtered = engine.cluster_labels(
        torch.from_numpy(pts), torch.from_numpy(valid), 0.5,
        size_filter=(1, 10**9))
    assert not filtered and calls == [1]
    assert jengine.cluster_labels(jnp.asarray(pts), jnp.asarray(valid),
                                  0.5) is None
    jidx, jwithin = jengine.radius_neighbors(jnp.asarray(pts),
                                             jnp.asarray(valid), 0.5)
    want = np.asarray(jseg.propagate_labels(jidx, jwithin,
                                            jnp.asarray(valid)))
    np.testing.assert_array_equal(labels, want)
    got = api.euclidean_cluster(api.PointCloud.from_numpy(pts, device="cpu"),
                                0.5, 5, 100_000)
    assert got == japi.euclidean_cluster(japi.PointCloud.from_numpy(pts),
                                         0.5, 5, 100_000)
    assert len(got) > 5
