"""Normals of the PyTorch port against the JAX package: `normals_from_knn`,
the column adapter `sweep_knn_moments`, and `engine.normals` (the exact
fallback of the fused normals: moments sweep + brute-force rescue).

Clouds are noisy surfaces, whose smallest covariance eigenvalue is well
separated, so a normal is defined to f32 precision whichever exact path
(moments or kNN list) computed it: normals agree within atol 1e-5,
orientation included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.ops import normals as jnormals
from pointclouds_tpu.spatial import engine as jengine
from pointclouds_tpu.spatial import knn as jknn
from pointclouds_tpu.spatial import sweep as jsweep
from pointclouds_tpu_torch.ops import normals
from pointclouds_tpu_torch.spatial import engine, kernels, sweep

VIEW = (0.0, 0.0, 50.0)


def surface(seed, n, outliers=0):
    """A rolling terrain patch with 1 cm noise, plus outliers above it."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 12, (n, 2))
    z = 0.4 * np.sin(xy[:, 0] * 0.7) * np.cos(xy[:, 1] * 0.5) + rng.normal(
        0, 0.01, n)
    xyz = np.column_stack([xy, z]).astype(np.float32)
    if outliers:
        xyz[:outliers] = rng.uniform(-5, 17, (outliers, 3))
    return xyz


def _same_normals(got, want):
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_normals_from_knn_matches_jax():
    xyz = surface(0, 1500)
    valid = np.ones(len(xyz), bool)
    _, idx, nv = jknn.bruteforce_knn(*(jnp.asarray(a) for a in (
        xyz, valid, xyz, valid)), 12)
    nv = np.array(nv)
    nv[:20, 3:] = False  # short lists
    nv[20:25] = False  # no neighbour: (0, 0, 1)
    idx = np.array(idx)
    want = np.asarray(jnormals.normals_from_knn(
        jnp.asarray(xyz), jnp.asarray(idx), jnp.asarray(nv),
        jnp.asarray(VIEW, jnp.float32)))
    got = normals.normals_from_knn(torch.from_numpy(xyz),
                                   torch.from_numpy(idx),
                                   torch.from_numpy(nv), VIEW).numpy()
    np.testing.assert_array_equal(got[20:25], want[20:25])
    _same_normals(got[25:], want[25:])


def test_sweep_knn_moments_matches_jax():
    xyz = surface(1, 3000)
    valid = np.ones(len(xyz), bool)
    cell, k = np.float32(0.5), 10
    want = [np.asarray(a) for a in jsweep.sweep_knn_moments(
        jnp.asarray(xyz), jnp.asarray(valid), cell, k=k, use_kernel=False)]
    got = [a.numpy() for a in sweep.sweep_knn_moments(
        torch.from_numpy(xyz), torch.from_numpy(valid), cell, k=k)]
    assert got[0].shape == (3000, 3) and got[1].shape == (3000, 6)
    ok = want[3]
    assert ok.mean() > 0.8 and not (ok & ~got[3]).any()
    np.testing.assert_array_equal(got[2][ok], want[2][ok])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g[ok], w[ok], rtol=1e-5,
                                   atol=1e-5 * float(cell) ** 2 * k)


@pytest.mark.parametrize("n,k,outliers", [(5000, 10, 200), (1200, 8, 20)])
def test_engine_normals_matches_jax(n, k, outliers):
    xyz = surface(n, n, outliers)
    valid = np.ones(n, bool)
    want = np.asarray(jengine.normals(jnp.asarray(xyz), jnp.asarray(valid),
                                      k, VIEW))
    kernels.reset_launch_counts()
    got = engine.normals(torch.from_numpy(xyz), torch.from_numpy(valid), k,
                         VIEW).numpy()
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    surf = np.arange(n) >= outliers
    _same_normals(got[surf], want[surf])
    # Outliers' neighbourhoods are not surfaces: the same plane to f32
    # conditioning, with the same orientation.
    dots = np.sum(got[~surf].astype(np.float64) * want[~surf], axis=1)
    assert (dots > 0.999).all()
