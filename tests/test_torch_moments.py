"""kNN moments of the PyTorch port against the JAX package: the plain
version of the `sweep_moments` kernel against the Pallas kernel in
interpret mode and its XLA mirror, and `sweep_knn_moments_rows` with and
without a prebuilt structure.

Tolerances: count, kth and cle are equal (the same pinned d2, an exact
top-k); the port certifies a superset of the reference's rows (its top-k
is exact where the reference's lane segments may not be); m1/m2 agree to
rtol 1e-5 with an atol of 1e-5 * cell^2 * k on rows both certify: the
port adds in candidate order, the mirror sums in tree order, and the
Pallas kernel recombines block-centred sums (m1 = S1 - s0 q'), which
cancels terms of size ~k times the block's extent.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.ops.filters import (
    voxel_downsample_sweep_fused as jax_fused,
)
from pointclouds_tpu.pipelines.scenes import aerial_scene
from pointclouds_tpu.spatial import pallas_kernels as jpk
from pointclouds_tpu.spatial import sweep as jsweep
from pointclouds_tpu_torch.ops.filters import voxel_downsample_sweep_fused
from pointclouds_tpu_torch.spatial import kernels, sweep
from pointclouds_tpu_torch.utils.interop import to_torch


def _cloud(seed, n, invalid_frac=0.1, lattice=False):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    if lattice:  # a 0.5 m grid: duplicates and equal d2 tie at the kth
        xyz = np.round(xyz * 2.0) / np.float32(2.0)
    valid = rng.random(n) > invalid_frac
    bad = ~valid & (rng.random(n) > 0.5)
    xyz[bad] = np.nan
    return xyz, valid


def _close(got, want, ok, cell, k):
    np.testing.assert_allclose(got[..., ok], want[..., ok], rtol=1e-5,
                               atol=1e-5 * cell * cell * k)


@pytest.mark.parametrize("n,k,cell,lattice", [
    (4096, 15, 1.3, False), (2000, 8, 1.4, False), (1500, 5, 2.0, False),
    (2000, 8, 1.4, True), (2000, 1, 1.4, False)])
def test_moments_plain_matches_pallas_and_mirror(n, k, cell, lattice):
    xyz, valid = _cloud(0, n, lattice=lattice)
    s = jsweep._sorted_structure(jnp.asarray(xyz), jnp.asarray(valid),
                                 np.float32(cell), 4, jsweep.SWEEP_TABLE_SIZE)
    pal = np.asarray(jpk.sweep_moments(s["planar"], s["starts_skip"], k=k,
                                       wr=4, interpret=True))
    mir = np.asarray(jsweep._sweep_moments_xla(s["planar"], s["starts_skip"],
                                               k=k, wr=4, per_seg=3))
    kernels.reset_launch_counts()
    got = kernels.sweep_moments(to_torch(s["planar"]),
                                to_torch(s["starts_skip"]), k=k).numpy()
    assert kernels.LAUNCHES["sweep_moments"] == 0  # CPU: plain
    assert (got[12] == 1.0).all() and (got[13:] == 0.0).all()
    for want in (pal, mir):
        cert = want[12] > 0.5
        assert cert.mean() > 0.9
        for row in (9, 10, 11):  # cle, count, kth
            np.testing.assert_array_equal(got[row, cert], want[row, cert])
        if lattice:  # ties at the kth: cle counts past it
            assert (got[9, cert] > got[10, cert]).mean() > 0.1
        both = cert & (want[9] == want[10])
        _close(got[:9], want[:9], both, cell, k)


@pytest.mark.parametrize("n,k,cell", [(4096, 15, 1.3), (1500, 5, 2.0)])
def test_knn_moments_rows_matches_jax(n, k, cell):
    xyz, valid = _cloud(1, n)
    want = [np.asarray(a) for a in jsweep.sweep_knn_moments_rows(
        jnp.asarray(xyz), jnp.asarray(valid), np.float32(cell), k=k,
        use_kernel=False)]
    got = [a.numpy() for a in sweep.sweep_knn_moments_rows(
        torch.from_numpy(xyz), torch.from_numpy(valid), np.float32(cell),
        k=k)]
    jok, tok = want[3], got[3]
    assert jok.mean() > 0.5
    assert not (jok & ~tok).any()  # the port certifies a superset
    np.testing.assert_array_equal(got[2][jok], want[2][jok])
    _close(got[0], want[0], jok, cell, k)
    _close(got[1], want[1], jok, cell, k)


def test_knn_moments_rows_prebuilt_matches_jax():
    """On the aerial front end's sweep-ordered voxels, as the aerial
    pipeline calls it (a 12 m normals cell: 24 voxels, for the sparse
    small-scale scene)."""
    data = aerial_scene(seed=42, scale=0.05)
    n = 16384
    xyz = np.zeros((n, 3), np.float32)
    xyz[: len(data)] = data
    valid = np.arange(n) < len(data)
    voxel, factor, cap = np.float32(0.5), 24, 12288
    cell = np.float32(voxel * np.float32(factor))
    jfe = jax_fused(jnp.asarray(xyz), jnp.asarray(valid), voxel,
                    factor=factor, ds_cap=cap, use_kernel=False)
    js = jsweep.structure_from_sorted(
        jfe["centroids"], jfe["out_valid"], jfe["slin"], jfe["extent"],
        jfe["hi_cells"], jfe["table_overflow"], wr=4)
    want = [np.asarray(a) for a in jsweep.sweep_knn_moments_rows(
        jfe["centroids"], jfe["out_valid"], cell, k=15, use_kernel=False,
        prebuilt=js)]
    fe = voxel_downsample_sweep_fused(torch.from_numpy(xyz),
                                      torch.from_numpy(valid),
                                      torch.tensor(voxel), factor=factor,
                                      ds_cap=cap)
    ts = sweep.structure_from_sorted(
        fe["centroids"], fe["out_valid"], fe["slin"], fe["extent"],
        fe["hi_cells"], fe["table_overflow"], wr=4)
    got = [a.numpy() for a in sweep.sweep_knn_moments_rows(
        fe["centroids"], fe["out_valid"], cell, k=15, prebuilt=ts)]
    np.testing.assert_array_equal(fe["centroids"].numpy(),
                                  np.asarray(jfe["centroids"]))
    jok, tok = want[3], got[3]
    assert jok.mean() > 0.5
    assert not (jok & ~tok).any()
    np.testing.assert_array_equal(got[2][jok], want[2][jok])
    _close(got[0], want[0], jok, float(cell), 15)
    _close(got[1], want[1], jok, float(cell), 15)
