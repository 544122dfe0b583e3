"""The PyTorch port's aerial pipeline on the CPU against the JAX package's
(`backend="sweep_xla"`, its XLA mirrors), on the small aerial scene of
tests/test_aerial.py, in three configurations: that test's defaults, the
benchmark's kwargs, and the exact normals rescue; and at the benchmark's
kwargs for the other backend strings the JAX package takes.

Centroids are bitwise equal and the plane agrees to 1e-6. The port's
exact top-k certifies normals the mirror's lane certificate may flag, so
the certified sets are held equal to 0.1% of the rows. Where both certify,
the normals agree to |dot| > 1 - 1e-5 (orientation included) on 99.9% of
the rows, as tests/test_aerial.py holds its two modes (moment sums in
another order move the eigenvector of a near-degenerate neighbourhood
further), and to 0.999 on all. Clusters are the same sets of obstacle
slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.core.cloud import make_cloud_arrays as jax_make_cloud
from pointclouds_tpu.pipelines.aerial import (
    aerial_pipeline as jax_pipeline,
    extract_clusters as jax_extract,
)
from pointclouds_tpu.pipelines.scenes import aerial_scene
import pointclouds_tpu_torch as port
from pointclouds_tpu_torch.pipelines.aerial import extract_clusters
from pointclouds_tpu_torch.spatial import kernels

VP = [0.0, 0.0, 10000.0]
CONFIGS = {
    # tests/test_aerial.py's defaults (a 12 m normals cell at this density)
    "defaults": (np.float32(12.0), {}),
    # bench.py's kwargs, caps scaled to the small scene
    "bench": (np.float32(3.0), dict(ds_cap=12_288, obstacle_cap=12_288,
                                    ransac_subsample=4096,
                                    normals_cell_factor=6,
                                    cluster_sweeps=16)),
    "rescue": (np.float32(3.0), dict(normals_rescue=True)),
}


@pytest.fixture(scope="module")
def scene():
    return aerial_scene(seed=42, scale=0.05)


def _assert_port_matches_jax(scene, config, backend="sweep_xla",
                             port_backend="auto"):
    cell, kw = CONFIGS[config]
    args = (np.float32(0.5), cell, np.float32(0.3), 0, np.float32(2.0))
    a = jax_make_cloud(scene)
    jout = jax_pipeline(a.xyz, a.valid, *args,
                        jnp.asarray(VP, jnp.float32), backend=backend, **kw)
    c = port.make_cloud_arrays(scene, device="cpu")
    kernels.reset_launch_counts()
    tout = port.aerial_pipeline(c.xyz, c.valid, *args, VP,
                                backend=port_backend, **kw)
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # CPU: plain
    t = type(tout)(*(x.numpy() for x in tout))
    j = type(jout)(*(np.asarray(x) for x in jout))

    np.testing.assert_array_equal(t.centroids.view(np.uint32),
                                  j.centroids.view(np.uint32))
    np.testing.assert_array_equal(t.downsampled_valid, j.downsampled_valid)
    assert not t.ds_overflow and not t.obstacle_overflow
    np.testing.assert_allclose(t.plane_normal, j.plane_normal, atol=1e-6)
    assert abs(float(t.plane_d) - float(j.plane_d)) <= 1e-6
    assert abs(t.plane_normal[2]) > 0.95
    np.testing.assert_array_equal(t.inlier_mask, j.inlier_mask)

    ds = t.downsampled_valid
    tok, jok = t.normals_ok & ds, j.normals_ok & ds
    assert (tok != jok).sum() <= 0.001 * ds.sum()
    both = tok & jok
    assert both.sum() >= 100  # (a 3 m cell certifies few rows at 1/20 density)
    dots = np.sum(t.normals[both].astype(np.float64) * j.normals[both], 1)
    assert (dots > 1 - 1e-5).mean() > 0.999, np.sort(dots)[:5]
    assert dots.min() > 0.999

    assert bool(t.cluster_exact) and bool(j.cluster_exact)
    np.testing.assert_array_equal(t.obstacle_src, j.obstacle_src)
    tclusters = extract_clusters(tout, 20, 100_000)
    assert tclusters == jax_extract(jout, 20, 100_000)
    assert len(tclusters) >= 5  # the buildings and trees


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_port_matches_jax_aerial(scene, config):
    _assert_port_matches_jax(scene, config)


@pytest.mark.parametrize("backend", ["sweep_xla", "xla"])
def test_backend_dispatch_matches_jax(scene, backend):
    """Every backend string the JAX package takes: "sweep_xla" runs as the
    sweep backend with the fused voxel front end; any other string (here
    "xla") takes the plain voxel front end and the normals cell as given.
    At the bench kwargs, where the two front ends differ."""
    _assert_port_matches_jax(scene, "bench", backend=backend,
                             port_backend=backend)
