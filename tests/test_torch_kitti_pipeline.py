"""The PyTorch port's KITTI pipeline on the CPU against the JAX package's
(sweep backend through its XLA mirrors), on the density-preserving crops of
tests/test_pipeline.py.

The two SOR paths certify different row sets (the port's exact top-k
certifies rows the XLA mirror's lane certificate flags), so the keep sets
are held to 1%, as tests/test_pipeline.py explains; the binding gate is
geometric cluster equality on bitwise-equal centroids.
"""

import numpy as np
import pytest

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.core.cloud import make_cloud_arrays as jax_make_cloud
from pointclouds_tpu.pipelines.kitti import (
    extract_clusters as jax_extract,
    kitti_obstacle_pipeline as jax_pipeline,
)
from pointclouds_tpu.pipelines.scenes import kitti_scene
import pointclouds_tpu_torch as port
from pointclouds_tpu_torch.spatial import kernels

ARGS = (np.float32(0.15), np.float32(2.0), np.float32(0.15))
KW = dict(sor_k=20, ransac_iters=500, obstacle_cap=8192,
          ransac_subsample=4096)


def _crop(seed, scale):
    data = kitti_scene(seed=seed, scale=1.0)
    half_x = 30.0 * (scale * 2.5) ** 0.5
    half_y = 20.0 * (scale * 2.5) ** 0.5
    keep = (np.abs(data[:, 0]) <= half_x) & (np.abs(data[:, 1]) <= half_y)
    return np.ascontiguousarray(data[keep])


def _cluster_points(out, clusters):
    cents = np.asarray(out.centroids)[np.asarray(out.obstacle_src)]
    slots = np.nonzero(np.asarray(out.obstacle_valid))[0]
    return [np.sort(cents[slots[c]], axis=0) for c in clusters]


def _as_np(out):
    return type(out)(*(t.numpy() for t in out))


@pytest.mark.parametrize("scale,seed,ransac_seed", [(0.08, 42, 1234),
                                                    (0.25, 42, 99)])
def test_port_matches_jax_pipeline(scale, seed, ransac_seed):
    data = _crop(seed, scale)
    a = jax_make_cloud(data)
    jout = jax_pipeline(a.xyz, a.valid, *ARGS, ransac_seed, np.float32(0.8),
                        sor_backend="sweep_xla", **KW)
    jclusters = jax_extract(jout, 10, 20_000)

    c = port.make_cloud_arrays(data)
    kernels.reset_launch_counts()
    tout = port.kitti_obstacle_pipeline(c.xyz, c.valid, *ARGS, ransac_seed,
                                        np.float32(0.8), **KW)
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # CPU: plain
    tclusters = port.extract_clusters(tout, 10, 20_000)
    t = _as_np(tout)

    # Centroids: bitwise.
    np.testing.assert_array_equal(
        t.centroids.view(np.uint32), np.asarray(jout.centroids).view(np.uint32))
    np.testing.assert_array_equal(t.downsampled_valid,
                                  np.asarray(jout.downsampled_valid))
    # SOR keep set within 1%.
    jk, tk = int(np.asarray(jout.cleaned_valid).sum()), int(t.cleaned_valid.sum())
    assert abs(jk - tk) <= max(3, jk // 100)
    assert bool(t.sor_certified)
    # Same ground plane.
    dot = abs(float(np.dot(np.asarray(jout.plane_normal, np.float64),
                           t.plane_normal.astype(np.float64))))
    assert dot > 0.999999
    assert not t.grid_flags.any() and not bool(t.obstacle_overflow)
    # Identical cluster structure, compared by coordinates.
    assert [len(x) for x in tclusters] == [len(x) for x in jclusters]
    for tp, jp in zip(_cluster_points(t, tclusters),
                      _cluster_points(jout, jclusters)):
        np.testing.assert_array_equal(tp, jp)
    if scale == 0.25:
        assert len(tclusters) == 3  # 2 cars + 1 pedestrian


def test_unported_backends_raise():
    c = port.make_cloud_arrays(_crop(3, 0.02))
    for bad in (dict(sor_backend="xla"), dict(sor_row_cap=None),
                dict(ds_cap=1000)):
        with pytest.raises(NotImplementedError):
            port.kitti_obstacle_pipeline(c.xyz, c.valid, *ARGS, 0,
                                         np.float32(0.8),
                                         **{**KW, **bad})
