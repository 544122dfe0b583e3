"""The port's tiled KITTI pipeline (`pointclouds_tpu_torch/parallel/tiles.py`)
in spawned gloo CPU ranks, at meshes (frames, points) = (2, 1), (1, 2) and
(1, 4), against the JAX package's tiled pipeline at the same mesh shape
(on the conftest's virtual CPU devices) and against the port's unsharded
pipeline.

Against the JAX tiled pipeline: the same routes and tiles, so the gathered
rows come in the same tile-major order; centroids bitwise, or within one
ulp where a scan's add tree sits at another offset; flags (p == 1
included), kept rows, kept count and SOR certificate equal; the plane to
5e-3; clusters geometrically equal. Against the unsharded pipeline, the
rules of `tests/test_tiles.py`: centroid sets equal to rtol 3e-7, kept
counts within max(2, n / 1000) (the tiles' float64 threshold sums in
another order), the plane to 5e-3, clusters geometrically equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _ranks_torch
from pointclouds_tpu.core.cloud import make_cloud_arrays
from pointclouds_tpu.parallel.tiles import tiled_kitti_pipeline
from pointclouds_tpu.pipelines.scenes import kitti_scene
from pointclouds_tpu_torch.parallel._compare import (
    centroid_sets_close,
    clusters_as_sets,
    kept_close,
    plane_close,
)
from pointclouds_tpu_torch.parallel.launch import run_ranks
from pointclouds_tpu_torch.pipelines.kitti import kitti_obstacle_pipeline

SCALE = 0.05
B = 2
WORLDS = {2: [(2, 1), (1, 2)], 4: [(1, 4)]}
SHAPES = [s for shapes in WORLDS.values() for s in shapes]
KW = dict(sor_k=10, ransac_iters=50, obstacle_cap=2048,
          ransac_subsample=None)


def _jax_mesh(frames, points):
    devs = np.array(jax.devices()[: frames * points]).reshape(frames, points)
    return Mesh(devs, ("frames", "points"))


def port_runs(body, xs, vs, kw):
    """{shape: output} from every world's ranks; every rank must return
    the same whole output."""
    got = {}
    for world, shapes in WORLDS.items():
        ranks = run_ranks(body, world, shapes, xs, vs, kw, timeout=90.0)
        for other in ranks[1:]:
            for shape in shapes:
                for name, v in ranks[0][shape].items():
                    np.testing.assert_array_equal(np.asarray(other[shape][
                        name]), np.asarray(v), err_msg=f"{shape} {name}")
        got.update(ranks[0])
    return got


@pytest.fixture(scope="module")
def runs():
    frames = [make_cloud_arrays(kitti_scene(seed=s, scale=SCALE))
              for s in range(B)]
    xs = np.stack([np.asarray(f.xyz) for f in frames])
    vs = np.stack([np.asarray(f.valid) for f in frames])
    got = port_runs(_ranks_torch.tiled_kitti, xs, vs, KW)
    want = {}
    for frames_, points in SHAPES:
        step = tiled_kitti_pipeline(_jax_mesh(frames_, points), xs.shape[1],
                                    **KW)
        out = step(jnp.asarray(xs[:frames_]), jnp.asarray(vs[:frames_]),
                   jnp.float32(0.15), jnp.float32(2.0), jnp.float32(0.15),
                   jnp.arange(frames_, dtype=jnp.int32), jnp.float32(0.8))
        want[(frames_, points)] = {f: np.asarray(getattr(out, f))
                                   for f in out._fields}
    refs = [kitti_obstacle_pipeline(
        torch.from_numpy(xs[b]), torch.from_numpy(vs[b]), np.float32(0.15),
        np.float32(2.0), np.float32(0.15), b, np.float32(0.8), sor_k=10,
        ransac_iters=50, obstacle_cap=2048) for b in range(B)]
    return xs, got, want, refs


def within_ulp(got, want, ulps=1):
    """f32 arrays equal to within ``ulps`` units in the last place."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w.shape
    gap = np.abs(g.view(np.int32).astype(np.int64)
                 - w.view(np.int32).astype(np.int64))
    same_sign = np.sign(g) == np.sign(w)
    assert ((gap <= ulps) & same_sign | (g == w)).all()
    return (g == w).mean()


@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_kitti_matches_jax_tiled(runs, shape):
    _, got, want, _ = runs
    g, w = got[shape], want[shape]
    assert within_ulp(g["centroids"], w["centroids"]) > 0.999
    for name in ("downsampled_valid", "cleaned_valid", "cleaned_count",
                 "sor_certified", "flags", "obstacle_valid"):
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    assert not g["flags"].any()
    for b in range(shape[0]):
        assert plane_close(g["plane_normal"][b], w["plane_normal"][b])
        assert clusters_as_sets(g["obstacle_xyz"][b], g["obstacle_valid"][b],
                                g["labels"][b], 10) == clusters_as_sets(
            w["obstacle_xyz"][b], w["obstacle_valid"][b], w["labels"][b], 10)


@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_kitti_matches_unsharded(runs, shape):
    _, got, _, refs = runs
    g = got[shape]
    for b in range(shape[0]):
        ref = refs[b]
        want = ref.centroids[ref.downsampled_valid].numpy()
        cents = g["centroids"][b][g["downsampled_valid"][b]]
        assert centroid_sets_close(cents, want)
        assert kept_close(int(g["cleaned_count"][b]),
                          int(ref.cleaned_valid.sum()))
        assert plane_close(g["plane_normal"][b], ref.plane_normal.numpy())
        ref_xyz = ref.centroids[ref.obstacle_src.long()].numpy()
        assert clusters_as_sets(g["obstacle_xyz"][b], g["obstacle_valid"][b],
                                g["labels"][b], 10) == clusters_as_sets(
            ref_xyz, ref.obstacle_valid.numpy(), ref.labels.numpy(), 10)


def test_tiled_kitti_points_axis_actually_sharded(runs):
    """Each rank holds its [B/frames, n/points, 3] block, and the outputs
    are replicated over the points axis (every rank's whole output equal:
    checked as the ranks return)."""
    xs, got, _, _ = runs
    n = xs.shape[1]
    for frames, points in SHAPES:
        assert got[(frames, points)]["shard"] == (1, n // points, 3)
        assert got[(frames, points)]["centroids"].shape[0] == frames
