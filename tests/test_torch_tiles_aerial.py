"""The port's tiled aerial pipeline
(`pointclouds_tpu_torch/parallel/tiles.py::tiled_aerial_pipeline`) in
spawned gloo CPU ranks, at meshes (2, 1), (1, 2) and (1, 4), against the
JAX package's tiled pipeline at the same mesh shape and against the port's
unsharded aerial pipeline.

Against the JAX tiled pipeline: centroids within one ulp (bitwise but for
a vanishing share), flags (p == 1 included), valid rows and obstacle slots
equal, normals certified on the same rows and there, as
`tests/test_torch_aerial_pipeline.py` holds them, |dot| > 1 - 1e-5 on
99.9% of the rows and > 0.999 on all (moment sums in another order move
the eigenvector of a near-degenerate neighbourhood); the plane to 5e-3,
clusters geometrically equal. Against the unsharded pipeline, the
rules of `tests/test_tiles_aerial.py`: centroid sets to rtol 3e-7, the
plane to 5e-3, owned-row normals matched by coordinates, clusters
geometrically equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _ranks_torch
from pointclouds_tpu.core.cloud import make_cloud_arrays
from pointclouds_tpu.parallel.tiles import tiled_aerial_pipeline
from pointclouds_tpu.pipelines.scenes import aerial_scene
from pointclouds_tpu_torch.parallel._compare import (
    centroid_sets_close,
    clusters_as_sets,
    normals_match,
    plane_close,
)
from pointclouds_tpu_torch.pipelines.aerial import aerial_pipeline
from test_torch_tiles import SHAPES, _jax_mesh, port_runs, within_ulp

SCALE = 0.03
B = 2
KW = dict(ransac_iters=100, obstacle_cap=16384, ransac_subsample=None)
VP = [0.0, 0.0, 10000.0]


@pytest.fixture(scope="module")
def runs():
    frames = [make_cloud_arrays(aerial_scene(seed=s, scale=SCALE))
              for s in range(B)]
    xs = np.stack([np.asarray(f.xyz) for f in frames])
    vs = np.stack([np.asarray(f.valid) for f in frames])
    got = port_runs(_ranks_torch.tiled_aerial, xs, vs, KW)
    want = {}
    for frames_, points in SHAPES:
        step = tiled_aerial_pipeline(_jax_mesh(frames_, points), xs.shape[1],
                                     **KW)
        out = step(jnp.asarray(xs[:frames_]), jnp.asarray(vs[:frames_]),
                   jnp.float32(0.5), jnp.float32(0.3),
                   jnp.arange(frames_, dtype=jnp.int32), jnp.float32(2.0),
                   jnp.asarray(VP, jnp.float32))
        want[(frames_, points)] = {f: np.asarray(getattr(out, f))
                                   for f in out._fields}
    refs = [aerial_pipeline(
        torch.from_numpy(xs[b]), torch.from_numpy(vs[b]), np.float32(0.5),
        np.float32(3.0), np.float32(0.3), b, np.float32(2.0), VP,
        ransac_iters=100, obstacle_cap=16384) for b in range(B)]
    return got, want, refs


@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_aerial_matches_jax_tiled(runs, shape):
    got, want, _ = runs
    g, w = got[shape], want[shape]
    assert within_ulp(g["centroids"], w["centroids"]) > 0.999
    for name in ("downsampled_valid", "normals_ok", "flags",
                 "obstacle_valid", "cluster_exact"):
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    assert not g["flags"].any()
    ok = g["normals_ok"] & g["downsampled_valid"]
    assert ok.sum() >= 20  # ~2% of the rows certify at this density
    dots = np.sum(g["normals"][ok].astype(np.float64) * w["normals"][ok], 1)
    assert (dots > 1 - 1e-5).mean() > 0.999 and dots.min() > 0.999
    for b in range(shape[0]):
        assert plane_close(g["plane_normal"][b], w["plane_normal"][b])
        assert clusters_as_sets(g["obstacle_xyz"][b], g["obstacle_valid"][b],
                                g["labels"][b], 20) == clusters_as_sets(
            w["obstacle_xyz"][b], w["obstacle_valid"][b], w["labels"][b], 20)


@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_aerial_matches_unsharded(runs, shape):
    got, _, refs = runs
    g = got[shape]
    for b in range(shape[0]):
        ref = refs[b]
        rv = ref.downsampled_valid.numpy()
        want = ref.centroids.numpy()[rv]
        tv = g["downsampled_valid"][b]
        cents = g["centroids"][b][tv]
        assert centroid_sets_close(cents, want)
        assert plane_close(g["plane_normal"][b], ref.plane_normal.numpy())
        # Owned-row normals by coordinates: certified in both paths, tight.
        assert normals_match(cents, g["normals"][b][tv],
                             g["normals_ok"][b][tv], want,
                             ref.normals.numpy()[rv],
                             ref.normals_ok.numpy()[rv])
        ref_xyz = ref.centroids[ref.obstacle_src.long()].numpy()
        assert clusters_as_sets(g["obstacle_xyz"][b], g["obstacle_valid"][b],
                                g["labels"][b], 20) == clusters_as_sets(
            ref_xyz, ref.obstacle_valid.numpy(), ref.labels.numpy(), 20)
