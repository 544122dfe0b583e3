"""The port's frames x points mesh pipelines
(`pointclouds_tpu_torch/parallel/sharding.py`) in spawned gloo CPU ranks,
at meshes (2, 1), (1, 2) and (1, 4), against the JAX package's sharded
pipelines at the same mesh shape (on the conftest's virtual CPU devices)
and against the port's unsharded pipelines; the mesh shape rule; and the
multi-device dry run against the JAX package's.

Each frame runs the unsharded pipeline on its gathered points, so the
outputs equal the port's unsharded run bit for bit, and the JAX package's
sharded run as `tests/test_sharding.py` holds that to its unsharded one:
valid rows, kept rows and labels equal, centroids to 1e-6 (here bitwise);
normals as `tests/test_torch_aerial_pipeline.py` holds the two packages'
(where both certify, |dot| > 1 - 1e-5 on 99.9% of the rows, > 0.999 on
all).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _ranks_torch
from pointclouds_tpu.core.cloud import make_cloud_arrays
from pointclouds_tpu.parallel.sharding import make_mesh as jax_make_mesh
from pointclouds_tpu.parallel.sharding import (
    sharded_aerial_pipeline,
    sharded_kitti_pipeline,
)
from pointclouds_tpu.pipelines.scenes import aerial_scene, kitti_scene
from pointclouds_tpu_torch.parallel.launch import (
    dryrun_multidevice,
    run_ranks,
)
from pointclouds_tpu_torch.parallel.sharding import mesh_shape
from pointclouds_tpu_torch.pipelines.aerial import aerial_pipeline
from pointclouds_tpu_torch.pipelines.kitti import kitti_obstacle_pipeline
from test_torch_tiles import SHAPES, WORLDS, _jax_mesh

B = 2
VP = [0.0, 0.0, 10000.0]


def _batch(scene, cap):
    frames = [make_cloud_arrays(scene(seed=s, scale=0.01), capacity=cap)
              for s in range(B)]
    return (np.stack([np.asarray(f.xyz) for f in frames]),
            np.stack([np.asarray(f.valid) for f in frames]))


def test_mesh_shape_matches_jax():
    for n in (1, 2, 3, 4, 6, 8):
        assert mesh_shape(n) == tuple(jax_make_mesh(n).shape.values())


@pytest.fixture(scope="module")
def runs():
    kitti, aerial = _batch(kitti_scene, 2048), _batch(aerial_scene, 4096)
    got = {}
    for world, shapes in WORLDS.items():
        ranks = run_ranks(_ranks_torch.sharded, world, shapes, kitti, aerial,
                          timeout=90.0)
        for r in ranks[1:]:
            for kind in ("kitti", "aerial"):
                for shape in shapes:
                    for name, v in ranks[0][kind][shape].items():
                        np.testing.assert_array_equal(r[kind][shape][name], v)
        got[world] = ranks[0]
    want = {"kitti": {}, "aerial": {}}
    for frames, points in SHAPES:
        mesh = _jax_mesh(frames, points)
        seeds = jnp.arange(frames, dtype=jnp.int32)
        out = sharded_kitti_pipeline(
            mesh, sor_k=10, ransac_iters=50, obstacle_cap=512)(
            jnp.asarray(kitti[0][:frames]), jnp.asarray(kitti[1][:frames]),
            jnp.float32(0.15), jnp.float32(2.0), jnp.float32(0.15), seeds,
            jnp.float32(0.8))
        want["kitti"][(frames, points)] = out
        out = sharded_aerial_pipeline(
            mesh, normals_k=15, ransac_iters=50, obstacle_cap=1024)(
            jnp.asarray(aerial[0][:frames]), jnp.asarray(aerial[1][:frames]),
            jnp.float32(0.5), jnp.float32(6.0), jnp.float32(0.3), seeds,
            jnp.float32(2.0), jnp.asarray(VP, jnp.float32))
        want["aerial"][(frames, points)] = out
    refs = {
        "kitti": [kitti_obstacle_pipeline(
            torch.from_numpy(kitti[0][b]), torch.from_numpy(kitti[1][b]),
            np.float32(0.15), np.float32(2.0), np.float32(0.15), b,
            np.float32(0.8), sor_k=10, ransac_iters=50, obstacle_cap=512)
            for b in range(B)],
        "aerial": [aerial_pipeline(
            torch.from_numpy(aerial[0][b]), torch.from_numpy(aerial[1][b]),
            np.float32(0.5), np.float32(6.0), np.float32(0.3), b,
            np.float32(2.0), VP, normals_k=15, ransac_iters=50,
            obstacle_cap=1024, backend="sweep_xla") for b in range(B)],
    }
    return kitti, got, want, refs


def _port(got, kind, shape):
    return next(g[kind][shape] for g in got.values() if shape in g[kind])


@pytest.mark.parametrize("kind", ["kitti", "aerial"])
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_matches_jax_sharded(runs, kind, shape):
    _, got, want, _ = runs
    g, w = _port(got, kind, shape), want[kind][shape]
    assert (g["downsampled_valid"].sum(axis=1) > 0).all()
    names = ["centroids", "downsampled_valid", "labels", "obstacle_valid"]
    names += (["cleaned_valid", "obstacle_src"] if kind == "kitti"
              else ["normals_ok"])
    for name in names:
        np.testing.assert_array_equal(g[name], np.asarray(getattr(w, name)),
                                      err_msg=name)
    if kind == "aerial":
        ok = g["normals_ok"] & g["downsampled_valid"]
        dots = np.sum(g["normals"][ok].astype(np.float64)
                      * np.asarray(w.normals)[ok], 1)
        assert ok.sum() >= 5  # few rows certify at this density
        assert (dots > 1 - 1e-5).mean() > 0.999 and dots.min() > 0.999


@pytest.mark.parametrize("kind", ["kitti", "aerial"])
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_matches_unsharded(runs, kind, shape):
    _, got, _, refs = runs
    g = _port(got, kind, shape)
    for b in range(shape[0]):
        for name, ref in refs[kind][b]._asdict().items():
            np.testing.assert_array_equal(g[name][b], ref.numpy(),
                                          err_msg=name)


def test_points_axis_actually_sharded(runs):
    """Each rank holds its [B/frames, n/points, 3] block; `make_mesh` takes
    the shape rule at each world size."""
    kitti, got, _, _ = runs
    n = kitti[0].shape[1]
    for world, res in got.items():
        assert res["make_mesh"] == mesh_shape(world)
        for frames, points in WORLDS[world]:
            assert res["kitti"][(frames, points)]["shard"] == (
                1, n // points, 3)


def test_dryrun_multidevice_matches_jax(capsys):
    """`dryrun_multidevice(4)` (gloo CPU ranks) prints the two lines the
    JAX package's `dryrun_multichip(4)` prints, with the same counts."""
    import __graft_entry__

    lines = dryrun_multidevice(4)
    capsys.readouterr()
    __graft_entry__.dryrun_multichip(4)
    jax_lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].replace("dryrun_multidevice", "dryrun_multichip") == (
        jax_lines[0])
    assert lines[1] == jax_lines[1]
    assert jax.default_backend() == "cpu"
