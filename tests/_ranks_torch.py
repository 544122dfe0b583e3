"""Rank bodies for the port's multi-device tests: module-level functions
that `pointclouds_tpu_torch.parallel.launch.run_ranks` runs in spawned
gloo CPU ranks. This module imports torch and the port only (no jax), so
that a spawned rank stays light.

Each body runs one of the port's mesh pipelines at each (frames, points)
mesh shape given (frames x points == the world size) on the first
``frames`` frames of the batch, and returns per shape the whole batched
output as numpy arrays, with the shape of this rank's `shard_of` block.
"""

import numpy as np
import torch

from pointclouds_tpu_torch.parallel import sharding, tiles

VIEWPOINT = [0.0, 0.0, 10000.0]


def _numpy(out):
    return {f: getattr(out, f).numpy() for f in out._fields}


def _meshes(shapes, xs, vs):
    for frames, points in shapes:
        mesh = sharding.mesh_of(frames, points)
        x, v = torch.from_numpy(xs[:frames]), torch.from_numpy(vs[:frames])
        yield (frames, points), mesh, x, v, np.arange(frames)


def _call(shapes, xs, vs, make, args):
    res = {}
    for shape, mesh, x, v, seeds in _meshes(shapes, xs, vs):
        r = _numpy(make(mesh, x.shape[1])(x, v, *args(seeds)))
        r["shard"] = tuple(sharding.shard_of(x, mesh).shape)
        res[shape] = r
    return res


def tiled_kitti(rank, world, shapes, xs, vs, kw):
    return _call(shapes, xs, vs,
                 lambda mesh, n: tiles.tiled_kitti_pipeline(mesh, n, **kw),
                 lambda seeds: (np.float32(0.15), np.float32(2.0),
                                np.float32(0.15), seeds, np.float32(0.8)))


def tiled_aerial(rank, world, shapes, xs, vs, kw):
    return _call(shapes, xs, vs,
                 lambda mesh, n: tiles.tiled_aerial_pipeline(mesh, n, **kw),
                 lambda seeds: (np.float32(0.5), np.float32(0.3), seeds,
                                np.float32(2.0), VIEWPOINT))


def sharded(rank, world, shapes, kitti, aerial):
    """The sharded KITTI and aerial batches (``kitti`` and ``aerial``:
    (xyz, valid) numpy batches) at each mesh shape; with the world's own
    `make_mesh` shape."""
    res = {"make_mesh": tuple(sharding.make_mesh().mesh.shape)}
    res["kitti"] = _call(
        shapes, *kitti,
        lambda mesh, n: sharding.sharded_kitti_pipeline(
            mesh, sor_k=10, ransac_iters=50, obstacle_cap=512),
        lambda seeds: (np.float32(0.15), np.float32(2.0), np.float32(0.15),
                       seeds, np.float32(0.8)))
    res["aerial"] = _call(
        shapes, *aerial,
        lambda mesh, n: sharding.sharded_aerial_pipeline(
            mesh, normals_k=15, ransac_iters=50, obstacle_cap=1024),
        lambda seeds: (np.float32(0.5), np.float32(6.0), np.float32(0.3),
                       seeds, np.float32(2.0), VIEWPOINT))
    return res


def traced_collectives(rank, world):
    """Two `psum` and an `all_gather_tiled` of CPU tensors inside a traced
    frame; the results, the record's counters and its span names."""
    import torch.distributed as dist

    from pointclouds_tpu_torch.parallel import comm
    from pointclouds_tpu_torch.utils import profiling

    group = dist.new_group(list(range(world)))
    profiling.set_tracing(True)
    try:
        with profiling.frame("mesh"):
            s = comm.psum(torch.arange(4.0), group)
            comm.psum(s, group)
            g = comm.all_gather_tiled(torch.full((2,), float(rank)), group)
    finally:
        profiling.set_tracing(False)
    rec = profiling.last_frame()
    return dict(psum=s.numpy(), all_gather=g.numpy(), counts=dict(rec.counts),
                spans=[x.name for x in rec.spans])
