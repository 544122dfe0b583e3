"""Batched frames over a ("frames", "points") device mesh: the counterpart
of `pointclouds_tpu/parallel/sharding.py`.

The reference jits the vmapped pipeline with the batch's frames sharded
over ``frames`` and each frame's points over ``points``, and GSPMD
partitions the sorts and reductions inside it. Torch has no automatic
partitioner, so here each rank takes its ``[B/frames, n/points]`` block
of the batch (`shard_of`), `all_gather`s its frames' point shards over
``points`` and runs the unsharded pipeline on each whole frame; the
frames' outputs are gathered over ``frames``. As in the reference, the
outputs equal the unsharded pipeline's. The explicit points-axis design,
with each rank working on its own spatial tile, is `tiles.py`.

Inputs and outputs follow a fully addressable ``jax.Array``: every rank
is given the whole batch and returns the whole batched output.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..pipelines.aerial import aerial_pipeline
from ..pipelines.kitti import kitti_obstacle_pipeline
from .comm import all_gather_tiled

AXES = ("frames", "points")


def mesh_shape(n_devices: int) -> tuple[int, int]:
    """(frames, points) for n devices: a points axis of 2 whenever n is even
    (so the point-sharded path runs), the rest on frames."""
    points = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return n_devices // points, points


def mesh_of(frames: int, points: int):
    """The ("frames", "points") `DeviceMesh` of that shape over the process
    group's ranks (frames x points must be the world size): a "cuda" mesh
    under NCCL, else a "cpu" one."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (frames, points),
                            mesh_dim_names=AXES)


def make_mesh(n_devices: int | None = None):
    """2-D ("frames", "points") mesh over the process group's ranks, shaped
    by `mesh_shape` (``n_devices``, if given, must be the world size)."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"mesh of {n} devices in a world of {world} ranks")
    return mesh_of(*mesh_shape(n))


def _coords(mesh, rank: int | None):
    """(frames, points) coordinates of ``rank`` (default: this rank) in
    ``mesh``, and the mesh's (frames, points) sizes."""
    layout = mesh.mesh
    rank = dist.get_rank() if rank is None else rank
    at = (layout == rank).nonzero()
    if at.shape[0] != 1:
        raise ValueError(f"rank {rank} is not in the mesh")
    return tuple(int(v) for v in at[0]), tuple(layout.shape)


def shard_of(batch, mesh, rank: int | None = None):
    """The ``[B/frames, n/points, ...]`` block of ``batch`` [B, n, ...] that
    ``rank`` holds, as ``NamedSharding(mesh, P("frames", "points"))`` lays
    it out; a 1-D ``batch`` [B] (seeds) is split over frames only."""
    (f, p), (nf, np_) = _coords(mesh, rank)
    bf = batch.shape[0] // nf
    rows = batch[f * bf:(f + 1) * bf]
    if batch.ndim == 1:
        return rows
    bn = batch.shape[1] // np_
    return rows[:, p * bn:(p + 1) * bn]


def gather_frames(outs, mesh):
    """Per-frame NamedTuples of tensors (this rank's frames) -> one
    NamedTuple batched over the whole batch: each field stacked, then
    `all_gather`ed over ``frames``."""
    group = mesh.get_group("frames")
    cls = type(outs[0])
    fields = []
    for name in cls._fields:
        t = torch.stack([getattr(o, name) for o in outs])
        if t.dtype == torch.bool:
            fields.append(all_gather_tiled(t.to(torch.uint8), group).bool())
        else:
            fields.append(all_gather_tiled(t, group))
    return cls(*fields)


def _frames(mesh, batch_xyz, batch_valid, seeds):
    """This rank's frames with their points gathered over ``points``:
    [(xyz f32[n, 3], valid bool[n], seed int)]."""
    group = mesh.get_group("points")
    xs = shard_of(torch.as_tensor(batch_xyz), mesh)
    vs = shard_of(torch.as_tensor(batch_valid), mesh)
    ss = shard_of(np.asarray(seeds), mesh)
    return [(all_gather_tiled(x, group),
             all_gather_tiled(v.to(torch.uint8), group).bool(), int(s))
            for x, v, s in zip(xs, vs, ss)]


def sharded_kitti_pipeline(mesh, *, sor_k: int = 20, ransac_iters: int = 100,
                           obstacle_cap: int = 2048):
    """(batch_xyz [B, n, 3], batch_valid [B, n], voxel, sor_std,
    ransac_thresh, seeds [B], cluster_r) -> `KittiPipelineOutput` batched
    over B, B split over ``frames`` and n over ``points``."""

    def step(batch_xyz, batch_valid, voxel, sor_std, r_thresh, seeds,
             cluster_r):
        outs = [kitti_obstacle_pipeline(
            xyz, valid, voxel, sor_std, r_thresh, seed, cluster_r,
            sor_k=sor_k, ransac_iters=ransac_iters, obstacle_cap=obstacle_cap)
            for xyz, valid, seed in _frames(mesh, batch_xyz, batch_valid,
                                            seeds)]
        return gather_frames(outs, mesh)

    return step


def sharded_aerial_pipeline(mesh, *, normals_k: int = 15,
                            ransac_iters: int = 100,
                            obstacle_cap: int = 4096, cluster_wr: int = 12):
    """The batched aerial pipeline over the mesh, `sharded_kitti_pipeline`'s
    contract: (batch_xyz [B, n, 3], batch_valid [B, n], voxel,
    normals_cell, ransac_thresh, seeds [B], cluster_r, viewpoint [3]) ->
    `AerialPipelineOutput` batched over B. The backend string is the
    reference's off and on its accelerator: "sweep_xla" for CPU tensors,
    "sweep" on the card (the port runs both alike)."""

    def step(batch_xyz, batch_valid, voxel, normals_cell, r_thresh, seeds,
             cluster_r, viewpoint):
        outs = []
        for xyz, valid, seed in _frames(mesh, batch_xyz, batch_valid, seeds):
            outs.append(aerial_pipeline(
                xyz, valid, voxel, normals_cell, r_thresh, seed, cluster_r,
                viewpoint, normals_k=normals_k, ransac_iters=ransac_iters,
                obstacle_cap=obstacle_cap, cluster_wr=cluster_wr,
                backend="sweep" if xyz.is_cuda else "sweep_xla"))
        return gather_frames(outs, mesh)

    return step

