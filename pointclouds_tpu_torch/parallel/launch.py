"""Spawning ranks, and the multi-device dry run: the counterpart of
`__graft_entry__.py::dryrun_multichip`.

`run_ranks` starts ``world`` processes (`torch.multiprocessing`, spawn),
each in a gloo process group of its own address (`tcp://localhost:<free
port>`) with a ``timeout`` on its collectives, runs ``fn(rank, world,
*args)`` in each and returns their results in rank order. A rank that
raises makes `run_ranks` raise; so does a run past ``timeout`` (its ranks
are killed), so a hung collective fails instead of hanging the caller.

    python -m pointclouds_tpu_torch.parallel.launch [N]

runs `dryrun_multidevice(N)` (default 4) on gloo CPU ranks.
"""

from __future__ import annotations

import datetime
import queue
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    """A free TCP port on localhost (for a process group's address)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, timeout, threads, fn, args, out):
    torch.set_num_threads(threads)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))
    try:
        out.put((rank, fn(rank, world, *args)))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 90.0,
              threads: int = 1):
    """[fn(0, world, *args), ..., fn(world - 1, world, *args)], each run in
    its own spawned process of a gloo process group. ``fn`` must be
    importable by the spawned processes (a module-level function) and
    return something picklable."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = mp.start_processes(
        _rank_main, args=(world, free_port(), timeout, threads, fn, args,
                          out),
        nprocs=world, join=False, start_method="spawn")
    results = {}
    deadline = time.monotonic() + timeout
    try:
        # Drain the queue while the ranks run (a rank exits only once its
        # result is flushed), and watch for a rank that failed.
        while len(results) < world:
            try:
                rank, res = out.get(timeout=0.2)
                results[rank] = res
                continue
            except queue.Empty:
                pass
            if procs.join(timeout=0) and out.empty():  # raises on a failure
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
        while not procs.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
    if len(results) < world:
        raise RuntimeError(f"{world - len(results)} ranks returned nothing")
    return [results[r] for r in range(world)]


def _dryrun_rank(rank, world):
    """One rank of `dryrun_multidevice`: the sharded KITTI batch, then the
    tiled KITTI and aerial batches on a frames x points mesh."""
    from ..core.cloud import make_cloud_arrays
    from ..pipelines.scenes import aerial_scene, kitti_scene
    from .sharding import make_mesh, sharded_kitti_pipeline
    from .tiles import tiled_aerial_pipeline, tiled_kitti_pipeline

    mesh = make_mesh(world)
    frames, points = mesh.mesh.shape

    def batch(scene, cap):
        arrs = [make_cloud_arrays(scene(seed=s, scale=0.01), device="cpu",
                                  capacity=cap) for s in range(frames)]
        return (torch.stack([a.xyz for a in arrs]),
                torch.stack([a.valid for a in arrs]))

    xyz, valid = batch(kitti_scene, 2048)
    seeds = np.arange(frames)
    out = sharded_kitti_pipeline(mesh, sor_k=10, ransac_iters=50,
                                 obstacle_cap=512)(
        xyz, valid, np.float32(0.15), np.float32(2.0), np.float32(0.15),
        seeds, np.float32(0.8))
    counts = out.downsampled_valid.sum(dim=1).tolist()
    if min(counts) <= 0:
        raise AssertionError("sharded pipeline produced empty frames")
    lines = [f"dryrun_multidevice OK: mesh={{'frames': {frames}, 'points': "
             f"{points}}} batch={frames} downsampled_counts={counts}"]

    tout = tiled_kitti_pipeline(mesh, xyz.shape[1], sor_k=10,
                                ransac_iters=50, obstacle_cap=512)(
        xyz, valid, np.float32(0.15), np.float32(2.0), np.float32(0.15),
        seeds, np.float32(0.8))
    tcounts = tout.cleaned_count.tolist()
    if min(tcounts) <= 0:
        raise AssertionError("tiled pipeline produced empty frames")
    axyz, avalid = batch(aerial_scene, 4096)
    aout = tiled_aerial_pipeline(mesh, axyz.shape[1], ransac_iters=50,
                                 obstacle_cap=4096)(
        axyz, avalid, np.float32(0.5), np.float32(0.3), seeds,
        np.float32(2.0), [0.0, 0.0, 10000.0])
    acounts = aout.downsampled_valid.sum(dim=1).tolist()
    if min(acounts) <= 0:
        raise AssertionError("tiled aerial produced empty frames")
    lines.append(f"dryrun tiled OK: mesh=frames:{frames} x points:{points} "
                 f"kitti_cleaned={tcounts} aerial_ds={acounts}")
    return lines


def dryrun_multidevice(n_devices: int) -> list:
    """Spawn ``n_devices`` gloo CPU ranks and run, on a frames x points
    mesh (`sharding.mesh_shape`), the sharded KITTI batch and the tiled
    KITTI and aerial batches on tiny frames; prints (and returns) the two
    summary lines."""
    lines = run_ranks(_dryrun_rank, n_devices)[0]
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    dryrun_multidevice(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
