"""Collectives over a process group: the port's counterparts of the
`jax.lax` collectives the reference's `shard_map` bodies call.

Each helper takes a tensor and a process group (a mesh axis,
``mesh.get_group("points")``) and returns a new tensor; none changes its
input. The group's backend runs the collective: NCCL for CUDA tensors,
gloo for CPU ones. One branch stages through the host on purpose: gloo
with a CUDA tensor (several ranks sharing one card, where NCCL refuses
two ranks a device) copies the tensor to the host, runs the collective
there and copies the result back; `STATS` counts those calls. A failed
collective raises; no helper computes locally instead.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

# Per collective: calls, calls staged through the host, and host ms spent
# inside them (the card synchronised around each call when `TIMED`).
STATS: dict = {}
TIMED = False


def reset_stats() -> None:
    STATS.clear()


def _run(name: str, group, fn, t: torch.Tensor, *extra):
    """``fn(t_host_or_device, *extra)`` -> result, with the host staging
    branch and the bookkeeping."""
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    s = STATS.setdefault(name, dict(calls=0, staged=0, ms=0.0))
    s["calls"] += 1
    if TIMED and t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    if staged:
        s["staged"] += 1
        out = fn(t.cpu(), *extra).to(t.device)
    else:
        out = fn(t, *extra)
    if TIMED and t.is_cuda:
        torch.cuda.synchronize(t.device)
    s["ms"] += (time.perf_counter() - t0) * 1e3
    return out


def axis_index(group) -> int:
    """This rank's position along the group's mesh axis
    (`lax.axis_index`)."""
    return dist.get_rank(group)


def axis_size(group) -> int:
    return dist.get_world_size(group)


def _reduce(op, name):
    def fn(t, group):
        def run(x):
            x = x.clone()
            dist.all_reduce(x, op=op, group=group)
            return x
        return _run(name, group, run, t)
    fn.__name__ = name
    fn.__doc__ = (f"`lax.{name}` over the group: an ``all_reduce`` of a copy "
                  "(float64 stays float64).")
    return fn


psum = _reduce(dist.ReduceOp.SUM, "psum")
pmin = _reduce(dist.ReduceOp.MIN, "pmin")
pmax = _reduce(dist.ReduceOp.MAX, "pmax")


def all_gather_tiled(t, group):
    """`lax.all_gather(..., tiled=True)` on axis 0: every rank's ``t``
    concatenated in group-rank order."""
    def run(x):
        x = x.contiguous()
        out = torch.empty((axis_size(group) * x.shape[0],) + x.shape[1:],
                          dtype=x.dtype, device=x.device)
        dist.all_gather(list(out.chunk(axis_size(group))), x, group=group)
        return out
    return _run("all_gather", group, run, t)


def all_to_all_tiled(t, group):
    """`lax.all_to_all(..., split_axis=0, concat_axis=0, tiled=True)`: the
    ith of the group's equal row blocks of ``t`` goes to rank i; the
    received blocks are concatenated in source order."""
    def run(x):
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out
    return _run("all_to_all", group, run, t)


def ppermute(t, perm, group):
    """`lax.ppermute`: for each (source, destination) pair of group ranks in
    ``perm``, the source's ``t`` lands on the destination. A rank that is no
    pair's destination gets zeros, as `ppermute` fills it."""
    me = axis_index(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]

    def run(x):
        x = x.contiguous()
        out = torch.zeros_like(x)
        ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, d),
                          group) for d in dst]
        ops += [dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s),
                           group) for s in src]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out
    return _run("ppermute", group, run, t)
