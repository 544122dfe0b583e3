"""Profiling and honest-timing helpers: the counterpart of
`pointclouds_tpu/utils/profiling.py` (`sync`, `measure_dispatch_floor`,
`time_fn`, `trace`), with the same names and return types.

On the card a torch call returns once its kernels are queued, so a wall
time means something only after `torch.cuda.synchronize`. `sync` makes
that wait, `time_fn` times a call between two of them, and
`measure_dispatch_floor` times the smallest call there is: the fixed cost
of one launch and one synchronize, below which no op can run (on the TPU
this was the ~28 ms RPC floor of a remote dispatch). `trace` records a
`torch.profiler` trace, with the card's kernels where there is a card.

Dropped: the JAX package's host transfer of one scalar in `sync` (there,
``block_until_ready`` returned early on a remote device; here
`torch.cuda.synchronize` is exact).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch


def _first_tensor(x):
    """The first tensor leaf of a nested tuple / list / dict, or None."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(x) -> None:
    """Block until the work that produced ``x`` has finished on its device:
    `torch.cuda.synchronize` for the first tensor leaf's card; nothing for
    a CPU tensor (its value is there when the call returns)."""
    leaf = _first_tensor(x)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


def measure_dispatch_floor(reps: int = 10, device: str = "cuda") -> float:
    """Median wall ms of ``a + 1`` on an 8-element float32 tensor, each call
    followed by `sync`. On the card this is the launch floor: one kernel
    launch plus one synchronize. Raises where ``device`` is a CUDA device
    and none is present (it does not measure the CPU instead)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("measure_dispatch_floor: no CUDA device")
    x = torch.ones(8, dtype=torch.float32, device=dev)
    sync(x + 1)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(x + 1)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(ts, 50))


def time_fn(fn, *args, reps: int = 5, warmup: int = 1):
    """(min_ms, p50_ms) of ``fn(*args)`` over ``reps`` calls, each ended by
    `sync` of its result; ``warmup`` calls first, untimed (kernel builds
    and allocator growth land there)."""
    for _ in range(warmup):
        sync(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return min(ts), float(np.percentile(ts, 50))


@contextlib.contextmanager
def trace(dirname: str | None = None):
    """`torch.profiler` context that writes a Chrome trace
    (``trace.json``, for chrome://tracing or Perfetto) into ``dirname``
    (default: a ``pointclouds_tpu_torch_trace`` folder in the temporary
    directory) and yields the folder. Records the card's kernels as well
    as the host's ops where a card is present."""
    if dirname is None:
        dirname = os.path.join(tempfile.gettempdir(),
                               "pointclouds_tpu_torch_trace")
    os.makedirs(dirname, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield dirname
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))
