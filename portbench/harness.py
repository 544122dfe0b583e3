"""The benchmark of `pointclouds_tpu_torch`: one cell of `BENCHMARK.json`
run for a fixed window on one card, its metrics, and the check of its
outputs against the reference.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name: `configs/<config>.json` (the pipeline's entry,
arguments, scene, reference and limits), `traffic/<mix>.json` (read by
`generator.py`), `feeds/<name>.py` (the configuration's frames and how
the program is called, read and judged on them; `cloud` by default),
`metrics/<metric>.py` (a reader of the run's record) and
`reference/<name>.py` (the plain reference and its judge).

A run: set-up (the ring of frames made on the host from the seed and moved
to the card, two warm passes over it), then a closed loop of frames back
to back for ``--seconds``, each frame ending when its labels and flags
have reached the host. An end-to-end metric whose reader sets
``WINDOW_TRACE`` (`frame_device_ms`) has torch.profiler over every frame
of the window, its start-up in set-up. ``--trace 1`` adds CUDA-event spans
and counters
around the calls the metric files name, then profiles two more passes over
the ring: one with torch.profiler for the device's busy time, launches and
idle gaps, one with the kernels' arguments read for their bounds. Last, a
sample of the window's frames, drawn from the seed among all of them, is
compared with the reference.
"""

from __future__ import annotations

import gc
import heapq
import importlib
import importlib.util
import json
import os
import re
import resource
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pointclouds_tpu")
PROGRAM = "pointclouds_tpu_torch"


class RunError(RuntimeError):
    """A run that cannot give a result: it exits non-zero and prints none."""


# ── Finding things by name ──────────────────────────────────────────────────


def manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise RunError(f"no {path}")
    return json.loads(path.read_text())


def cell_of(man: dict, name: str) -> tuple[dict, dict]:
    """The workload entry ``name`` and its configuration entry."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    return cell, configs[cell["config"]]


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def metrics_of(man: dict, cell: str, kind: str) -> list[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports."""
    return [m for m in man[kind]
            if "workloads" not in m or cell in m["workloads"]]


def load_metric(name: str, bench: Path = BENCH):
    """The reader module `metrics/<name>.py`."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reference(name: str):
    return importlib.import_module(f"portbench.reference.{name}")


def load_feed(name: str, bench: Path = BENCH):
    """The feed module `feeds/<name>.py`: its ``Feed`` makes a
    configuration's frames and calls, reads and judges the program on
    them (`feeds/cloud.py` says what it supplies)."""
    path = bench / "feeds" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_feed_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def feed_of(cfg: dict, mix: dict, seed: int, device, bench: Path = BENCH):
    """The configuration's feed, with the ring of ``seed`` on ``device``."""
    mod = load_feed(cfg.get("feed", "cloud"), bench)
    return mod.Feed(cfg, mix, seed, device)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


# ── The record the metric readers read ──────────────────────────────────────


@dataclass
class Record:
    setup_s: float = 0.0
    wall_s: float = 0.0
    frame_s: list = field(default_factory=list)
    spans_ms: dict = field(default_factory=dict)  # "module:attr" -> total
    counts: dict = field(default_factory=dict)  # "module:attr" -> total
    profile: dict | None = None
    window_busy_s: float = 0.0  # device busy in the window, if traced,
    window_busy_frames: int = 0  # over the frames of its whole sessions

    @property
    def frames(self) -> int:
        return len(self.frame_s)

    def span_ms_per_frame(self, keys) -> float | None:
        """Mean ms a frame spent in the calls ``keys`` (None: none ran)."""
        hit = [self.spans_ms[k] for k in keys if k in self.spans_ms]
        if not hit or not self.frames:
            return None
        return sum(hit) / self.frames

    def count_per_frame(self, key) -> float | None:
        if key not in self.counts or not self.frames:
            return None
        return self.counts[key] / self.frames


# ── Instruments ─────────────────────────────────────────────────────────────


class Patches:
    """Module attributes replaced by wrappers, put back on exit."""

    def __init__(self):
        self.saved = []

    def wrap(self, key: str, make):
        mod_name, attr = key.split(":")
        try:
            mod = importlib.import_module(mod_name)
        except ImportError:
            return
        orig = getattr(mod, attr, None)
        if orig is None:
            return
        self.saved.append((mod, attr, orig))
        setattr(mod, attr, make(orig))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self.saved):
            setattr(mod, attr, orig)
        self.saved.clear()


def span_wrapper(key: str, events: dict):
    import torch

    def make(orig):
        def timed(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            r = orig(*a, **k)
            e1.record()
            events.setdefault(key, []).append((e0, e1))
            return r
        return timed
    return make


def count_wrapper(key: str, fn, totals: dict):
    def make(orig):
        def counted(*a, **k):
            r = orig(*a, **k)
            totals.setdefault(key, []).append(fn(a, k, r))
            return r
        return counted
    return make


def label_wrapper(label: str):
    from torch.profiler import record_function

    def make(orig):
        def labelled(*a, **k):
            with record_function(label):
                return orig(*a, **k)
        return labelled
    return make


def kernel_names() -> re.Pattern:
    """The port's hand-written kernels, by the `__global__` functions of its
    CUDA sources, as one pattern on profiler event names."""
    from portbench import yardstick

    csrc = Path(importlib.import_module(yardstick.KERNEL_MODULE).__file__)
    names = set()
    for src in (csrc.parent / "csrc").glob("*.cu*"):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
            src.read_text()))
    return re.compile(r"\b(" + "|".join(sorted(names)) + r")\b")


def innermost(events, points):
    """For each of the ascending ``points``, the name of the latest-starting
    of ``events`` [(start, end, name)] that spans it (None where none
    does): the host operation running at that moment."""
    evs = sorted(events)
    heap, k, out = [], 0, []
    for x in points:
        while k < len(evs) and evs[k][0] <= x:
            heapq.heappush(heap, (-evs[k][0], evs[k][1], evs[k][2]))
            k += 1
        while heap and heap[0][1] < x:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def merge(intervals) -> list[list]:
    """The union of ``intervals`` [(start, end)] as disjoint ascending
    [start, end] pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class WindowTrace:
    """torch.profiler over every frame of a window, for an end-to-end
    metric read from the device's trace: one session a ``FRAMES`` frames,
    ended and the next begun between two frames (one session would
    outgrow the profiler's buffers over a whole window).

    ``read()``, once the window has closed: the seconds in which an
    operation ran on the device (the union of its operations) and the
    frames they served, over every session whose record is whole. A session
    that holds under ``WHOLE`` of the median session's device operations a
    frame lost records in the profiler, which happens now and then without
    a warning and would read low: its frames and its time are left out, and
    named on standard error."""

    FRAMES = 128
    WHOLE = 0.9

    def __init__(self):
        self.prof = None
        self.n = 0
        self.sessions = []  # (frames, the session's profiler results)

    def full(self) -> bool:
        return self.prof is not None and self.n >= self.FRAMES

    def before_frame(self):
        if self.full():
            self.stop()
        if self.prof is None:
            self.prof = profiler()
            self.prof.start()
        self.n += 1

    def stop(self):
        if self.prof is not None:
            self.prof.stop()
            self.sessions.append((self.n, self.prof.profiler.kineto_results))
            self.prof, self.n = None, 0

    def read(self) -> tuple[float, int]:
        from torch.autograd import DeviceType

        rows = []  # (frames, device operations, busy ns)
        for n, results in self.sessions:
            dev = [(e.start_ns(), e.end_ns()) for e in results.events()
                   if e.device_type() == DeviceType.CUDA]
            rows.append((n, len(dev), sum(e - s for s, e in merge(dev))))
        self.sessions.clear()
        # Full sessions replay the same frames in the same proportions.
        per_frame = ([ops / n for n, ops, _ in rows if n == self.FRAMES]
                     or [ops / n for n, ops, _ in rows if n])
        ref = float(np.median(per_frame)) if per_frame else 0.0
        busy, frames = 0, 0
        for k, (n, ops, ns) in enumerate(rows):
            if ops < self.WHOLE * ref * n:
                log(f"window trace: session {k} ({n} frames) holds "
                    f"{ops / n:.1f} device operations a frame against "
                    f"{ref:.1f}: left out")
                continue
            busy += ns
            frames += n
        return busy / 1e9, frames


def profiler():
    """A torch.profiler session of the device's operations alone (of the
    host's where there is no card, as in CPU tests)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA
                               if torch.cuda.is_available()
                               else ProfilerActivity.CPU])


def profile_pass(run_frames, labels: list[str]) -> dict:
    """torch.profiler over ``run_frames()``: device busy seconds (the union
    of device operations), the window, kernels launched, device time by
    operation, the hand-written kernels' device time, and the idle gaps
    named by the host operation that ran in each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_frames()
        window = time.perf_counter() - t0
    evs = prof.events()
    label_set = set(labels)
    # The labels' own ranges on the device's timeline are no operations.
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in evs if e.device_type == DeviceType.CUDA
                 and e.name not in label_set)
    cpu = [(e.time_range.start, e.time_range.end, e.name)
           for e in evs if e.device_type == DeviceType.CPU]
    if not dev or not cpu:
        return {"window_s": window, "busy_s": 0.0}
    hand = kernel_names()
    by_name, hand_us, launches = {}, 0.0, 0
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if not name.startswith(("Memcpy", "Memset")):
            launches += 1
            if hand.search(name):
                hand_us += e - s
    merged = merge((s, e) for s, e, _ in dev)
    busy_us = sum(e - s for s, e in merged)
    lo = min(s for s, _, _ in cpu)
    hi = max(e for _, e, _ in cpu)
    edges = [lo] + [x for s, e in merged for x in (s, e)] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    mids = [(s + e) / 2 for s, e in gaps]
    stages = innermost([c for c in cpu if c[2] in label_set], mids)
    ops = innermost([c for c in cpu if c[2] not in label_set], mids)
    idle = {}
    for (s, e), stage, op in zip(gaps, stages, ops):
        name = (stage or "between stages") + " / " + (op or "host")
        idle[name] = idle.get(name, 0.0) + (e - s)

    def top(d):
        return [[n[:100], v / 1e6] for n, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"window_s": window, "busy_s": busy_us / 1e6,
            "launches": launches, "kernel_device_s": hand_us / 1e6,
            "device_ops": top(by_name), "idle_gaps": top(idle)}


def bound_pass(run_frames) -> float:
    """Seconds the hand-written kernels' work would take at the card's
    peaks (`yardstick`), over ``run_frames()``."""
    from portbench import yardstick

    kmod = importlib.import_module(yardstick.KERNEL_MODULE)
    total = [0.0]

    def make(name):
        def wrap(orig):
            def measured(*a, **k):
                out = orig(*a, **k)
                nbytes, ops = yardstick.work(name, a, k, out)
                total[0] += yardstick.bound_ms(nbytes, ops)[0] / 1e3
                return out
            return measured
        return wrap

    with Patches() as p:
        for mod_name, mod in list(sys.modules.items()):
            if (not mod_name.startswith(PROGRAM + ".") or mod is kmod
                    or mod is None):
                continue
            for name in yardstick.KERNELS:
                if getattr(mod, name, None) is getattr(kmod, name, None):
                    p.wrap(f"{mod_name}:{name}", make(name))
        run_frames()
    return total[0]


# ── The run ─────────────────────────────────────────────────────────────────


def host_probe_ms() -> float:
    """A fixed piece of pure Python, timed: the host's speed at this moment,
    printed beside the window for context (no metric reads it)."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i & 7
    return (time.perf_counter() - t0) * 1e3


def card_line() -> tuple[str, float | None]:
    import torch

    name = torch.cuda.get_device_name(0)
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        limit = float(res.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        limit = None
    return name, limit


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", root: Path = ROOT,
        bench: Path = BENCH) -> dict:
    """One run of ``workload``; returns the result line's object."""
    import torch

    # One host thread: the program's host side is Python launching kernels,
    # and idle worker threads only add to the host's noise.
    torch.set_num_threads(1)
    man = manifest(root)
    cell, centry = cell_of(man, workload)
    cfg = load_json(root / centry["file"])
    mix = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: nothing is measured on the CPU")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{workload} needs {cell['chips']} cards, "
                           f"{torch.cuda.device_count()} found")
    ref = load_reference(cfg["reference"])
    e2e = [] if trace else metrics_of(man, workload, "end_to_end")
    layer = metrics_of(man, workload, "per_layer") if trace else []
    readers = {m["name"]: load_metric(m["name"], bench) for m in e2e + layer}

    # Set-up: the ring, the program's entry, two warm passes.
    feed = feed_of(cfg, mix, seed, device, bench)
    ring = feed.ring

    def frame(i: int):
        out = feed.run(i)
        feed.read(out)
        return out

    check_n = int(cfg.get("check_frames", 1))
    for i in range(ring):
        frame(i)
    # An end-to-end metric read from the device's trace has the profiler
    # over the whole window; its start-up belongs to set-up.
    wtrace = None
    if any(getattr(readers[m["name"]], "WINDOW_TRACE", False) for m in e2e):
        wtrace = WindowTrace()
        for i in range(ring):
            wtrace.before_frame()
            frame(i)
        wtrace.stop()
        wtrace.sessions.clear()
    kept = []
    for i in range(ring):
        out = frame(i)
        if len(kept) < check_n:
            kept.append(out)  # the pool then holds the sample's outputs
    del kept, out
    # The frames checked: a sample of ``check_n`` drawn from the seed among
    # every frame of the window (reservoir sampling: frame i takes a slot
    # with chance check_n / (i + 1)).
    pick = np.random.default_rng([int(seed) & (2**64 - 1), 2])

    spans = sorted({key for m in layer
                    for key in getattr(readers[m["name"]], "SPANS", ())})
    counters = {key: fn for m in layer
                for key, fn in getattr(readers[m["name"]], "COUNTS",
                                       {}).items()}
    rec = Record()
    events, counts = {}, {}
    with Patches() as p:
        for key in spans:
            p.wrap(key, span_wrapper(key, events))
        for key, fn in counters.items():
            p.wrap(key, count_wrapper(key, fn, counts))
        if device == "cuda":
            torch.cuda.synchronize(device)
        rec.setup_s = time.perf_counter() - t_start
        slots = []  # (frame index, its output)
        i = 0
        # No collector pause lands inside the window.
        gc.collect()
        gc.disable()
        t_win = time.perf_counter()
        while True:
            if wtrace:
                if wtrace.full():
                    wtrace.stop()
                    if time.perf_counter() - t_win >= seconds:
                        break
                wtrace.before_frame()
            ts = time.perf_counter()
            out = frame(i)
            te = time.perf_counter()
            rec.frame_s.append(te - ts)
            if len(slots) < check_n:
                slots.append((i, out))
            else:
                j = int(pick.integers(i + 1))
                if j < check_n:
                    slots[j] = (i, out)
            i += 1
            if te - t_win >= seconds:
                break
        rec.wall_s = te - t_win
        gc.enable()
        checked = dict(slots)
        del out, slots
    if wtrace:
        wtrace.stop()
        t0 = time.perf_counter()
        rec.window_busy_s, rec.window_busy_frames = wtrace.read()
        log(f"window trace: device busy {rec.window_busy_s:.4f} s over "
            f"{rec.window_busy_frames} frames, read in "
            f"{time.perf_counter() - t0:.1f} s; host peak "
            f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss >> 10} MiB")
    log(f"host probe: {host_probe_ms():.3f} ms")
    ms = np.array(rec.frame_s) * 1e3
    log(f"window: {rec.frames} frames in {rec.wall_s:.3f} s; frame ms "
        f"min {ms.min():.3f}, median {np.median(ms):.3f}, p95 "
        f"{np.percentile(ms, 95):.3f}, max {ms.max():.3f}; set-up "
        f"{rec.setup_s:.3f} s")
    rec.spans_ms = {k: sum(a.elapsed_time(b) for a, b in ev)
                    for k, ev in events.items()}
    rec.counts = {k: float(sum(float(v) for v in vs))
                  for k, vs in counts.items()}

    if trace:
        labels = sorted({key.split(":")[1] for key in spans})
        prof_frames = range(i, i + 2 * ring)

        def run_frames():
            for j in prof_frames:
                frame(j)

        t0 = time.perf_counter()
        with Patches() as p:
            for key in spans:
                p.wrap(key, label_wrapper(key.split(":")[1]))
            rec.profile = profile_pass(run_frames, labels)
        t1 = time.perf_counter()
        rec.profile["frames"] = len(prof_frames)
        rec.profile["kernel_bound_s"] = bound_pass(run_frames)
        log(f"traced passes: profile {t1 - t0:.1f} s, bounds "
            f"{time.perf_counter() - t1:.1f} s")

    mem = (torch.cuda.max_memory_allocated(device) if device == "cuda"
           else 0)
    found = forbidden_modules()
    if found:
        raise RunError("loaded in the measuring process: " + ", ".join(found))

    # The check: the sampled frames against the reference.
    limits = cfg.get("limits", {})
    worst = {}
    failed = 0
    log(f"checked frames: {sorted(checked)} of {rec.frames}")
    for j in sorted(checked):
        out = checked.pop(j)
        nums = feed.judge(ref, j, out)
        del out
        bad = False
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
            bad |= not (v <= limits.get(k, float("-inf")))
        failed += bad
    compared = {k: {"value": v, "limit": limits.get(k)}
                for k, v in worst.items()}
    correct = bool(worst) and all(
        v["limit"] is not None and v["value"] <= v["limit"]
        for v in compared.values())
    metrics = {}
    for m in (layer if trace else e2e):
        value = readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    name, limit = card_line() if device == "cuda" else ("cpu", None)
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": name,
           "count": 1, "memory_peak_bytes": int(mem), "power_limit_w": limit}
    result = {"correct": correct, "attempted": rec.frames, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and rec.profile:
        dev["busy_s"] = rec.profile["busy_s"]
        dev["window_s"] = rec.profile["window_s"]
        if "device_ops" in rec.profile:
            result["breakdown"] = {"device_ops": rec.profile["device_ops"],
                                   "idle_gaps": rec.profile["idle_gaps"]}
    result["compared"] = compared
    for k, v in compared.items():
        log(f"compared {k}: {v['value']} (limit {v['limit']})")
    return result


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    try:
        result = run(a.workload, a.seed, a.seconds, bool(a.trace),
                     t_start=t_start)
    except RunError as e:
        log(f"portbench: {e}")
        return 2
    print(json.dumps(result), flush=True)
    return 0
