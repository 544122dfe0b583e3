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

The port's tracing lives here too (no twin in the JAX package): spans and
counters that the pipelines record inside their work, off by default.
`set_tracing(True)` switches them on; `frame(name, device)` opens one
record a pipeline call (`frames()`, `last_frame()`), `span(name)` times a
phase in it, `count(name, n)` adds a host value the program already holds,
and `host_read(site)` goes around each statement that makes the host wait
on the card. Off, each of these is one test of a module global: no
allocation and no torch call. On, a span opens a profiler range (so a
`trace()` holds the program's spans beside the card's kernels) and reads
the host's clock; the root, the stages and the collectives
(``span(name, card=True)``) also record a CUDA event pair on a card
frame, from a pool that finished frames give back to.

Dropped: the JAX package's host transfer of one scalar in `sync` (there,
``block_until_ready`` returned early on a remote device; here
`torch.cuda.synchronize` is exact).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
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


# ── Tracing ─────────────────────────────────────────────────────────────────

_TRACING = False
# Records of the last frames, oldest first.
_FRAMES: collections.deque = collections.deque(maxlen=4096)
_IDS = itertools.count(1)
_OPEN = threading.local()  # .frame: the record the thread is filling
# CUDA events free for reuse, by device index, and the card frames whose
# events are still to be read, oldest first.
_POOL: dict = {}
_PENDING: collections.deque = collections.deque()
_LOCK = threading.Lock()


def set_tracing(on: bool) -> None:
    """Switch spans, counters and host-read accounting on or off for the
    whole process."""
    global _TRACING
    _TRACING = bool(on)


def frames() -> list:
    """The records of the last 4,096 frames, oldest first."""
    return list(_FRAMES)


def last_frame():
    """The newest frame's record, or None."""
    return _FRAMES[-1] if _FRAMES else None


class _Off:
    """What `span`, `frame` and `host_read` return while tracing is off or
    no frame is open: a context that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _range(name: str):
    """A profiler range on the host's timeline. `record_function` would
    also put a range on the card's timeline, which a trace's reader would
    take for a device operation."""
    return torch._C._profiler._RecordFunctionFast(name)


class Span:
    """One timed extent of a frame: its ``name``, the index of its
    ``parent`` in the frame's spans (-1 for the root), the ``frame`` id, the
    host's ``perf_counter_ns`` at ``t0``/``t1``, and for a span timed on the
    card (``card``, on a card frame) its CUDA-event ``ms``, once read."""

    __slots__ = ("name", "parent", "frame", "t0", "t1", "card", "ms",
                 "_events", "_rec", "_range")

    def __init__(self, rec, name: str, card: bool = False):
        self.name = name
        self.frame = rec.id
        self.parent = -1
        self.t0 = self.t1 = 0
        self.card = card and rec.stream is not None
        self.ms = None
        self._events = None
        self._rec = rec

    def __enter__(self):
        rec = self._rec
        if rec._stack:
            self.parent = rec._stack[-1]
        rec._stack.append(len(rec.spans))
        rec.spans.append(self)
        self._range = _range(self.name)
        self._range.__enter__()
        if self.card:
            self._events = (rec._event(), rec._event())
            self._events[0].record(rec.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        rec = self._rec
        if self.card:
            self._events[1].record(rec.stream)
        self._range.__exit__(*exc)
        self._range = self._rec = None
        rec._stack.pop()
        return False

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e6


class FrameRecord:
    """What one frame recorded: ``spans`` in the order they opened (the
    root first), ``counts`` by name, and ``launches``, the kernel launches
    per wrapper (`kernels.LAUNCHES`) across the root span. Read it once the
    frame has closed."""

    def __init__(self, name: str, device):
        self.id = next(_IDS)
        self.name = name
        dev = None if device is None else torch.device(device)
        self.stream = (torch.cuda.current_stream(dev)
                       if dev is not None and dev.type == "cuda" else None)
        self._pool = (None if self.stream is None
                      else _POOL.setdefault(self.stream.device_index, []))
        self._read = self.stream is None  # CUDA events read
        self.spans: list[Span] = []
        self.counts: dict = {}
        self.launches: dict = {}
        self._stack: list[int] = []

    def _event(self):
        pool = self._pool
        return pool.pop() if pool else torch.cuda.Event(enable_timing=True)

    def _read_events(self, wait: bool) -> bool:
        """Set each card span's ``ms`` from its CUDA events and give the
        events back to the pool. Without ``wait`` only once the card has
        passed the frame's last event (no host wait); with it, the first
        read waits for that event, the only synchronisation tracing makes.
        Returns whether the events have been read."""
        with _LOCK:
            if self._read:
                return True
            last = self.spans[0]._events[1]
            if wait:
                last.synchronize()
            elif not last.query():
                return False
            for s in self.spans:
                if s._events is not None:
                    s.ms = s._events[0].elapsed_time(s._events[1])
                    self._pool.extend(s._events)
                    s._events = None
            self._read = True
            return True

    def _ms(self, s: Span) -> float:
        return s.host_ms if s.ms is None else s.ms

    def names(self) -> list[str]:
        """Span names in the order they first opened."""
        return list(dict.fromkeys(s.name for s in self.spans))

    def span_ms(self, name: str) -> float:
        """ms in the spans ``name``, summed over their instances: CUDA-event
        ms for the spans timed on the card (the root, the stages, the
        collectives) on a card frame, the host's otherwise (0.0 if none
        ran)."""
        self._read_events(wait=True)
        return sum(self._ms(s) for s in self.spans if s.name == name)

    def host_ms(self, name: str) -> float:
        return sum(s.host_ms for s in self.spans if s.name == name)

    def self_ms(self, name: str) -> float:
        """`host_ms` of the spans ``name`` less their children's, on the
        host's clock, which every span keeps."""
        idx = {i for i, s in enumerate(self.spans) if s.name == name}
        kids = sum(s.host_ms for s in self.spans if s.parent in idx)
        return self.host_ms(name) - kids

    def count(self, name: str) -> int:
        return self.counts.get(name, 0)


class _Frame:
    """The root span of a frame: a new record, kept on exit."""

    __slots__ = ("rec", "root", "before")

    def __init__(self, name: str, device):
        self.rec = FrameRecord(name, device)

    def __enter__(self):
        from ..spatial.kernels import LAUNCHES

        # Earlier card frames the card has finished give their events back.
        while _PENDING and _PENDING[0]._read_events(wait=False):
            _PENDING.popleft()
        self.before = dict(LAUNCHES)
        _OPEN.frame = self.rec
        self.root = Span(self.rec, self.rec.name, card=True)
        self.root.__enter__()
        return self.rec

    def __exit__(self, *exc):
        from ..spatial.kernels import LAUNCHES

        self.root.__exit__(*exc)
        _OPEN.frame = None
        self.rec.launches = {k: v - self.before.get(k, 0)
                             for k, v in LAUNCHES.items()
                             if v != self.before.get(k, 0)}
        _FRAMES.append(self.rec)
        if not self.rec._read:
            _PENDING.append(self.rec)
        return False


def frame(name: str, device=None):
    """The root span of one pipeline call on ``device`` (timed by CUDA
    events too on a card): a new record, kept among `frames()` when it
    closes. Inside an open frame it is a span of that frame."""
    if not _TRACING:
        return _OFF
    rec = getattr(_OPEN, "frame", None)
    if rec is not None:
        return Span(rec, name, card=True)
    return _Frame(name, device)


def span(name: str, card: bool = False):
    """A timed child of the innermost open span of the thread's frame, on
    the host's clock; with ``card`` on the card's too (CUDA events from a
    reused pool, read when the record is read): for the spans that a
    reader times on the card, the stages and the collectives."""
    if not _TRACING:
        return _OFF
    rec = getattr(_OPEN, "frame", None)
    return _OFF if rec is None else Span(rec, name, card)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open frame's counter ``name``. ``n`` is a host value
    the program already holds: a counter never reads the card."""
    if not _TRACING:
        return
    rec = getattr(_OPEN, "frame", None)
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + n


class _HostRead:
    """Counts a statement that waits on the card (`host_reads`) and times
    the wait, on the host's clock, as span ``host_read.<site>``. On a card
    frame a sync debug mode (`torch.cuda.set_sync_debug_mode`) is lifted
    inside it: the wait is accounted."""

    __slots__ = ("span", "mode")

    def __init__(self, rec, site: str):
        self.span = Span(rec, "host_read." + site)

    def __enter__(self):
        rec = self.span._rec
        rec.counts["host_reads"] = rec.counts.get("host_reads", 0) + 1
        self.mode = (0 if rec.stream is None
                     else torch.cuda.get_sync_debug_mode())
        if self.mode:
            torch.cuda.set_sync_debug_mode(0)
        self.span.__enter__()

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        if self.mode:
            torch.cuda.set_sync_debug_mode(self.mode)
        return False


def host_read(site: str):
    """Around each statement of the pipelines' card path that makes the
    host wait on the card (``.tolist()``, ``int(t)``, ``bool(t)``, a 0-d
    tensor index, an upload from pageable memory): the statement itself is
    unchanged. The reads at a site are its spans ``host_read.<site>``."""
    if not _TRACING:
        return _OFF
    rec = getattr(_OPEN, "frame", None)
    return _OFF if rec is None else _HostRead(rec, site)
