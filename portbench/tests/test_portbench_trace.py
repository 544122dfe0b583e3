"""The trace reader's pieces that need no card: naming an idle gap by the
host operation that ran in it, a profiled pass that saw no device
operation reporting nothing to read, and the window's trace summing the
device's busy time over its sessions and leaving out one that lost
operations."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402


def test_innermost_names_the_latest_started_spanning_event():
    events = [(0, 10, "outer"), (2, 4, "a"), (5, 9, "b"), (6, 7, "c"),
              (12, 13, "d")]
    got = harness.innermost(events, [1, 3, 4.5, 6.5, 8, 11, 12.5])
    assert got == ["outer", "a", "outer", "c", "b", None, "d"]


def test_profile_pass_without_device_operations_reads_nothing():
    prof = harness.profile_pass(lambda: torch.ones(100).sum(), ["stage"])
    assert prof["busy_s"] == 0.0 and prof["window_s"] > 0
    rec = harness.Record(frame_s=[0.1])
    rec.profile = dict(prof, frames=1)
    for name in ("device_idle_pct", "launches_per_frame", "kernels_roofline"):
        assert harness.load_metric(name).read(rec) is None


class _Event:
    def __init__(self, s, e, dev=True):
        from torch.autograd import DeviceType
        self._s, self._e = s, e
        self._d = DeviceType.CUDA if dev else DeviceType.CPU

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d


class _Results:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _session(n, *intervals):
    return (n, _Results([_Event(s, e) for s, e in intervals]
                        + [_Event(0, 10**9, dev=False)]))


def test_window_trace_sums_the_device_union_over_sessions():
    wt = harness.WindowTrace()
    full = harness.WindowTrace.FRAMES
    wt.sessions = [_session(full, (0, 100), (50, 150), (200, 300)),
                   _session(full, (0, 100), (100, 180), (400, 420)),
                   _session(full, (0, 10), (20, 30), (40, 50)),
                   _session(1, (7, 8))]
    # 250 + 200 + 30 + 1 ns: overlaps and the host's events counted once.
    assert wt.read() == (481e-9, 3 * full + 1)
    assert wt.sessions == []


def test_window_trace_leaves_out_a_session_that_lost_device_operations():
    full = harness.WindowTrace.FRAMES
    whole = [(i, i + 1) for i in range(0, 2 * full, 2)]
    wt = harness.WindowTrace()
    wt.sessions = [_session(full, *whole), _session(full, *whole),
                   _session(full, *whole[:full // 2]),
                   _session(2, *whole[:2]), _session(2, *whole[:1])]
    # The third and the last hold half the operations a frame: left out.
    assert wt.read() == (2 * full * 1e-9 + 2e-9, 2 * full + 2)


def test_window_trace_without_a_card_reads_nothing():
    wt = harness.WindowTrace()
    for _ in range(harness.WindowTrace.FRAMES + 2):
        wt.before_frame()
        torch.ones(64).sum()
    assert wt.full() is False
    wt.stop()
    assert [n for n, _ in wt.sessions] == [harness.WindowTrace.FRAMES, 2]
    rec = harness.Record(frame_s=[0.01] * 130)
    rec.window_busy_s, rec.window_busy_frames = wt.read()
    assert (rec.window_busy_s, rec.window_busy_frames) == (0.0, 130)
    assert harness.load_metric("frame_device_ms").read(rec) is None
