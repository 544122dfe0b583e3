"""The readers of the program's own trace (`programtrace.py`): a CPU
``--trace 1`` run of each tiny cell reports the metrics read from the
frame records of its window, and a program without tracing (the parent
of the change that added it) gives them nothing to read."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness, programtrace  # noqa: E402
from portbench.tests._portbench_tiny import tiny_checkout  # noqa: E402
from pointclouds_tpu_torch.utils import profiling  # noqa: E402

NEW = {
    "aerial-3dep-ql2.tiles": ["host_reads_per_frame", "host_read_wait_ms",
                              "stage_ms.compact", "cluster_rounds"],
    "kitti-hdl64.snow": ["host_reads_per_frame", "host_read_wait_ms",
                         "stage_ms.compact", "cluster_rounds"],
    "kitti-hdl64.stream": ["cluster_rounds.device"],
}


def cpu_checkout(tmp_path):
    """The tiny checkout without the per-layer metrics that time calls
    with CUDA events (`harness.span_wrapper` needs a card)."""
    root = tiny_checkout(tmp_path)
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["per_layer"] = [m for m in man["per_layer"] if not getattr(
        harness.load_metric(m["name"], root), "SPANS", None)]
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


@pytest.fixture
def tracing_restored():
    yield
    profiling.set_tracing(False)
    programtrace.WINDOW.clear()


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_run_reports_the_program_metrics(tmp_path, cell,
                                                tracing_restored):
    root = cpu_checkout(tmp_path)
    res = harness.run(cell, 2**31 + 11, 0.5, True,
                      t_start=time.perf_counter(), device="cpu", root=root,
                      bench=root)
    assert res["correct"] is True, res["compared"]
    metrics = res["metrics"]
    for name in NEW[cell]:
        assert name in metrics, (name, sorted(metrics))
    # The window's frames only: one record a frame, each a whole frame.
    assert len(programtrace.WINDOW) == res["attempted"]
    assert all(f.spans[0].name in ("kitti", "aerial")
               for f in programtrace.WINDOW)
    if "cluster_rounds" in metrics:
        assert metrics["cluster_rounds"]["value"] >= 1
        assert metrics["stage_ms.compact"]["value"] > 0
        assert metrics["host_reads_per_frame"]["value"] > 0
        assert metrics["host_read_wait_ms"]["value"] >= 0
    else:
        assert metrics["cluster_rounds.device"]["value"] >= 1


def test_untraced_run_leaves_tracing_off(tmp_path, tracing_restored):
    root = tiny_checkout(tmp_path)
    profiling.set_tracing(False)
    n = len(profiling.frames())
    harness.run("kitti-hdl64.snow", 2**31 + 13, 0.3, False,
                t_start=time.perf_counter(), device="cpu", root=root,
                bench=root)
    with profiling.frame("probe"):  # records nothing with tracing off
        pass
    assert len(profiling.frames()) == n


def test_program_without_tracing_reads_nothing(tracing_restored,
                                               monkeypatch):
    for name in ("set_tracing", "last_frame"):
        monkeypatch.delattr(profiling, name)
    programtrace.start()
    for fn in programtrace.COUNTS.values():
        assert fn((), {}, None) == 0
    rec = harness.Record(frame_s=[0.1])
    for name in sorted({n for names in NEW.values() for n in names}):
        assert harness.load_metric(name).read(rec) is None
