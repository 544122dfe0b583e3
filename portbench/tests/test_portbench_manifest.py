"""BENCHMARK.json against the benchmark's contract, and the harness finding
a configuration, a cell, a traffic mix, a metric and a feed added as
files."""

from __future__ import annotations

import json
import re
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    cells = len(MAN["workloads"])
    # The whole check, at 24 cells, fits its 43,200 seconds.
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_and_lines(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert set(e) <= KEYS[section], e
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4)
        if section == "configs":
            assert len(e["reduced"]) <= 16
            assert all(NAME.match(k) for k in e["reduced"])
            path = ROOT / e["file"]
            assert path.is_file() and e["file"].startswith("portbench/")
            assert json.loads(path.read_text())["name"] == e["name"]


def test_metrics_sources_bounds_and_moves():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        target = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in MAN["workloads"]]):
            # Every cell that reports the metric reports what it moves.
            assert "workloads" not in target or cell in target["workloads"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(LINE.match(layer) for layer in layers)


def test_every_cell_reports_enough_and_every_config_is_used():
    cells = [w["name"] for w in MAN["workloads"]]
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for cell in cells:
        e2e = [m["name"] for m in harness.metrics_of(MAN, cell, "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(MAN, cell, "per_layer")
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(
        1, len(cells) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_cells_files_exist(cell):
    w, c = harness.cell_of(MAN, cell)
    cfg = harness.load_json(ROOT / c["file"])
    assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    assert (BENCH / "reference" / f"{cfg['reference']}.py").is_file()
    assert hasattr(harness.load_feed(cfg.get("feed", "cloud")), "Feed")
    assert cfg["limits"], "every compared number has its limit"
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert hasattr(harness.load_metric(m["name"]), "read")


def test_added_files_are_found(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric as files and entries: the harness finds them by
    name, with no file of the harness edited."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    cfg = json.loads((BENCH / "configs" / "kitti-hdl64.json").read_text())
    cfg["name"] = "kitti-os1"
    cfg["scene"] = {"kind": "velodyne", "n_points": 262144}
    (tmp_path / "configs" / "kitti-os1.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "burst.json").write_text(json.dumps({"ring": 3}))
    (tmp_path / "metrics" / "stage_ms.new.py").write_text(
        "SPANS = ['pointclouds_tpu_torch.pipelines.kitti:sweep_cluster_labels']"
        "\n\ndef read(rec):\n    return rec.span_ms_per_frame(SPANS)\n")
    man = dict(MAN)
    man["configs"] = MAN["configs"] + [dict(
        name="kitti-os1", source="x", file="configs/kitti-os1.json",
        reduced=[], why="x")]
    man["workloads"] = MAN["workloads"] + [dict(
        name="kitti-os1.burst", config="kitti-os1", traffic="burst", chips=1,
        why="x")]
    man["per_layer"] = MAN["per_layer"] + [dict(
        name="stage_ms.new", unit="ms", better="lower",
        source="program_span", layer="clustering", moves="frame_ms",
        workloads=["kitti-os1.burst"])]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    found = harness.manifest(tmp_path)
    cell, centry = harness.cell_of(found, "kitti-os1.burst")
    assert harness.load_json(tmp_path / centry["file"])["scene"][
        "n_points"] == 262144
    mix = harness.load_json(tmp_path / "traffic" / f"{cell['traffic']}.json")
    assert mix["ring"] == 3
    layer = harness.metrics_of(found, "kitti-os1.burst", "per_layer")
    assert "stage_ms.new" in [m["name"] for m in layer]
    reader = harness.load_metric("stage_ms.new", tmp_path)
    rec = harness.Record(frame_s=[0.01, 0.01])
    rec.spans_ms = {reader.SPANS[0]: 3.0}
    assert reader.read(rec) == 1.5


TOY_FEED = """
import torch


class Feed:
    # Frames of another shape than one cloud: pairs of index vectors.
    def __init__(self, cfg, mix, seed, device):
        self.ring = mix["ring"]
        self.n = cfg["pairs"]

    def run(self, i):
        a = torch.arange(self.n) + i
        return a, a.flip(0)

    def read(self, out):
        return torch.stack(out).cpu()

    def control(self, ref, i, dtype):
        return self.run(i)

    def judge(self, ref, i, out):
        return {"pair_gap": int((out[0] != out[1].flip(0)).sum())}
"""


def test_added_feed_is_found_and_run(tmp_path):
    """A configuration whose frames are not one cloud brings its feed as
    a file, `feeds/<name>.py`, and names it: a whole run (the look for a
    card skipped) makes, calls, reads and judges its frames."""
    for sub in ("configs", "traffic", "metrics", "feeds"):
        (tmp_path / sub).mkdir()
    for m in ("frame_ms", "setup_s"):
        (tmp_path / "metrics" / f"{m}.py").write_text(
            (BENCH / "metrics" / f"{m}.py").read_text())
    (tmp_path / "feeds" / "pairs.py").write_text(TOY_FEED)
    (tmp_path / "configs" / "toy.json").write_text(json.dumps(dict(
        name="toy", feed="pairs", pairs=64, reference="kitti",
        check_frames=2, limits={"pair_gap": 0})))
    (tmp_path / "traffic" / "pairs.json").write_text(json.dumps({"ring": 3}))
    man = dict(MAN, configs=[dict(name="toy", source="x",
                                  file="configs/toy.json", reduced=[],
                                  why="x")],
               workloads=[dict(name="toy.pairs", config="toy",
                               traffic="pairs", chips=1, why="x")],
               end_to_end=[{k: v for k, v in m.items() if k != "workloads"}
                           for m in MAN["end_to_end"]
                           if m["name"] in ("frame_ms", "setup_s")])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    res = harness.run("toy.pairs", 2**31 + 1, 0.2, False,
                      t_start=time.perf_counter(), device="cpu",
                      root=tmp_path, bench=tmp_path)
    assert res["correct"] is True and res["attempted"] > 0
    assert res["compared"] == {"pair_gap": {"value": 0, "limit": 0}}
    assert set(res["metrics"]) == {"frame_ms", "setup_s"}
