"""The QL1 aerial configuration (`configs/aerial-3dep-ql1.json`) at a size a
CPU test can hold: a 64 m tile cut from its scene, at its own density,
through the `cloud` feed with clustering forced into the hop loop (the
residency gate lowered to 0 bytes, as the whole tile's obstacles exceed
it). The reference judges every number within the configuration's limits,
the cluster flag included; the bfloat16 control fails them; a traced CPU
run of the cell reports the hop loop's own metric, which finds nothing to
read in a program without its span."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from portbench import harness, programtrace  # noqa: E402
from pointclouds_tpu_torch.spatial import sweep  # noqa: E402
from pointclouds_tpu_torch.utils import profiling  # noqa: E402

NAME = "aerial-3dep-ql1"
CELL = "aerial-3dep-ql1.tiles"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


def crop_config() -> dict:
    """The configuration on a 64 m tile of its scene (~33,000 points,
    ~15,600 voxels, 100-200 obstacles), caps cut to fit. The crop is the
    scene's corner at the origin; a smaller one lies within the plane's
    band and leaves no obstacle to cluster."""
    cfg = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())
    cfg["name"] = f"crop-{NAME}"
    cfg["scene"] = dict(cfg["scene"], crop_m=64)
    cfg["kwargs"].update(ds_cap=20480, obstacle_cap=2048)
    cfg["check_frames"] = 1
    return cfg


@pytest.fixture
def hop_loop(monkeypatch):
    """Clustering above the residency gate; the hop loop's calls."""
    monkeypatch.setattr(sweep, "CLUSTER_RESIDENT_BYTES", 0)
    calls = []
    real = sweep._hop_loop_labels

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append(out[1])
        return out

    monkeypatch.setattr(sweep, "_hop_loop_labels", spy)
    return calls


def over(numbers: dict, limits: dict) -> list:
    return [k for k, v in numbers.items() if not v <= limits[k]]


def test_config_is_the_ql2_one_at_ql1_density():
    cfg = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())
    ql2 = json.loads((BENCH / "configs" / "aerial-3dep-ql2.json").read_text())
    assert cfg["scene"] == dict(ql2["scene"], scale=10.0)
    assert cfg["args"] == ql2["args"] and cfg["reference"] == "aerial"
    caps = {"ds_cap", "obstacle_cap"}
    assert {k: v for k, v in cfg["kwargs"].items() if k not in caps} == {
        k: v for k, v in ql2["kwargs"].items() if k not in caps}
    assert cfg["kwargs"]["ds_cap"] == cfg["kwargs"]["obstacle_cap"] \
        == cfg["assumed"]["ds_cap"] == 9 * 2**17
    # The obstacle cap's cluster structure is above the residency gate.
    assert cfg["kwargs"]["obstacle_cap"] * 8 * 4 > \
        sweep.CLUSTER_RESIDENT_BYTES
    assert set(cfg["limits"]) == set(ql2["limits"])
    assert cfg["check_frames"] == 2
    assert [c for c in MAN["configs"] if c["name"] == NAME][0][
        "reduced"] == cfg["reduced"] == ["scene"]


def test_full_obstacle_cap_takes_the_hop_loop(monkeypatch):
    """The gate counts the rows of the obstacle buffer, padding included:
    a tile's ~815,000 obstacles alone fill fewer rows than the gate's, the
    configuration's full cap more, so the cell's clustering runs the hop
    loop. Fails if the gate comes to count only the valid rows."""
    cfg = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())
    cap = cfg["kwargs"]["obstacle_cap"]
    gate_rows = sweep.CLUSTER_RESIDENT_BYTES // (8 * 128 * 4)
    n_obs = 815_000
    assert -(-n_obs // 128) <= gate_rows < cap // 128
    seen = []

    def stub(planar, starts_skip, r2, nb, max_iters):
        seen.append(planar.shape[0])
        return torch.arange(planar.shape[0] * 128, dtype=torch.int32), 1

    monkeypatch.setattr(sweep, "_hop_loop_labels", stub)
    gen = torch.Generator().manual_seed(5)
    xyz = torch.rand((cap, 3), generator=gen) * torch.tensor([500., 500., 20.])
    valid = torch.arange(cap) < n_obs
    sweep.sweep_cluster_labels(xyz, valid, 2.0,
                               wr=cfg["kwargs"].get("cluster_wr", 12),
                               rep_labels=False, row_cap=None,
                               sweeps=cfg["kwargs"]["cluster_sweeps"])
    assert seen == [cap // 128]


def test_reference_judges_the_hop_loop_run_correct(hop_loop):
    cfg = crop_config()
    feed = harness.feed_of(cfg, {"ring": 1}, 2**31 + 17, "cpu")
    ref = harness.load_reference(cfg["reference"])
    out = feed.run(3)
    assert len(hop_loop) == 1 and 1 <= hop_loop[0] < 64
    nums = feed.judge(ref, 3, out)
    assert set(nums) == set(cfg["limits"])
    assert over(nums, cfg["limits"]) == [], nums
    assert nums["flag_mismatch"] == 0 and nums["cluster_gap"] == 0
    assert int(out.obstacle_valid.sum()) > 50
    # The reference in float64 agrees with itself; in bfloat16 it fails.
    same = feed.judge(ref, 3, feed.control(ref, 3, torch.float64))
    assert over(same, cfg["limits"]) == []
    control = feed.judge(ref, 3, feed.control(ref, 3, torch.bfloat16))
    assert {"voxel_mismatch", "centroid_gap_m"} <= set(
        over(control, cfg["limits"]))


def crop_checkout(tmp: Path) -> Path:
    """``tmp`` holding a BENCHMARK.json whose one cell is the QL1 cell on
    the crop, with a one-tile ring, and its per-layer metrics that read no
    CUDA events (`harness.span_wrapper` needs a card)."""
    for sub in ("configs", "traffic", "metrics", "feeds"):
        (tmp / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "feeds"):
        for f in (BENCH / sub).glob("*.py"):
            shutil.copy(f, tmp / sub / f.name)
    cfg = crop_config()
    (tmp / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (tmp / "traffic" / "tiles.json").write_text(json.dumps({"ring": 1}))
    man = dict(MAN)
    man["configs"] = [dict(name=cfg["name"], source="crop",
                           file=f"configs/{cfg['name']}.json", reduced=[],
                           why="CPU test")]
    man["workloads"] = [dict(w, config=cfg["name"])
                        for w in MAN["workloads"] if w["name"] == CELL]
    man["per_layer"] = [m for m in MAN["per_layer"] if not getattr(
        harness.load_metric(m["name"]), "SPANS", None)]
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp


@pytest.fixture
def tracing_restored():
    yield
    profiling.set_tracing(False)
    programtrace.WINDOW.clear()


def test_traced_run_reads_the_hop_update(tmp_path, hop_loop,
                                         tracing_restored):
    root = crop_checkout(tmp_path)
    res = harness.run(CELL, 2**31 + 19, 0.5, True,
                      t_start=time.perf_counter(), device="cpu", root=root,
                      bench=root)
    assert res["correct"] is True, res["compared"]
    metrics = res["metrics"]
    assert metrics["cluster_hop_update_ms"]["value"] > 0
    assert metrics["cluster_rounds"]["value"] >= 1
    assert metrics["host_reads_per_frame"]["value"] >= metrics[
        "cluster_rounds"]["value"]
    assert "host_read_wait_ms" in metrics


def test_hop_update_reads_nothing_without_its_span(tracing_restored):
    """A window whose frames hold no ``cluster.hop.update`` span (the
    parent of the change that added it, or a cell below the gate) gives the
    metric nothing to read."""
    reader = harness.load_metric("cluster_hop_update_ms")
    profiling.set_tracing(True)
    with profiling.frame("aerial"):
        with profiling.span("cluster.rounds"):
            pass
    programtrace.WINDOW.append(profiling.last_frame())
    assert reader.read(harness.Record(frame_s=[0.1])) is None
    assert [m["workloads"] for m in MAN["per_layer"]
            if m["name"] == "cluster_hop_update_ms"] == [[CELL]]
