"""The check that decides `correct`, at a size a CPU test can hold: the
reference agrees with the port's plain CPU run; the reference computed in
bfloat16 (the control) fails the comparison; and a whole run, the look for
a card skipped, comes out not correct when the timed path is broken
underneath: a step that returns its state unchanged, half of the points
left out, an answer altered where it is produced, keep decisions altered
on a frame the program certifies, normals left uncertified, a flag raised
without cause."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from _portbench_tiny import tiny_checkout, tiny_config  # noqa: E402
from portbench import harness  # noqa: E402

CASES = {"kitti-hdl64": "kitti-hdl64.stream",
         "aerial-3dep-ql2": "aerial-3dep-ql2.tiles"}
ENTRY = {"kitti-hdl64": "pointclouds_tpu_torch.pipelines.kitti",
         "aerial-3dep-ql2": "pointclouds_tpu_torch.pipelines.aerial"}


def frame_and_output(name: str, seed: int, ransac_seed: int):
    cfg = tiny_config(name)
    feed = harness.feed_of(cfg, {"ring": 1}, seed, "cpu")
    return cfg, feed.xyz[0], feed.run(ransac_seed)._asdict()


def over(numbers: dict, limits: dict) -> list:
    return [k for k, v in numbers.items() if not v <= limits[k]]


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_agrees_with_plain_run_and_control_fails(name):
    cfg, xyz, out = frame_and_output(name, 11, 5)
    ref = harness.load_reference(cfg["reference"])
    assert set(ref.judge(xyz, out, cfg, 5)) == set(cfg["limits"])
    assert over(ref.judge(xyz, out, cfg, 5), cfg["limits"]) == []
    # The reference in float64 in the program's place agrees with itself.
    same = ref.judge(xyz, ref.run(xyz, cfg, 5, torch.float64), cfg, 5)
    assert over(same, cfg["limits"]) == []
    control = ref.judge(xyz, ref.run(xyz, cfg, 5, torch.bfloat16), cfg, 5)
    assert {"voxel_mismatch", "centroid_gap_m"} <= set(
        over(control, cfg["limits"]))


def stale(orig):
    last = []

    def broken(*a, **k):
        out = orig(*a, **k)
        last.append(out)
        return last[-2] if len(last) > 1 else out  # the previous answer
    return broken


def half(orig):
    def broken(xyz, valid, *a, **k):
        valid = valid.clone()
        valid[::2] = False
        return orig(xyz, valid, *a, **k)
    return broken


def altered(orig):
    def broken(*a, **k):
        out = orig(*a, **k)
        labels = out.labels.clone()
        slots = out.obstacle_valid.nonzero().flatten()
        labels[slots] = int(labels[slots[0]])  # every obstacle one cluster
        return out._replace(labels=labels)
    return broken


def certified_flips(orig):
    def broken(*a, **k):
        out = orig(*a, **k)
        cleaned = out.cleaned_valid.clone()
        cleaned[cleaned.nonzero().flatten()[:40]] = False
        return out._replace(cleaned_valid=cleaned,
                            sor_certified=torch.tensor(True))
    return broken


def normals_uncertified(orig):
    def broken(*a, **k):
        out = orig(*a, **k)
        return out._replace(normals_ok=torch.zeros_like(out.normals_ok))
    return broken


def cluster_flagged(orig):
    def broken(*a, **k):
        out = orig(*a, **k)
        if hasattr(out, "grid_flags"):
            flags = out.grid_flags.clone()
            flags[2] = True
            return out._replace(grid_flags=flags)
        return out._replace(cluster_exact=torch.tensor(False))
    return broken


FAULTS = [(name, fault) for name in sorted(CASES)
          for fault in (stale, half, altered, cluster_flagged)] + [
    ("kitti-hdl64", certified_flips),
    ("aerial-3dep-ql2", normals_uncertified)]


def drive(tmp_path, name, fault=None, monkeypatch=None, cell=None):
    root = tiny_checkout(tmp_path)
    if fault is not None:
        mod = __import__(ENTRY[name], fromlist=["x"])
        fn = json.loads((root / "configs" / f"tiny-{name}.json").read_text())[
            "entry"].split(":")[1]
        monkeypatch.setattr(mod, fn, fault(getattr(mod, fn)))
    return harness.run(cell or CASES[name], 2**31 + 7, 0.5, False,
                       t_start=time.perf_counter(), device="cpu", root=root,
                       bench=root)


@pytest.mark.parametrize("name,cell", sorted(CASES.items()) + [
    ("kitti-hdl64", "kitti-hdl64.snow")])
def test_sound_run_is_correct(tmp_path, name, cell):
    res = drive(tmp_path, name, cell=cell)
    assert res["correct"] is True, res["compared"]
    assert list(res)[-1] == "compared"
    # On the CPU a metric read from the device's trace finds nothing.
    assert {m for m in res["metrics"]} == {
        m["name"] for m in harness.metrics_of(
            harness.manifest(tmp_path), cell, "end_to_end")
        if m["source"] != "device_trace"}


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, name, fault):
    res = drive(tmp_path, name, fault, monkeypatch)
    assert res["correct"] is False
    assert res["failed"] >= 1
