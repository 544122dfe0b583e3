"""A tiny copy of the benchmark for CPU tests: the real configurations cut
to a few thousand points, written with the real traffic mixes, feeds and
metric files into a checkout of its own, as a later change would add them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TINY = {
    "kitti-hdl64": dict(scene={"kind": "velodyne", "n_points": 8192},
                        kwargs=dict(ds_cap=8192, obstacle_cap=2048),
                        check_frames=1),
    # A 64 m tile cut from the QL2 scene: its own density, ~9,900 points.
    "aerial-3dep-ql2": dict(scene={"kind": "aerial", "scale": 2.5,
                                   "crop_m": 64},
                            kwargs=dict(ds_cap=10240, obstacle_cap=8192),
                            check_frames=1),
}


def tiny_config(name: str) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    t = TINY[name]
    cfg["name"] = f"tiny-{name}"
    cfg["scene"] = t["scene"]
    cfg["kwargs"].update(t["kwargs"])
    cfg["check_frames"] = t["check_frames"]
    return cfg


def tiny_checkout(tmp: Path) -> Path:
    """``tmp`` holding a BENCHMARK.json whose cells are the real ones on the
    tiny configurations, with a two-frame ring."""
    for sub in ("configs", "traffic", "metrics", "feeds"):
        (tmp / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "feeds"):
        for f in (BENCH / sub).glob("*.py"):
            shutil.copy(f, tmp / sub / f.name)
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs, cells = [], []
    for name in TINY:
        cfg = tiny_config(name)
        (tmp / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        configs.append(dict(name=cfg["name"], source="tiny",
                            file=f"configs/{cfg['name']}.json", reduced=[],
                            why="CPU test"))
    for w in man["workloads"]:
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        mix["ring"] = 2
        (tmp / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
        cells.append(dict(w, config=f"tiny-{w['config']}"))
    man["configs"], man["workloads"] = configs, cells
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp
