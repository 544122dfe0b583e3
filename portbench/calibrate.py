#!/usr/bin/env python3
"""Readings the check's limits are set from, on the card at a cell's own
size:

    python3 portbench/calibrate.py --workload <name> [--seeds <a>-<b>] \\
        [--control-seeds <c>-<d>] [--plant <field>=<json>] [--out <file>]

For each seed of ``--seeds`` it makes the frames a run with that seed
would check (the frames sampled from the seed, their ring slots, their
RANSAC seeds), runs the program on each and judges its output against the
reference: the largest reading of each number is its lower reading. For
each seed of ``--control-seeds`` it puts the reference, computed in
bfloat16, in the program's place on the same frames and judges that: the
smallest reading is its upper reading. ``--plant field=value`` sets an
output field everywhere (a flag raised or lowered) before the judge reads
it. Benchmark runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench import harness  # noqa: E402

# Frames a window of a run is taken to complete when the sample is drawn.
EXPECT = 400


def sample_frames(seed: int, expect: int, k: int) -> set[int]:
    """``k`` frame indices drawn from the seed among the first ``expect``
    (at least ``k``): the frames a calibration judges."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 2])
    return set(rng.choice(max(expect, k), size=k, replace=False).tolist())


def seeds(text: str) -> list[int]:
    a, _, b = text.partition("-")
    return list(range(int(a), int(b or a) + 1))


def planted(out, fields: dict):
    """``out`` with each of ``fields`` set to its value everywhere: a flag
    raised or lowered where it is produced."""
    import torch

    out = out._asdict() if hasattr(out, "_asdict") else dict(out)
    for name, value in fields.items():
        out[name] = torch.full_like(out[name], value)
    return out


def readings(workload: str, seed_list, control: bool, device="cuda",
             root=harness.ROOT, bench=harness.BENCH, expect=EXPECT,
             kwargs=None, fields=None):
    """[(seed, frame index, numbers, seconds to judge)] for the program's
    outputs, or the bfloat16 control's with ``control``; ``fields`` plants
    values in either's output."""
    import torch

    man = harness.manifest(root)
    cell, centry = harness.cell_of(man, workload)
    cfg = harness.load_json(root / centry["file"])
    cfg["kwargs"].update(kwargs or {})
    mix = harness.load_json(bench / "traffic" / f"{cell['traffic']}.json")
    ref = harness.load_reference(cfg["reference"])
    rows = []
    for seed in seed_list:
        feed = harness.feed_of(cfg, mix, seed, device, bench)
        for i in sorted(sample_frames(
                seed, expect, int(cfg.get("check_frames", 1)))):
            out = (feed.control(ref, i, torch.bfloat16) if control
                   else feed.run(i))
            if fields:
                out = planted(out, fields)
            t0 = time.perf_counter()
            nums = feed.judge(ref, i, out)
            rows.append((seed, i, nums, time.perf_counter() - t0))
            print(json.dumps({"seed": seed, "frame": i, "control": control,
                              "numbers": nums,
                              "judge_s": rows[-1][3]}), flush=True)
        del feed
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--kwarg", action="append", default=[],
                    help="name=value: a pipeline keyword set otherwise than "
                    "the configuration (a witness run)")
    ap.add_argument("--plant", action="append", default=[],
                    help="field=value: an output field set to the value "
                    "everywhere, in the program's and the control's output "
                    "(a flag raised or lowered)")
    a = ap.parse_args()
    kw = {k: json.loads(v) for k, v in (x.split("=", 1) for x in a.kwarg)}
    fields = {k: json.loads(v)
              for k, v in (x.split("=", 1) for x in a.plant)}
    prog = (readings(a.workload, seeds(a.seeds), False, kwargs=kw,
                     fields=fields) if a.seeds else [])
    ctl = (readings(a.workload, seeds(a.control_seeds), True, kwargs=kw,
                    fields=fields) if a.control_seeds else [])
    summary = {"workload": a.workload}
    for label, rows, pick in (("lower", prog, max), ("upper", ctl, min)):
        if rows:
            summary[label] = {k: pick(r[2][k] for r in rows)
                              for k in rows[0][2]}
    summary["judge_s_max"] = max((r[3] for r in prog + ctl), default=0.0)
    print(json.dumps(summary), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(
            {"summary": summary,
             "program": [r[:3] for r in prog],
             "control": [r[:3] for r in ctl]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
