#!/usr/bin/env python3
"""Whether two checkouts' pipelines give the same bits, frame by frame:

    cd CHECKOUT && python3 /path/to/benches/same_outputs.py dump OUT.npz
    python3 benches/same_outputs.py compare A.npz B.npz

``dump``, from the root of a checkout on a machine with an NVIDIA card,
runs each benchmark cell's feed (the checkout's own `portbench/`, the
seed below) over two turns of its ring, frames 0 .. 2*ring-1 with RANSAC
seed = frame, and saves every output field of every frame. ``compare``
prints how many arrays were compared and names those that differ in
dtype, shape or a single bit; it exits 1 if any does.
"""

import os
import sys

import numpy as np

CELLS = {"kitti-hdl64.stream": 2300000501, "kitti-hdl64.snow": 2300000502,
         "aerial-3dep-ql2.tiles": 2300000503,
         "aerial-3dep-ql1.tiles": 2300000504}


def dump(path):
    sys.path.insert(0, os.getcwd())
    from pathlib import Path

    import torch

    from portbench import harness

    root = Path(os.getcwd())
    man = harness.load_json(root / "BENCHMARK.json")
    res = {}
    for name, seed in CELLS.items():
        cell, centry = harness.cell_of(man, name)
        cfg = harness.load_json(root / centry["file"])
        mix = harness.load_json(root / "portbench" / "traffic"
                                / f"{cell['traffic']}.json")
        feed = harness.feed_of(cfg, mix, seed, torch.device("cuda"))
        for i in range(2 * feed.ring):
            out = feed.run(i)
            for f in out._fields:
                res[f"{name}/{i}/{f}"] = getattr(out, f).cpu().numpy()
        print(name, "frames", 2 * feed.ring, flush=True)
    np.savez(path, **res)


def compare(a, b) -> int:
    a, b = np.load(a), np.load(b)
    if sorted(a.files) != sorted(b.files):
        print("the two dumps hold different arrays")
        return 1
    bad = [k for k in a.files
           if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
           or a[k].tobytes() != b[k].tobytes()]
    print(f"{len(a.files)} arrays compared, {len(bad)} differ bitwise")
    for k in bad[:20]:
        print("  differs:", k)
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1] == "dump":
        dump(sys.argv[2])
        sys.exit(0)
    sys.exit(compare(sys.argv[2], sys.argv[3]))
