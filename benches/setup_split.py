#!/usr/bin/env python3
"""Where a benchmark cell's set-up time goes, phase by phase:

    python3 benches/setup_split.py --workload kitti-hdl64.stream --seed N

from the root of a checkout on a machine with an NVIDIA card. Runs the
cell once through `portbench.harness.run`, untraced as the benchmark's
end-to-end runs are, with a short window (``--seconds``, default 3), and
times its set-up: the imports before the run, the import of the port,
the ring's frames made on the host (`generator.ring`), the rest of the
feed (the frames to the card), each warm pass over the ring (its first
frame apart; the kernel library's build or load falls in the first
frame and is given on its own too), and the profiler's starts and stops
in the window trace's warm pass. Prints one JSON line with these seconds,
the harness's own ``setup_s`` and what is left of it (``other_s``).
Nothing of the harness or the port changes: their functions are wrapped
for this process only.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The checkout's root, not this directory, leads the import path.
sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench import generator, harness  # noqa: E402


def timed(owner, attr, into):
    """Replace ``owner.attr`` by a wrapper that appends each call's (start,
    end) to ``into``."""
    orig = getattr(owner, attr)

    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return orig(*a, **k)
        finally:
            into.append((t0, time.perf_counter()))

    setattr(owner, attr, wrapper)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    a = ap.parse_args()
    imports_s = time.perf_counter() - T_START

    t0 = time.perf_counter()
    import torch  # noqa: F401

    from pointclouds_tpu_torch.spatial import _build
    port_import_s = time.perf_counter() - t0

    calls = {k: [] for k in ("ring", "feed", "library", "prof_start",
                             "prof_stop", "frames")}
    timed(generator, "ring", calls["ring"])
    timed(_build, "library", calls["library"])
    timed(harness.WindowTrace, "before_frame", calls["prof_start"])
    timed(harness.WindowTrace, "stop", calls["prof_stop"])
    feed_of = harness.feed_of
    ring = []

    def traced_feed_of(*args, **kwargs):
        t = time.perf_counter()
        feed = feed_of(*args, **kwargs)
        calls["feed"].append((t, time.perf_counter()))
        ring.append(feed.ring)
        run, read = feed.run, feed.read
        started = []

        def run_timed(i):
            started.append(time.perf_counter())
            return run(i)

        def read_timed(out):
            r = read(out)
            calls["frames"].append((started.pop(), time.perf_counter()))
            return r

        feed.run, feed.read = run_timed, read_timed
        return feed

    harness.feed_of = traced_feed_of
    result = harness.run(a.workload, a.seed, a.seconds, False,
                         t_start=T_START)
    setup_s = result["metrics"]["setup_s"]["value"]
    end = T_START + setup_s

    def secs(name):
        return sum(e - s for s, e in calls[name] if e <= end)

    frames = [f for f in calls["frames"] if f[1] <= end]
    passes = [dict(first_ms=(fs[0][1] - fs[0][0]) * 1e3,
                   rest_ms=sum(e - s for s, e in fs[1:]) * 1e3)
              for fs in (frames[p:p + ring[0]]
                         for p in range(0, len(frames), ring[0]))]
    parts = dict(imports_s=imports_s, port_import_s=port_import_s,
                 ring_s=secs("ring"), feed_rest_s=secs("feed") - secs("ring"),
                 frames_s=secs("frames"), prof_start_s=secs("prof_start"),
                 prof_stop_s=secs("prof_stop"))
    print(json.dumps(dict(
        workload=a.workload, seed=a.seed, tree=str(Path.cwd()),
        setup_s=setup_s, **parts, other_s=setup_s - sum(parts.values()),
        library_s=next((e - s for s, e in calls["library"][:1]), None),
        ring=ring[0], passes=passes,
        correct=result.get("correct"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
