"""frame_p95_ms: the 95th percentile of every frame's latency in a traced
run's window. In every cell the card idles for more than half the window,
so the host paces the tail: a per-layer view of `frame_ms`."""

import numpy as np


def read(rec):
    return 1e3 * float(np.percentile(rec.frame_s, 95)) if rec.frames else None
