"""stage_ms.compact: CUDA-event ms a frame in the program's ``compact``
span (KITTI's canonical mini-sort before RANSAC, and in both pipelines the
ground removal and obstacle compaction), mean over the window's frames."""

from portbench import programtrace

programtrace.start()
COUNTS = programtrace.COUNTS


def read(rec):
    return programtrace.per_frame(lambda f: f.span_ms("compact"))
