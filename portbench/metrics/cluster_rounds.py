"""cluster_rounds: label-propagation rounds a frame's clustering ran (the
program's ``cluster.rounds``, summed over its calls of the round loops),
mean over the window's frames."""

from portbench import programtrace

programtrace.start()
COUNTS = programtrace.COUNTS


def read(rec):
    return programtrace.per_frame(lambda f: f.count("cluster.rounds"))
