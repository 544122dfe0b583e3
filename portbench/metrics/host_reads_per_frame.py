"""host_reads_per_frame: statements a frame that made the host wait on the
card (the program's ``host_reads`` counter: each sits in a
`profiling.host_read`), mean over the window's frames."""

from portbench import programtrace

programtrace.start()
COUNTS = programtrace.COUNTS


def read(rec):
    return programtrace.per_frame(lambda f: f.count("host_reads"))
