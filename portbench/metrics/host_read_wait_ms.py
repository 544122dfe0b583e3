"""host_read_wait_ms: host ms a frame spent in the program's
``host_read.<site>`` spans, waiting on the card, mean over the window's
frames."""

from portbench import programtrace

programtrace.start()
COUNTS = programtrace.COUNTS


def _wait(frame):
    return sum(frame.host_ms(n) for n in frame.names()
               if n.startswith("host_read."))


def read(rec):
    return programtrace.per_frame(_wait)
