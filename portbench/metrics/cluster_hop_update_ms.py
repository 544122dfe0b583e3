"""cluster_hop_update_ms: host ms a frame in the program's
``cluster.hop.update`` spans (the torch work of each hop of clustering's
hop loop after kernel 16: the hook's scatter-min, the two pointer jumps,
the next frontier), mean over the window's frames. None where no frame
recorded such a span: a program without it, or a cell whose clustering
stays below the residency gate."""

from portbench import programtrace

programtrace.start()
COUNTS = programtrace.COUNTS
SPAN = "cluster.hop.update"


def read(rec):
    if not any(SPAN in f.names() for f in programtrace.WINDOW):
        return None
    return programtrace.per_frame(lambda f: f.host_ms(SPAN))
