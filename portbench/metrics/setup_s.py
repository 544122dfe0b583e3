"""setup_s: from the start of the process to the start of the window:
imports, the card's context, the kernel library (built on a checkout's
first run), the ring of frames and two warm passes over it, and the
profiler's start-up where an end-to-end metric reads the device's trace."""


def read(rec):
    return rec.setup_s
