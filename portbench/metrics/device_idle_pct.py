"""device_idle_pct: the share of the profiled pass's wall time in which no
operation ran on the device, in %."""


def read(rec):
    p = rec.profile
    if not p or not p.get("busy_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
