"""kernels_roofline: the hand-written kernels' least time at the card's
peaks (`yardstick.work`, over a pass of the ring with their arguments
read) over their device time in a profiled pass of the same frames, in %.
Stated against the published H100 SXM peaks; the card's power limit is in
the result's device."""


def read(rec):
    p = rec.profile
    if not p or not p.get("kernel_device_s") or not p.get("kernel_bound_s"):
        return None
    return 100.0 * p["kernel_bound_s"] / p["kernel_device_s"]
