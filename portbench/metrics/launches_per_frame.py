"""launches_per_frame: device kernels a frame launched in the profiled
pass (torch.profiler; copies and fills not counted)."""


def read(rec):
    p = rec.profile
    if not p or not p.get("launches"):
        return None
    return p["launches"] / p["frames"]
