"""sor_flagged_rows: rows a frame that SOR pass 1 left uncertified, before
the rescue takes the first `sor_fix_cap` of them: the flagged mask its
front end (`sweep._rescue_structure`) receives."""

KEY = "pointclouds_tpu_torch.spatial.sweep:_rescue_structure"
COUNTS = {KEY: lambda args, kwargs, out: args[2].sum()}


def read(rec):
    return rec.count_per_frame(KEY)
