"""stage_ms.sor: CUDA-event ms a frame in the two-pass SOR sweep and the
keep mask."""

SPANS = [
    "pointclouds_tpu_torch.pipelines.kitti:sweep_sor_two_pass",
    "pointclouds_tpu_torch.pipelines.kitti:sor_keep_mask_thr",
]


def read(rec):
    return rec.span_ms_per_frame(SPANS)
