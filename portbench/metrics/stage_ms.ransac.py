"""stage_ms.ransac: CUDA-event ms a frame in the RANSAC plane fit."""

SPANS = [
    "pointclouds_tpu_torch.pipelines.kitti:ransac_plane_masked",
    "pointclouds_tpu_torch.pipelines.aerial:ransac_plane_masked",
]


def read(rec):
    return rec.span_ms_per_frame(SPANS)
