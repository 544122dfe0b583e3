"""stage_ms.cluster: CUDA-event ms a frame in the sweep clustering."""

SPANS = [
    "pointclouds_tpu_torch.pipelines.kitti:sweep_cluster_labels",
    "pointclouds_tpu_torch.pipelines.aerial:sweep_cluster_labels",
]


def read(rec):
    return rec.span_ms_per_frame(SPANS)
