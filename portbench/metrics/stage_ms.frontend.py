"""stage_ms.frontend: CUDA-event ms a frame in the fused voxel->sweep front
end and the sweep structure built from its rows."""

SPANS = [
    "pointclouds_tpu_torch.pipelines.kitti:voxel_downsample_sweep_fused",
    "pointclouds_tpu_torch.pipelines.kitti:structure_from_sorted",
    "pointclouds_tpu_torch.pipelines.aerial:voxel_downsample_sweep_fused",
    "pointclouds_tpu_torch.pipelines.aerial:structure_from_sorted",
]


def read(rec):
    return rec.span_ms_per_frame(SPANS)
