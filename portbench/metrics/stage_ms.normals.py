"""stage_ms.normals: CUDA-event ms a frame in the kNN moments sweep and
the normals from its moment rows."""

SPANS = [
    "pointclouds_tpu_torch.pipelines.aerial:sweep_knn_moments_rows",
    "pointclouds_tpu_torch.pipelines.aerial:normals_from_moment_rows",
]


def read(rec):
    return rec.span_ms_per_frame(SPANS)
