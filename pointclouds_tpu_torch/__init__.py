"""pointclouds_tpu_torch: the PyTorch + CUDA port of pointclouds_tpu.

A second package beside the JAX one, for NVIDIA Hopper (H100). Plain
functions on tensors; the device is the device of the input tensors. The
Pallas kernels on the ported path are hand-written CUDA C++ kernels
(`spatial/csrc/`), built with nvcc at first use. The package imports
torch, numpy and the standard library only.

Ported so far: the KITTI obstacle and aerial pipelines (sweep backend),
and from the public API `PointCloud`, `PlaneResult` and the filter,
normals, transform and plane functions. Clouds are made on the card unless
the caller asks for the CPU (``device="cpu"``).
"""

from .api import (
    PlaneResult,
    PointCloud,
    apply_transform,
    estimate_normals,
    estimate_normals_with_viewpoint,
    passthrough_filter,
    radius_outlier_removal,
    ransac_plane,
    ransac_plane_seeded,
    statistical_outlier_removal,
    voxel_downsample,
)
from .core.cloud import bucket_size, make_cloud_arrays
from .pipelines.aerial import AerialPipelineOutput, aerial_pipeline
from .pipelines.kitti import (
    KittiPipelineOutput,
    extract_clusters,
    kitti_obstacle_pipeline,
)

__all__ = [
    "AerialPipelineOutput",
    "KittiPipelineOutput",
    "PlaneResult",
    "PointCloud",
    "aerial_pipeline",
    "apply_transform",
    "bucket_size",
    "estimate_normals",
    "estimate_normals_with_viewpoint",
    "extract_clusters",
    "kitti_obstacle_pipeline",
    "make_cloud_arrays",
    "passthrough_filter",
    "radius_outlier_removal",
    "ransac_plane",
    "ransac_plane_seeded",
    "statistical_outlier_removal",
    "voxel_downsample",
]
