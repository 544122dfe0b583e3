"""pointclouds_tpu_torch: the PyTorch + CUDA port of pointclouds_tpu.

A second package beside the JAX one, for NVIDIA Hopper (H100). Plain
functions on tensors; the device is the device of the input tensors. The
Pallas kernels on the ported path are hand-written CUDA C++ kernels
(`spatial/csrc/`), built with nvcc at first use. The package imports
torch, numpy and the standard library only.

Ported: the KITTI obstacle and aerial pipelines (sweep backend) and the
whole public API of `pointclouds_tpu/api.py` (`api.__all__`): filters,
normals, ICP, transform, clustering, RANSAC, kNN and spatial queries, and
the PCD/PLY/LAS readers and writers. Clouds are made on the card unless the
caller asks for the CPU (``device="cpu"``).
"""

from .api import (
    IcpResult,
    PlaneResult,
    PointCloud,
    apply_transform,
    estimate_normals,
    estimate_normals_with_viewpoint,
    euclidean_cluster,
    icp_point_to_plane,
    icp_point_to_point,
    knn,
    knn_indices,
    passthrough_filter,
    radius_outlier_removal,
    radius_search,
    radius_search_unsorted,
    ransac_plane,
    ransac_plane_seeded,
    read_las,
    read_pcd,
    read_ply,
    statistical_outlier_removal,
    voxel_downsample,
    write_pcd,
    write_pcd_binary,
    write_ply,
    write_ply_binary,
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
    "IcpResult",
    "KittiPipelineOutput",
    "PlaneResult",
    "PointCloud",
    "aerial_pipeline",
    "apply_transform",
    "bucket_size",
    "estimate_normals",
    "estimate_normals_with_viewpoint",
    "euclidean_cluster",
    "extract_clusters",
    "icp_point_to_plane",
    "icp_point_to_point",
    "kitti_obstacle_pipeline",
    "knn",
    "knn_indices",
    "make_cloud_arrays",
    "passthrough_filter",
    "radius_outlier_removal",
    "radius_search",
    "radius_search_unsorted",
    "ransac_plane",
    "ransac_plane_seeded",
    "read_las",
    "read_pcd",
    "read_ply",
    "statistical_outlier_removal",
    "voxel_downsample",
    "write_pcd",
    "write_pcd_binary",
    "write_ply",
    "write_ply_binary",
]
