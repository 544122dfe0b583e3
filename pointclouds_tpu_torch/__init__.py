"""pointclouds_tpu_torch: the PyTorch + CUDA port of pointclouds_tpu.

A second package beside the JAX one, for NVIDIA Hopper (H100). Plain
functions on tensors; the device is the device of the input tensors. The
Pallas kernels on the ported path are hand-written CUDA C++ kernels
(`spatial/csrc/`), built with nvcc at first use. The package imports
torch, numpy and the standard library only.

Ported so far: the KITTI obstacle and aerial pipelines (sweep backend).
"""

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
    "aerial_pipeline",
    "bucket_size",
    "extract_clusters",
    "kitti_obstacle_pipeline",
    "make_cloud_arrays",
]
