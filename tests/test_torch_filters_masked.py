"""`voxel_downsample_masked` of the PyTorch port against the JAX package:
the same voxels in the same order with bitwise-equal centroids."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.ops.filters import (
    voxel_downsample_masked as jax_voxel_downsample_masked,
)
from pointclouds_tpu.pipelines.scenes import aerial_scene
from pointclouds_tpu_torch.core.cloud import make_cloud_arrays
from pointclouds_tpu_torch.ops.filters import voxel_downsample_masked
from pointclouds_tpu_torch.spatial import kernels


def _messy(seed, n):
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(n, 3)) * [20, 20, 3]).astype(np.float32)
    xyz[rng.random(n) < 0.02] = np.nan
    xyz[rng.random(n) < 0.01, 1] = np.inf
    xyz[: n // 10] = xyz[0]  # one crowded voxel
    return xyz


@pytest.mark.parametrize("case,voxel", [("aerial", 0.5), ("messy", 0.7),
                                        ("messy", 2.5)])
def test_voxel_downsample_masked_bitwise(case, voxel):
    data = (aerial_scene(seed=3, scale=0.05) if case == "aerial"
            else _messy(11, 3000))
    c = make_cloud_arrays(data, device="cpu")
    valid = c.valid.clone()
    valid[::17] = False
    jc, jv = jax_voxel_downsample_masked(jnp.asarray(c.xyz.numpy()),
                                         jnp.asarray(valid.numpy()),
                                         np.float32(voxel))
    kernels.reset_launch_counts()
    tc, tv = voxel_downsample_masked(c.xyz, valid, np.float32(voxel))
    assert kernels.LAUNCHES["segmented_scan_sums"] == 0  # CPU: plain
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy().view(np.uint32),
                                  np.asarray(jc).view(np.uint32))
    assert 0 < int(tv.sum()) < int(valid.sum())
    assert tc.dtype == torch.float32
