"""The PyTorch port's scenes, padding and import boundary against the JAX
package."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.core.cloud import bucket_size as jax_bucket_size
from pointclouds_tpu.core.cloud import make_cloud_arrays as jax_make_cloud
from pointclouds_tpu.pipelines import scenes as jax_scenes
from pointclouds_tpu_torch.core.cloud import bucket_size, make_cloud_arrays
from pointclouds_tpu_torch.pipelines import scenes


@pytest.mark.parametrize("seed", [0, 1, 42, 12345])
def test_kitti_scene_equal(seed):
    np.testing.assert_array_equal(scenes.kitti_scene(seed, 0.2),
                                  jax_scenes.kitti_scene(seed, 0.2))


@pytest.mark.parametrize("seed,n", [(0, 122_000), (3, 20_000), (7, 5_000)])
def test_velodyne_scene_equal(seed, n):
    a = scenes.velodyne_scene(seed, n)
    np.testing.assert_array_equal(a, jax_scenes.velodyne_scene(seed, n))
    assert a.shape == (n, 3) and a.dtype == np.float32


@pytest.mark.parametrize("n", [0, 1, 8, 9, 1000, 122_000, 131_072])
def test_make_cloud_arrays_pads_like_jax(n):
    assert bucket_size(n) == jax_bucket_size(n)
    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    got = make_cloud_arrays(pts)
    want = jax_make_cloud(pts)
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.xyz.dtype == torch.float32 and got.valid.dtype == torch.bool


def test_port_imports_no_jax():
    code = ("import sys, pointclouds_tpu_torch; "
            "import pointclouds_tpu_torch.pipelines.kitti; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'pointclouds_tpu' not in sys.modules")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr
