"""The two-sort voxel front end of the PyTorch port against the JAX package
on the CPU: `filters.voxel_downsample_sweep_frontend` (sort 1, the
segmented scan, the compaction) and `filters.sweep_sort_compacted` (sort 3,
into sweep order).

Tolerance: bitwise. The front end's dict equals JAX's key by key; its
centroids equal the port's `voxel_downsample_masked`; front end -> slice to
ds_cap -> `sweep_sort_compacted` gives the rows of the port's
`voxel_downsample_sweep_fused` where ds_cap does not overflow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.ops import filters as jfilters
from pointclouds_tpu.pipelines.scenes import aerial_scene, velodyne_scene
from pointclouds_tpu_torch.core.cloud import make_cloud_arrays
from pointclouds_tpu_torch.ops import filters as tfilters
from pointclouds_tpu_torch.spatial import kernels


def _messy(seed, n):
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(n, 3)) * [20, 20, 3]).astype(np.float32)
    xyz[rng.random(n) < 0.02] = np.nan
    xyz[rng.random(n) < 0.01, 1] = np.inf
    xyz[: n // 10] = xyz[0]  # one crowded voxel
    return xyz


CASES = {
    "velodyne": (lambda: velodyne_scene(seed=1, n_points=4000), 0.15, 3),
    "aerial": (lambda: aerial_scene(seed=3, scale=0.02), 0.5, 6),
    "messy": (lambda: _messy(11, 3000), 0.7, 3),
    "messy_coarse": (lambda: _messy(12, 3000), 2.5, 2),
}


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("case", sorted(CASES))
def test_voxel_frontend_matches_jax(case):
    make, voxel, factor = CASES[case]
    c = make_cloud_arrays(make(), device="cpu")
    valid = c.valid.clone()
    valid[::17] = False
    voxel = np.float32(voxel)
    want = jfilters.voxel_downsample_sweep_frontend(
        jnp.asarray(c.xyz.numpy()), jnp.asarray(valid.numpy()), voxel,
        factor=factor, use_kernel=False)
    kernels.reset_launch_counts()
    got = tfilters.voxel_downsample_sweep_frontend(c.xyz, valid, voxel,
                                                   factor=factor)
    assert kernels.LAUNCHES["segmented_scan_sums"] == 0  # CPU: plain
    assert sorted(got) == sorted(want)
    for key in want:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=key)
    assert not bool(got["table_overflow"])

    # The centroids of `voxel_downsample_masked`, in its order.
    mc, mv = tfilters.voxel_downsample_masked(c.xyz, valid, voxel)
    np.testing.assert_array_equal(got["out_valid"].numpy(), mv.numpy())
    np.testing.assert_array_equal(_bits(got["centroids_canon"].numpy()),
                                  _bits(mc.numpy()))

    # Sort 3 on the ds_cap slice: the fused front end's rows.
    nvox = int(got["out_valid"].sum())
    ds_cap = -(-(nvox + 5) // 128) * 128
    sl = [got[k][:ds_cap] for k in ("cxm", "cym", "czm", "canon",
                                    "out_valid")]
    rows = tfilters.sweep_sort_compacted(*sl, got["ext_v"], got["extent"],
                                         factor=factor)
    jrows = jfilters.sweep_sort_compacted(
        *(jnp.asarray(want[k][:ds_cap]) for k in ("cxm", "cym", "czm",
                                                   "canon", "out_valid")),
        want["ext_v"], want["extent"], factor=factor)
    for g, w in zip(rows, jrows):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    fused = tfilters.voxel_downsample_sweep_fused(
        c.xyz, valid, voxel, factor=factor, ds_cap=ds_cap)
    assert not bool(fused["ds_overflow"])
    for g, key in zip(rows, ("centroids", "out_valid", "slin", "canon")):
        np.testing.assert_array_equal(_bits(g.numpy()),
                                      _bits(fused[key].numpy()), err_msg=key)
    np.testing.assert_array_equal(got["hi_cells"].numpy(),
                                  fused["hi_cells"].numpy())
