"""The port's segmented scan (plain version of the CUDA kernel) and the
fused voxel front end, bitwise against the JAX package: the Pallas kernel
in interpret mode and its XLA mirror."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.ops.filters import (
    voxel_downsample_sweep_fused as jax_voxel_fused,
)
from pointclouds_tpu.spatial.pallas_kernels import (
    segmented_scan_sums as jax_segscan,
    segmented_scan_sums_xla as jax_segscan_xla,
)
from pointclouds_tpu_torch.ops.filters import voxel_downsample_sweep_fused
from pointclouds_tpu_torch.spatial import kernels
from pointclouds_tpu_torch.spatial.kernels import segmented_scan_sums


def _segments(n, seed):
    rng = np.random.default_rng(seed)
    first = (rng.random(n) < 0.3).astype(np.float32)
    first[0] = 1.0
    x, y, z = (rng.normal(size=n).astype(np.float32) * 20 for _ in range(3))
    # -0.0 values: x + 0.0 turns them into +0.0, which the tree must keep.
    x[rng.random(n) < 0.05] = -0.0
    c = (rng.random(n) < 0.9).astype(np.float32)
    return first, x, y, z, c


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("n", [128, 640, 2 * 512 * 128 + 384])
def test_segscan_plain_bitwise_vs_pallas_and_mirror(n):
    args = _segments(n, n)
    kernels.reset_launch_counts()
    got = segmented_scan_sums(*(torch.from_numpy(a) for a in args))
    assert kernels.LAUNCHES["segmented_scan_sums"] == 0  # CPU: plain
    want_k = jax_segscan(*(jnp.asarray(a) for a in args), interpret=True)
    want_x = jax_segscan_xla(*(jnp.asarray(a) for a in args))
    for g, wk, wx in zip(got, want_k, want_x):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(wk))
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(wx))


def _cloud(seed, n, cap):
    rng = np.random.default_rng(seed)
    pts = np.vstack([
        (rng.random((n, 3)) * [30.0, 20.0, 2.0]).astype(np.float32),
        (rng.normal([5, 5, 1], 0.3, (n // 10, 3))).astype(np.float32),
    ])
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(pts)] = pts
    valid = np.zeros(cap, bool)
    valid[: len(pts)] = True
    xyz[3] = np.nan  # a non-finite row is skipped
    return xyz, valid


@pytest.mark.parametrize("ds_cap", [8192, 4096])
def test_voxel_downsample_sweep_fused_matches_jax(ds_cap):
    xyz, valid = _cloud(0, 6000, 8192)
    voxel = np.float32(0.15)
    want = jax_voxel_fused(jnp.asarray(xyz), jnp.asarray(valid), voxel,
                           factor=3, ds_cap=ds_cap)
    got = voxel_downsample_sweep_fused(torch.from_numpy(xyz),
                                       torch.from_numpy(valid), voxel,
                                       factor=3, ds_cap=ds_cap)
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        g = got[key].numpy()
        if w.dtype == np.float32:
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
    assert bool(got["ds_overflow"]) == (ds_cap == 4096)
