"""Euclidean clustering of the PyTorch port against the JAX package: the
plain version of the `cluster_multisweep` kernel against the Pallas kernel
in interpret mode, and `sweep_cluster_labels` (row-list path) against the
JAX one, on the blob scenes of tests/test_sweep_cluster.py."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.spatial import pallas_kernels as jpk
from pointclouds_tpu.spatial import sweep as jsweep
from pointclouds_tpu_torch.spatial import kernels, sweep
from pointclouds_tpu_torch.utils.interop import to_torch


def _blobs():
    rng = np.random.default_rng(7)
    pts = np.vstack([
        rng.normal([0, 0, 0], 0.3, (300, 3)),
        rng.normal([5, 5, 0], 0.4, (400, 3)),
        rng.normal([9, 1, 1], 0.2, (150, 3)),
        rng.random((150, 3)) * 12,
    ]).astype(np.float32)
    xyz = np.zeros((1024, 3), np.float32)
    xyz[: len(pts)] = pts
    valid = np.zeros(1024, bool)
    valid[: len(pts)] = True
    xyz[50] = np.inf
    valid[60] = False
    return xyz, valid, 0.5


def _chain():
    n = 400
    t = np.linspace(0, 30, n)
    xyz = np.zeros((512, 3), np.float32)
    xyz[:n] = np.column_stack([t, np.sin(t), np.zeros(n)])
    valid = np.zeros(512, bool)
    valid[:n] = True
    return xyz, valid, 0.2


def _boundary():
    xyz = np.zeros((256, 3), np.float32)
    xyz[:3] = [[0, 0, 0], [1.0, 0, 0], [2.5, 0, 0]]
    valid = np.zeros(256, bool)
    valid[:3] = True
    return xyz, valid, 1.0


def _cars():
    """Two dense car-sized boxes and a pedestrian at KITTI voxel density."""
    rng = np.random.default_rng(3)
    pts = np.vstack([
        rng.uniform([6, 2, 0.8], [10, 3.8, 2.3], (1500, 3)),
        rng.uniform([-7, -9, 0.8], [-3, -7.2, 2.3], (1500, 3)),
        rng.uniform([2.75, -2.25, 0.9], [3.25, -1.75, 2.7], (150, 3)),
        rng.uniform([-20, -20, -1], [20, 20, 5], (200, 3)),
    ]).astype(np.float32)
    xyz = np.zeros((4096, 3), np.float32)
    xyz[: len(pts)] = pts
    valid = np.zeros(4096, bool)
    valid[: len(pts)] = True
    return xyz, valid, 0.8


SCENES = {"blobs": _blobs, "chain": _chain, "boundary": _boundary,
          "cars": _cars}


def _groups(labels, ok):
    g = collections.defaultdict(list)
    for i in np.nonzero(ok)[0]:
        g[labels[i]].append(i)
    return sorted(tuple(v) for v in g.values())


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_sweep_cluster_labels_matches_jax(scene):
    xyz, valid, r = SCENES[scene]()
    want, exact = jsweep.sweep_cluster_labels(
        jnp.asarray(xyz), jnp.asarray(valid), np.float32(r), wr=12,
        row_cap=32, use_kernel=True, interpret=True)
    assert bool(exact)
    kernels.reset_launch_counts()
    got, t_exact = sweep.sweep_cluster_labels(
        torch.from_numpy(xyz), torch.from_numpy(valid), np.float32(r), wr=12,
        row_cap=32)
    assert kernels.LAUNCHES["cluster_multisweep"] == 0
    assert bool(t_exact)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ok = valid & np.isfinite(xyz).all(axis=1)
    assert len(_groups(got.numpy(), ok)) >= 1


@pytest.mark.parametrize("scene", ["blobs", "cars"])
def test_cluster_multisweep_plain_vs_pallas(scene):
    xyz, valid, r = SCENES[scene]()
    r32 = np.float32(r)
    hi = np.abs(np.where((valid & np.isfinite(xyz).all(1))[:, None], xyz,
                         0)).max()
    cell = jsweep.cluster_cell_size(jnp.float32(r32), jnp.float32(hi))
    s = jsweep._sorted_structure(jnp.asarray(xyz), jnp.asarray(valid), cell,
                                 12, jsweep.SWEEP_TABLE_SIZE)
    rowlist, _ = jsweep._window_row_lists(s["starts_skip"], 32, s["nrows"])
    lab, ch = jpk.cluster_multisweep(s["planar"], rowlist, r32 * r32, cap=32,
                                     sweeps=12, interpret=True)
    assert float(np.asarray(ch).sum()) == 0.0  # the Pallas run converged
    got, changed, rounds = kernels.cluster_multisweep(
        to_torch(s["planar"]), to_torch(rowlist), float(r32 * r32), cap=32)
    assert not changed.any() and rounds <= 64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(lab).astype(np.int32))


def test_cluster_round_cap_reports_not_exact():
    xyz, valid, r = _chain()
    _, exact = sweep.sweep_cluster_labels(
        torch.from_numpy(xyz), torch.from_numpy(valid), np.float32(r), wr=12,
        row_cap=32, max_iters=1)
    assert not bool(exact)
