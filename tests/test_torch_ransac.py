"""RANSAC tournament of the PyTorch port against the JAX package: the same
threefry hypotheses through the same canonical position map give the same
winning plane."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.ops.segmentation import (
    ransac_plane_masked as jax_ransac,
)
from pointclouds_tpu_torch.ops.segmentation import ransac_plane_masked

THR = np.float32(0.15)


def _cloud(seed, n_ground, cap):
    rng = np.random.default_rng(seed)
    g = np.column_stack([rng.uniform(-20, 20, n_ground),
                         rng.uniform(-15, 15, n_ground),
                         rng.normal(0, 0.03, n_ground)])
    objs = rng.uniform([-5, -5, 0.5], [5, 5, 2.5], (n_ground // 5, 3))
    noise = rng.uniform([-25, -20, -3], [25, 20, 8], (n_ground // 50, 3))
    pts = np.vstack([g, objs, noise]).astype(np.float32)
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(pts)] = pts
    valid = np.zeros(cap, bool)
    valid[: len(pts)] = rng.random(len(pts)) < 0.95  # scattered holes
    # A canonical order that is not row order: position p -> row.
    key = np.where(valid, rng.permutation(cap), 2**31 - 1).astype(np.int32)
    position_rows = np.argsort(key, kind="stable").astype(np.int32)
    return xyz, valid, position_rows


@pytest.mark.parametrize("seed,n_ground,cap", [(0, 3000, 4096),
                                               (1, 12000, 16384),
                                               (1234, 30000, 65536)])
def test_ransac_tournament_matches_jax(seed, n_ground, cap):
    xyz, valid, rows = _cloud(seed, n_ground, cap)
    jn, jd, jin = jax_ransac(jnp.asarray(xyz), jnp.asarray(valid), THR, seed,
                             500, score_subsample=4096,
                             position_rows=jnp.asarray(rows))
    tn, td, tin = ransac_plane_masked(
        torch.from_numpy(xyz), torch.from_numpy(valid), THR, seed, 500,
        score_subsample=4096, position_rows=torch.from_numpy(rows))
    jn, jd, jin = np.asarray(jn), float(jd), np.asarray(jin)
    np.testing.assert_allclose(tn.numpy(), jn, atol=1e-6)
    assert abs(float(td) - jd) <= 1e-6
    assert abs(abs(jn[2]) - 1.0) < 1e-2  # the ground plane won
    # Inlier masks equal except points within 1e-5 of the threshold.
    dist = np.abs(xyz.astype(np.float64) @ jn.astype(np.float64) + jd)
    differ = tin.numpy() != jin
    assert (np.abs(dist[differ] - THR) < 1e-5).all()
    assert jin.sum() > n_ground * 0.8


def test_ransac_full_scoring_not_ported():
    xyz, valid, _ = _cloud(0, 300, 512)
    with pytest.raises(NotImplementedError, match="ransac_score_counts"):
        ransac_plane_masked(torch.from_numpy(xyz), torch.from_numpy(valid),
                            THR, 0, 500)
