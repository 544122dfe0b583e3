"""`sweep.sweep_sor_mean_dists` (pass 1 of the SOR sweep on its own) of the
PyTorch port against the JAX package's CPU path (`use_kernel=False`, the
XLA mirror of the Pallas kernel) and a numpy brute force, on the cases of
the JAX package's own tests (`tests/test_sweep.py`).

Tolerances: wherever JAX certifies a row, the port certifies it too and
its mean is bitwise equal (the port selects exactly, so its certified set
is a superset); certified means agree with the float32 brute force within
rtol 1e-5, atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.spatial import sweep as jsweep
from pointclouds_tpu_torch.spatial import kernels, sweep


def brute_sor_means(pts, mask, k):
    """Mean distance to the k nearest neighbours (self skipped through the
    k+1 extraction), float32 distances."""
    ok = mask & np.isfinite(pts).all(axis=1)
    idx = np.nonzero(ok)[0]
    p32 = pts[idx].astype(np.float32)
    out = np.full(len(pts), np.inf, np.float32)
    for i, p in zip(idx, p32):
        d = np.sqrt(((p32 - p) ** 2).sum(axis=1)).astype(np.float32)
        d.sort()
        sel = d[: k + 1]
        if len(sel) >= 2:
            out[i] = np.float32(sel.sum() / (len(sel) - 1))
    return out


def _padded(pts):
    n = len(pts)
    cap = 1 << max(8, int(np.ceil(np.log2(max(n, 1)))))
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n] = pts
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return xyz, valid


def _case(name):
    """(xyz, valid, cell, k, least certified share of the port)."""
    rng = np.random.default_rng(
        ["uniform", "overlap", "mixed", "georef", "dups", "invalid",
         "k_above", "all_invalid"].index(name))
    if name == "uniform":
        return (*_padded((rng.random((3000, 3)) * 5).astype(np.float32)),
                0.8, 10, 0.95)
    if name == "overlap":  # the nine windows overlap: no double count
        return (*_padded((rng.random((600, 3)) * 2.0).astype(np.float32)),
                0.9, 8, 0.5)
    if name == "mixed":
        pts = np.vstack([rng.random((1500, 3)) * 5,
                         rng.normal([2, 2, 2], 0.1, (700, 3)),
                         rng.random((800, 3)) * [20, 3, 1]])
        return (*_padded(pts.astype(np.float32)), 0.8, 10, 0.0)
    if name == "georef":  # UTM-scale offsets: the margin grows
        pts = (rng.random((2000, 3)) * 8).astype(np.float32) + np.float32(
            [4.5e5, 1.2e5, 300.0])
        return (*_padded(pts), 1.5, 10, 0.5)
    if name == "dups":  # exact duplicates: distance ties
        base = (rng.random((400, 3)) * 3).astype(np.float32)
        return (*_padded(np.vstack([base, base[:200]])), 0.8, 6, 0.9)
    if name == "invalid":
        xyz, valid = _padded((rng.random((1000, 3)) * 4).astype(np.float32))
        xyz[17] = np.nan  # valid but non-finite
        valid[450] = False
        return xyz, valid, 0.8, 10, 0.9
    if name == "k_above":  # want = min(k + 1, population)
        return (*_padded((rng.random((12, 3)) * 0.2).astype(np.float32)),
                1.0, 20, 1.0)
    return np.zeros((256, 3), np.float32), np.zeros(256, bool), 1.0, 5, 0.0


@pytest.mark.parametrize("name", ["uniform", "overlap", "mixed", "georef",
                                  "dups", "invalid", "k_above",
                                  "all_invalid"])
def test_sweep_sor_mean_dists_matches_jax(name):
    xyz, valid, cell, k, min_share = _case(name)
    jmean, jok, jcert = (np.asarray(a) for a in jsweep.sweep_sor_mean_dists(
        jnp.asarray(xyz), jnp.asarray(valid), np.float32(cell), k=k,
        use_kernel=False))
    kernels.reset_launch_counts()
    got = sweep.sweep_sor_mean_dists(torch.from_numpy(xyz),
                                     torch.from_numpy(valid),
                                     np.float32(cell), k=k)
    assert kernels.LAUNCHES["sweep_select"] == 0  # CPU: plain
    mean, ok, cert = (a.numpy() for a in got)
    assert mean.dtype == np.float32 and mean.shape == (len(xyz),)
    assert ok.dtype == bool and cert.shape == ()

    assert not (jok & ~ok).any(), "the port certifies a superset of JAX's"
    np.testing.assert_array_equal(mean[jok].view(np.uint32),
                                  jmean[jok].view(np.uint32))
    assert bool(cert) or not bool(jcert)

    usable = valid & np.isfinite(xyz).all(axis=1)
    assert bool(cert) == bool(not (usable & ~ok).any())
    assert ok.sum() >= min_share * usable.sum()
    assert not (ok & ~usable).any()
    assert np.isinf(mean[~usable]).all()
    expect = brute_sor_means(xyz, valid, k)
    np.testing.assert_allclose(mean[ok], expect[ok], rtol=1e-5, atol=1e-6,
                               err_msg="certified means vs the brute force")
