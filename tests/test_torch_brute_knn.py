"""Whole-cloud exact kNN of the PyTorch port against the JAX package: the
plain version of the `brute_knn_idx` kernel against the Pallas kernel in
interpret mode, and the torch `bruteforce_knn` / `bruteforce_radius_count`
against their XLA originals.

`brute_knn_idx`: distances and counts are bitwise equal (the same pinned
d2, fma(dz, dz, fma(dx, dx, dy*dy)), correctly rounded square roots);
positions are compared where the kth distance is not tied. The XLA brute
force sums ``diff * diff`` over the last axis, which XLA's CPU backend
contracts to fma(dz, dz, fma(dy, dy, dx*dx)) (measured), so against it the
kernel's distances agree to 1 ulp, and the port's `bruteforce_knn` (which
pins that form) bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.ops import fusedops as jfused
from pointclouds_tpu.ops.registration import _to_planar as jplanar
from pointclouds_tpu.spatial import knn as jknn
from pointclouds_tpu.spatial import pallas_kernels as jpk
from pointclouds_tpu_torch.ops import fusedops
from pointclouds_tpu_torch.spatial import kernels, knn
from pointclouds_tpu_torch.utils.interop import to_torch


def _cloud(seed, n):
    rng = np.random.default_rng(seed)
    xyz = np.vstack([rng.uniform(0, 8, (n - n // 10, 3)),
                     rng.uniform(-30, 30, (n // 10, 3))]).astype(np.float32)
    valid = rng.random(n) > 0.05
    xyz[~valid & (rng.random(n) > 0.5)] = np.nan
    if n >= 48:
        valid[[11, 12, *range(40, 48)]] = True
        xyz[11] = xyz[12]  # an exact duplicate: tied distances
        xyz[40:48] = xyz[40] + np.float32(0.25) * np.eye(
            3, dtype=np.float32)[np.arange(8) % 3]  # ties at other d2 too
    return xyz, valid


def _queries(xyz, valid, nq, cap, seed):
    use = valid & np.isfinite(xyz).all(1)
    rows = np.nonzero(use)[0][np.random.default_rng(seed).permutation(
        int(use.sum()))[:nq]]
    rows[:2] = [11, 40]
    sub = np.zeros((cap, 3), np.float32)
    sub[:nq] = xyz[rows]
    return sub, np.arange(cap) < nq, use


def _untied(d, k):
    with np.errstate(invalid="ignore"):  # inf - inf past the count
        return np.isfinite(d).all(axis=0) & (np.diff(d, axis=0) != 0).all(
            axis=0)


@pytest.mark.parametrize("k,nq", [
    pytest.param(11, 200, id="11"), pytest.param(10, 200, id="10"),
    pytest.param(24, 200, id="24"), pytest.param(1, 200, id="1"),
    pytest.param(11, 0, id="no-live-block")])
def test_brute_knn_idx_plain_matches_pallas(k, nq):
    """``nq`` valid queries of 384; with none, every block is all padding."""
    xyz, valid = _cloud(k, 2000)
    sub, sub_valid, use = _queries(xyz, valid, 200, 384, k)
    sub_valid &= np.arange(384) < nq
    qp = jplanar(jnp.asarray(sub), jnp.asarray(sub_valid))
    cand = jplanar(jnp.asarray(xyz), jnp.asarray(use))
    pal = np.asarray(jpk.brute_knn_idx(qp, cand, k=k, interpret=True))
    kernels.reset_launch_counts()
    got = kernels.brute_knn_idx(to_torch(qp), to_torch(cand), k=k).numpy()
    assert kernels.LAUNCHES["brute_knn_idx"] == 0  # CPU: plain
    np.testing.assert_array_equal(got[:k], pal[:k])  # distances, bitwise
    np.testing.assert_array_equal(got[2 * k], pal[2 * k])  # counts
    untied = _untied(got[:k], k)
    assert not untied[nq:].any()
    np.testing.assert_array_equal(got[k:2 * k, untied], pal[k:2 * k, untied])
    # Padding queries: nothing found.
    assert (got[2 * k, nq:] == 0).all() and (got[k:2 * k, nq:] == -1).all()
    if nq == 0:
        assert (got[:k] == np.inf).all()
        np.testing.assert_array_equal(got, pal)
        return
    assert untied[:nq].mean() > 0.9
    if k == 1:
        return  # one neighbour: no tie within a list
    # Where tied, the port takes the smaller position.
    pos = got[k:2 * k]
    with np.errstate(invalid="ignore"):
        same = (np.diff(got[:k], axis=0) == 0) & (pos[1:] >= 0)
    assert same.any() and (pos[1:][same] > pos[:-1][same]).all()


def _ulps(a, b):
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
              for x in (a, b))
    return np.abs(ia - ib)


def test_rescue_knn_matches_bruteforce_knn():
    """`fusedops._rescue_knn` (the kernel path) against the JAX package's
    XLA brute force on the same flagged queries."""
    xyz, valid = _cloud(7, 3000)
    sub, sub_valid, _ = _queries(xyz, valid, 300, 512, 7)
    k = 11
    wd, wi, wv = (np.asarray(a) for a in jknn.bruteforce_knn(
        jnp.asarray(xyz), jnp.asarray(valid), jnp.asarray(sub),
        jnp.asarray(sub_valid), k))
    gd, gi, gv = (a.numpy() for a in fusedops._rescue_knn(
        torch.from_numpy(xyz), torch.from_numpy(valid), torch.from_numpy(sub),
        torch.from_numpy(sub_valid), k))
    np.testing.assert_array_equal(gv, wv)
    assert (_ulps(gd[gv], wd[wv]) <= 1).all()
    untied = _untied(wd.T, k) & _untied(gd.T, k)
    np.testing.assert_array_equal(gi[untied], wi[untied])
    # The JAX package's own kernel path agrees with the port bitwise.
    jd, _, _ = jfused._rescue_knn(
        jnp.asarray(xyz), jnp.asarray(valid), jnp.asarray(sub),
        jnp.asarray(sub_valid), k, use_kernel=True, interpret=True)
    np.testing.assert_array_equal(gd, np.asarray(jd))


@pytest.mark.parametrize("n,k", [(1500, 11), (300, 16), (20, 30)])
def test_bruteforce_knn_matches_jax(n, k):
    xyz, valid = _cloud(n, n)
    want = [np.asarray(a) for a in jknn.bruteforce_knn(
        jnp.asarray(xyz), jnp.asarray(valid), jnp.asarray(xyz),
        jnp.asarray(valid), k)]
    got = [a.numpy() for a in knn.bruteforce_knn(
        torch.from_numpy(xyz), torch.from_numpy(valid),
        torch.from_numpy(xyz), torch.from_numpy(valid), k)]
    for g, w in zip(got, want):  # indices too: ties to the smaller one
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("radius", [0.4, np.float32(0.4)])
def test_bruteforce_radius_count_matches_jax(radius):
    """A Python float radius is squared in float64 in the JAX package
    (a weakly typed argument), an f32 one in f32; both are mirrored."""
    xyz, valid = _cloud(3, 1500)
    d = xyz[100] - xyz[:50]  # points exactly on the radius of row 100
    r = np.float32(radius)
    xyz[:50] = xyz[100] + d / np.linalg.norm(d, axis=1, keepdims=True) * r
    want = np.asarray(jknn.bruteforce_radius_count(
        jnp.asarray(xyz), jnp.asarray(valid), jnp.asarray(xyz),
        jnp.asarray(valid), radius))
    got = knn.bruteforce_radius_count(
        torch.from_numpy(xyz), torch.from_numpy(valid), torch.from_numpy(xyz),
        torch.from_numpy(valid), radius).numpy()
    np.testing.assert_array_equal(got, want)
