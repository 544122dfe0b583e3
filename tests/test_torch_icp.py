"""ICP of the PyTorch port against the JAX package on the CPU: the plain
version of the `nn_argmin` kernel against the Pallas kernel in interpret
mode, and both ICP variants against the JAX package's kernel path
(`use_kernel=True, interpret=True`) at up to 1,024 points and 10
iterations.

Tolerances: `nn_argmin`'s d2 and positions are bitwise equal (the same
pinned d2, ties to the last position). ICP: iterations, convergence and
fitness equal; rotation and translation within 1e-5 absolute; rmse within
1e-5 relative plus 1e-6 absolute (at a fixed point the rmse is f32 noise,
~1e-7). The two packages sum over the points in different orders, so the
transforms agree to float32 rounding, not bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.ops import registration as jreg
from pointclouds_tpu.spatial import pallas_kernels as jpk
from pointclouds_tpu_torch import api
from pointclouds_tpu_torch.ops import registration as treg
from pointclouds_tpu_torch.spatial import kernels

CAP = 1024


def _pad(a, width=3):
    out = np.zeros((CAP, width), np.float32)
    out[:len(a)] = a
    return out


def _rotation(a, b, c):
    ca, sa, cb, sb, cc, sc = (np.cos(a), np.sin(a), np.cos(b), np.sin(b),
                              np.cos(c), np.sin(c))
    rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rz = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _lattice(n_side):
    g = np.arange(n_side, dtype=np.float32)
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


@pytest.mark.parametrize("case", ["random", "lattice", "none"])
def test_nn_argmin_plain_matches_pallas(case):
    """"none": no valid candidate, so every served query gets +inf and
    the target's last position."""
    rng = np.random.default_rng(0)
    if case == "lattice":  # queries at half-shift: 8 nearest at equal d2
        c = _lattice(8)
        q = c[:300] + np.float32(0.5)
    else:
        c = rng.uniform(-3, 3, (700, 3)).astype(np.float32)
        q = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
    cv, qv = rng.random(len(c)) > 0.1, rng.random(len(q)) > 0.1
    if case == "none":
        cv[:] = False
    qp = jreg._to_planar(jnp.asarray(q), jnp.asarray(qv))
    cp = jreg._to_planar(jnp.asarray(c), jnp.asarray(cv))
    want = [np.asarray(a) for a in jpk.nn_argmin(qp, cp, interpret=True)]
    kernels.reset_launch_counts()
    got = [a.numpy() for a in kernels.nn_argmin(
        treg._to_planar(torch.from_numpy(q), torch.from_numpy(qv)),
        treg._to_planar(torch.from_numpy(c), torch.from_numpy(cv)))]
    assert kernels.LAUNCHES["nn_argmin"] == 0  # CPU: plain
    served = np.zeros(len(got[0]), bool)
    served[:len(q)] = qv  # the TPU kernel leaves the other rows undefined
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[served], w[served])
    assert (got[1][~served] == -1).all() and np.isinf(got[0][~served]).all()
    if case == "none":
        last = 128 * -(-len(c) // 128) - 1
        assert np.isinf(got[0][served]).all()
        assert (got[1][served] == last).all()


def _run_both(src, tgt, n_src, n_tgt, iters, tol, max_dist, normals=None):
    sv, tv = np.arange(CAP) < n_src, np.arange(CAP) < n_tgt
    rows = dict(src_rows=CAP, tgt_rows=CAP)
    jargs = [jnp.asarray(_pad(src)), jnp.asarray(sv), jnp.asarray(_pad(tgt)),
             jnp.asarray(tv)]
    targs = [torch.from_numpy(_pad(src)), torch.from_numpy(sv),
             torch.from_numpy(_pad(tgt)), torch.from_numpy(tv)]
    scal = (iters, np.float32(tol), np.float32(max_dist))
    if normals is None:
        want = jreg.icp_point_to_point_packed(
            *jargs, *scal, use_kernel=True, interpret=True, **rows)
        got = treg.icp_point_to_point_packed(*targs, *scal, **rows)
    else:
        want = jreg.icp_point_to_plane_packed(
            *jargs, jnp.asarray(_pad(normals)), *scal, use_kernel=True,
            interpret=True, **rows)
        got = treg.icp_point_to_plane_packed(
            *targs, torch.from_numpy(_pad(normals)), *scal, **rows)
    return got.numpy(), np.asarray(want)


def _check(got, want):
    # [rot(9), trans(3), fitness, rmse, converged, iterations]
    assert got[15] == want[15] and got[14] == want[14]
    assert got[12] == want[12]
    np.testing.assert_allclose(got[13], want[13], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:12], want[:12], rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["rigid", "tight_tol", "max_dist",
                                  "partial", "lattice"])
def test_icp_point_to_point_matches_jax(case):
    rng = np.random.default_rng(1)
    n = 900
    src = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    rot = _rotation(0.03, -0.02, 0.05)
    trans = np.array([0.1, -0.05, 0.08])
    iters, tol, max_dist, n_tgt = 10, 1e-5, np.inf, n
    if case == "lattice":  # a half-shifted lattice: exact distance ties
        src = _lattice(9)[:n] * np.float32(0.5)
        tgt = src + np.float32(0.25)
    else:
        tgt = (src @ rot.T + trans).astype(np.float32)
    if case == "tight_tol":
        tol = 1e-9  # runs to the iteration cap or the exact fixed point
    if case == "max_dist":
        max_dist = 0.05
    if case == "partial":  # fewer target points: some pairs stay far
        n_tgt = 700
    got, want = _run_both(src, tgt[:n_tgt], n, n_tgt, iters, tol, max_dist)
    assert want[15] >= 2
    _check(got, want)


def _surface(rng, n):
    xy = rng.uniform(-2, 2, (n, 2))
    z = 0.3 * np.sin(1.5 * xy[:, 0]) * np.cos(xy[:, 1])
    nrm = np.stack([-0.45 * np.cos(1.5 * xy[:, 0]) * np.cos(xy[:, 1]),
                    0.3 * np.sin(1.5 * xy[:, 0]) * np.sin(xy[:, 1]),
                    np.ones(n)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (np.column_stack([xy, z]).astype(np.float32),
            nrm.astype(np.float32))


@pytest.mark.parametrize("case", ["small_motion", "max_dist"])
def test_icp_point_to_plane_matches_jax(case):
    rng = np.random.default_rng(2)
    tgt, nrm = _surface(rng, 1000)
    rot = _rotation(0.01, 0.015, -0.02)
    src = ((tgt[:800] - 0.02) @ rot.T).astype(np.float32)
    max_dist = 0.3 if case == "max_dist" else np.inf
    got, want = _run_both(src, tgt, 800, 1000, 10, 1e-6, max_dist,
                          normals=nrm)
    assert want[15] >= 2
    _check(got, want)


def test_api_icp_on_port():
    """The API's ICP on the port: a translated cloud converges to the
    translation; without target normals point-to-plane raises."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 4, (600, 3)).astype(np.float32)
    src = api.PointCloud.from_numpy(pts, device="cpu")
    tgt = api.PointCloud.from_numpy(pts + np.float32(0.05), device="cpu")
    res = api.icp_point_to_point(src, tgt, max_iterations=20)
    assert res.converged and res.num_iterations < 20
    np.testing.assert_allclose(res.translation, [0.05] * 3, atol=1e-5)
    np.testing.assert_allclose(res.rotation, np.eye(3), atol=1e-5)
    with pytest.raises(ValueError):
        api.icp_point_to_plane(src, tgt)
    empty = api.icp_point_to_point(api.PointCloud(device="cpu"), tgt)
    assert empty.num_iterations == 0 and not empty.converged
