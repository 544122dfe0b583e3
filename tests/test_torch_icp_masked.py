"""The masked ICP entries of the PyTorch port (`registration.
icp_point_to_point_masked`, `icp_point_to_plane_masked`: the loop on the
whole padded clouds, returning the 6-tuple) against the JAX package's
`_masked` functions on the CPU, and against the port's API ICP, which
trims the padding first.

Tolerances, those of tests/test_torch_icp.py: iterations and convergence
equal; fitness and rmse within rtol 1e-5 (rmse also atol 1e-6: at a fixed
point it is float32 noise); rotation and translation within atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.ops import registration as jreg
from pointclouds_tpu_torch import api
from pointclouds_tpu_torch.ops import registration as treg
from pointclouds_tpu_torch.spatial import kernels

CAP = 2048


def _rotation(a, b, c):
    ca, sa, cb, sb, cc, sc = (np.cos(a), np.sin(a), np.cos(b), np.sin(b),
                              np.cos(c), np.sin(c))
    rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rz = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _pad(a):
    out = np.zeros((CAP, 3), np.float32)
    out[:len(a)] = a
    return out


def _surface(rng, n):
    xy = rng.uniform(-2, 2, (n, 2))
    z = 0.3 * np.sin(1.5 * xy[:, 0]) * np.cos(xy[:, 1])
    nrm = np.stack([-0.45 * np.cos(1.5 * xy[:, 0]) * np.cos(xy[:, 1]),
                    0.3 * np.sin(1.5 * xy[:, 0]) * np.sin(xy[:, 1]),
                    np.ones(n)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (np.column_stack([xy, z]).astype(np.float32),
            nrm.astype(np.float32))


def _case(name):
    """(src, tgt, tgt normals or None, max_dist)."""
    rng = np.random.default_rng(["rigid", "max_dist", "partial",
                                 "plane"].index(name))
    if name == "plane":
        tgt, nrm = _surface(rng, 1300)
        rot = _rotation(0.01, 0.015, -0.02)
        return ((tgt[:1100] - 0.02) @ rot.T).astype(np.float32), tgt, nrm, \
            np.inf
    src = rng.uniform(-2, 2, (1500, 3)).astype(np.float32)
    tgt = (src @ _rotation(0.03, -0.02, 0.05).T
           + [0.1, -0.05, 0.08]).astype(np.float32)
    if name == "partial":  # fewer target points: some pairs stay far
        tgt = tgt[:1100]
    return src, tgt, None, (0.05 if name == "max_dist" else np.inf)


def _check(got, want):
    rot, trans, fit, rmse, conv, iters = (np.asarray(v) for v in got)
    wrot, wtrans, wfit, wrmse, wconv, witers = (np.asarray(v) for v in want)
    assert rot.shape == (3, 3) and trans.shape == (3,)
    assert conv.dtype == bool and iters.dtype == np.int32
    assert int(iters) == int(witers) and bool(conv) == bool(wconv)
    np.testing.assert_allclose(fit, wfit, rtol=1e-5)
    np.testing.assert_allclose(rmse, wrmse, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rot, wrot, rtol=0, atol=1e-5)
    np.testing.assert_allclose(trans, wtrans, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["rigid", "max_dist", "partial", "plane"])
def test_icp_masked_matches_jax_and_api(name):
    src, tgt, nrm, max_dist = _case(name)
    sv, tv = np.arange(CAP) < len(src), np.arange(CAP) < len(tgt)
    scal = (10, np.float32(1e-6), np.float32(max_dist))
    jargs = [jnp.asarray(_pad(src)), jnp.asarray(sv), jnp.asarray(_pad(tgt)),
             jnp.asarray(tv)]
    targs = [torch.from_numpy(_pad(src)), torch.from_numpy(sv),
             torch.from_numpy(_pad(tgt)), torch.from_numpy(tv)]
    kernels.reset_launch_counts()
    if nrm is None:
        want = jreg.icp_point_to_point_masked(*jargs, *scal)
        got = treg.icp_point_to_point_masked(*targs, *scal)
    else:
        want = jreg.icp_point_to_plane_masked(*jargs, jnp.asarray(_pad(nrm)),
                                              *scal)
        got = treg.icp_point_to_plane_masked(
            *targs, torch.from_numpy(_pad(nrm)), *scal)
    assert kernels.LAUNCHES["nn_argmin"] == 0  # CPU: plain
    assert int(want[5]) >= 2
    _check(got, want)

    # The API's ICP on the same clouds (trimmed to 1,536 rows of 2,048).
    s = api.PointCloud.from_numpy(src, device="cpu")
    t = api.PointCloud.from_numpy(tgt, device="cpu")
    if nrm is None:
        res = api.icp_point_to_point(s, t, 10, 1e-6, float(max_dist))
    else:
        t = api.PointCloud._from(t._arrs._replace(
            normals=torch.from_numpy(_pad(nrm))), len(tgt))
        res = api.icp_point_to_plane(s, t, 10, 1e-6, float(max_dist))
    _check(got, (np.float32(res.rotation), np.float32(res.translation),
                 np.float32(res.fitness), np.float32(res.rmse),
                 np.bool_(res.converged), np.int32(res.num_iterations)))
