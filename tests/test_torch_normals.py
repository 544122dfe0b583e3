"""The Cardano eigensolver and moment-row normals of the PyTorch port
against the JAX package. The f32 arccos/cos of the two libraries differ in
the last bits, so eigenvectors are held to |dot| > 1 - 1e-6 after
normalisation; the degenerate defaults are held equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.ops import normals as jn
from pointclouds_tpu_torch.ops import normals as tn

N = 2000


def _covs(kind, rng):
    """Six covariance components of N matrices of one kind. SPD and
    rank-deficient (one zero eigenvalue) matrices are neighbourhoods of
    surfaces tilted up to 45 degrees from horizontal, with a separated
    smallest eigenvalue, so the normal is defined to f32 precision (the
    row-pair cross products the reference takes are well conditioned);
    near-identity and zero ones take the default."""
    if kind in ("spd", "rank2"):
        tilt = rng.uniform(0.0, np.pi / 4, N)
        az = rng.uniform(0.0, 2 * np.pi, N)
        v = np.stack([np.sin(tilt) * np.cos(az), np.sin(tilt) * np.sin(az),
                      np.cos(tilt)], axis=1)
        u = np.cross(v, rng.normal(size=(N, 3)))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        q = np.stack([v, u, np.cross(v, u)], axis=2)  # columns: v, u, w
        lo = 0.0 if kind == "rank2" else 0.02
        lam = np.stack([rng.uniform(lo, 0.1, N), rng.uniform(0.4, 1.0, N),
                        rng.uniform(1.5, 3.0, N)], axis=1)
        c = np.einsum("nij,nj,nkj->nik", q, lam, q)
    elif kind == "near_identity":
        c = np.eye(3) * rng.uniform(0.5, 2.0, (N, 1, 1)) + rng.normal(
            size=(N, 3, 3)) * 1e-9
        c = (c + c.transpose(0, 2, 1)) / 2
    else:  # zero
        c = np.zeros((N, 3, 3))
    c = (c * rng.uniform(1e-3, 1e3, (N, 1, 1))).astype(np.float32)
    return [c[:, i, j] for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                    (2, 2))]


def _unit(v):
    v = v.astype(np.float64)
    n = np.linalg.norm(v, axis=0)
    return v / np.where(n > 0, n, 1.0)


@pytest.mark.parametrize("kind", ["spd", "rank2", "near_identity", "zero"])
def test_cardano_matches_jax(kind):
    comps = _covs(kind, np.random.default_rng(len(kind)))
    want = np.stack([np.asarray(v) for v in jn.cardano_smallest_eigvec_comps(
        *(jnp.asarray(c) for c in comps))])
    got = torch.stack(tn.cardano_smallest_eigvec_comps(
        *(torch.from_numpy(c) for c in comps))).numpy()
    default = np.all(want == np.array([[0.0], [0.0], [1.0]]), axis=0)
    np.testing.assert_array_equal(
        default, np.all(got == np.array([[0.0], [0.0], [1.0]]), axis=0))
    if kind in ("near_identity", "zero"):
        assert default.all()
    dots = np.abs(np.sum(_unit(want) * _unit(got), axis=0))
    assert (dots > 1 - 1e-6).all(), np.sort(dots)[:5]


def test_normals_from_moment_rows_matches_jax():
    rng = np.random.default_rng(5)
    n, k = 3000, 15
    # Moments of k neighbours around each query, from a noisy plane.
    nb = rng.normal(size=(n, k, 3)) * [1.0, 1.0, 0.05]
    nb[: n // 50] = 0.0  # all neighbours at the query: degenerate
    m1 = nb.sum(1).T.astype(np.float32)
    m2 = np.stack([(nb[..., a] * nb[..., b]).sum(1) for a, b in
                   ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))]
                  ).astype(np.float32)
    cnt = np.full(n, k, np.float32)
    cnt[-10:] = 0.0  # no neighbour: (0, 0, 1)
    xyz = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    vp = np.array([0.0, 0.0, 10000.0], np.float32)
    want = np.asarray(jn.normals_from_moment_rows(
        jnp.asarray(m1), jnp.asarray(m2), jnp.asarray(cnt), jnp.asarray(xyz),
        jnp.asarray(vp)))
    got = tn.normals_from_moment_rows(
        torch.from_numpy(m1), torch.from_numpy(m2), torch.from_numpy(cnt),
        torch.from_numpy(xyz), vp).numpy()
    np.testing.assert_array_equal(got[-10:], want[-10:])
    dots = np.sum(got.astype(np.float64) * want, axis=1)  # with orientation
    assert (dots > 1 - 1e-6).all(), np.sort(dots)[:5]
    assert (want[: n - 10, 2] > 0.9).mean() > 0.9  # faces the viewpoint
