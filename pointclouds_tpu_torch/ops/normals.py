"""PCA normals from kNN moments or kNN lists with the analytic Cardano 3x3
eigensolver: the counterpart of `pointclouds_tpu/ops/normals.py`.

The covariance is normalised by its largest absolute entry before the f32
eigensolve, with the reference's relative thresholds; the eigenvalue of
smallest *magnitude* is taken (the reference's quirk) and the eigenvector
comes from the first of three row-pair cross products that is long enough.
Every step is elementwise on 1-D component tensors; square roots, arccos
and cos go through float64, so the card and the CPU give the same bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..spatial.kernels import _dot3, _sqrt_f32, fma_f32
from ..utils import profiling


def _viewpoint(viewpoint, xyz):
    """``viewpoint`` as f32 on ``xyz``'s device; an upload (which waits for
    the card's stream) only where it is not there yet."""
    if torch.is_tensor(viewpoint) and viewpoint.device == xyz.device:
        return viewpoint.to(torch.float32)
    with profiling.host_read("normals.viewpoint"):
        return torch.as_tensor(viewpoint, dtype=torch.float32,
                               device=xyz.device)

_PP_EPS = 1e-12  # relative analogue of the reference's 1e-30 absolute cutoff
_LEN_EPS = 1e-16
# XLA folds a division by a constant into a multiply by its float32
# reciprocal; the JAX reference's `/ 3.0` and `/ 6.0` run so.
_THIRD = float(np.float32(1.0 / 3.0))
_SIXTH = float(np.float32(1.0 / 6.0))


def _via_f64(fn, x):
    """``fn`` taken in float64 and rounded to float32: the CPU's and the
    card's f32 transcendentals differ in the last ulp, their float64
    results rounded to f32 (all but never) do not, so a cloud's normals
    are the same on both devices."""
    return fn(x.to(torch.float64)).to(torch.float32)


def cardano_smallest_eigvec_comps(c00, c01, c02, c11, c12, c22):
    """Eigenvector (unnormalised) of the smallest-|lambda| eigenvalue of the
    symmetric matrices given by six 1-D components; three 1-D components
    out. Degenerate and near-identity inputs give (0, 0, 1)."""
    comps = (c00, c01, c02, c11, c12, c22)
    scale = torch.stack([c.abs() for c in comps]).amax(dim=0)
    degenerate_scale = scale <= 0.0
    s = torch.where(degenerate_scale, 1.0, scale)
    a00, a01, a02, a11, a12, a22 = (c / s for c in comps)

    m = (a00 + a11 + a22) * _THIRD
    b00, b11, b22 = a00 - m, a11 - m, a22 - m

    q = (b00 * (b11 * b22 - a12 * a12)
         - a01 * (a01 * b22 - a12 * a02)
         + a02 * (a01 * a12 - b11 * a02)) * 0.5
    p = (b00 * b00 + b11 * b11 + b22 * b22
         + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) * _SIXTH
    pp = torch.clamp(p, min=0.0)
    near_identity = pp < _PP_EPS

    sqrt_p = _sqrt_f32(torch.where(near_identity, 1.0, pp))
    det_ratio = torch.clamp(q / (sqrt_p * (sqrt_p * sqrt_p)), -1.0, 1.0)
    phi = _via_f64(torch.arccos, det_ratio) * _THIRD

    two_pi_3 = 2.0 * math.pi / 3.0
    eig0 = m + 2.0 * sqrt_p * _via_f64(torch.cos, phi + two_pi_3)  # smallest
    eig2 = m + 2.0 * sqrt_p * _via_f64(torch.cos, phi)  # largest
    eig1 = 3.0 * m - eig0 - eig2

    # The eigenvalue of smallest |lambda|, as the reference picks it.
    abs0, abs1, abs2 = eig0.abs(), eig1.abs(), eig2.abs()
    lam = torch.where((abs0 <= abs1) & (abs0 <= abs2), eig0,
                      torch.where(abs1 <= abs2, eig1, eig2))

    r00, r11, r22 = a00 - lam, a11 - lam, a22 - lam
    e01 = (a01 * a12 - r11 * a02, a02 * a01 - a12 * r00, r00 * r11 - a01 * a01)
    e02 = (a01 * r22 - a12 * a02, a02 * a02 - r22 * r00, r00 * a12 - a01 * a02)
    e12 = (r11 * r22 - a12 * a12, a12 * a02 - r22 * a01, a01 * a12 - r11 * a02)

    def len2(e):
        return e[0] * e[0] + e[1] * e[1] + e[2] * e[2]

    l01, l02, l12 = len2(e01), len2(e02), len2(e12)
    bad = near_identity | degenerate_scale
    out = []
    for comp in range(3):
        dflt = 1.0 if comp == 2 else 0.0
        v = torch.where(
            l01 >= _LEN_EPS, e01[comp],
            torch.where(l02 >= _LEN_EPS, e02[comp],
                        torch.where(l12 >= _LEN_EPS, e12[comp], dflt)))
        out.append(torch.where(bad, dflt, v))
    return tuple(out)


def cardano_smallest_eigvec(cov):
    """`cardano_smallest_eigvec_comps` on symmetric [N, 3, 3] matrices;
    returns f32[N, 3] (unnormalised)."""
    return torch.stack(cardano_smallest_eigvec_comps(
        cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
        cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]), dim=1)


def normals_from_knn(xyz, nbr_idx, nbr_valid, viewpoint, query_xyz=None):
    """Oriented unit PCA normals f32[Q, 3] from kNN lists (nbr_idx i32[Q, k]
    rows of ``xyz``, nbr_valid bool[Q, k]): neighbour centroid, 3x3
    covariance, smallest eigenvector, unit length, flipped to face
    ``viewpoint`` from ``query_xyz`` (default ``xyz``: one list per row);
    rows with no neighbour get (0, 0, 1). Sums run over the k neighbours
    one at a time, so the result does not depend on the device."""
    if query_xyz is None:
        query_xyz = xyz
    vp = _viewpoint(viewpoint, xyz)
    pts = xyz[nbr_idx.long()]  # [Q, k, 3]
    use = nbr_valid[:, :, None]
    cnt = nbr_valid.to(torch.float32).sum(dim=1)
    denom = torch.clamp(cnt, min=1.0)
    nk = pts.shape[1]
    acc = torch.zeros_like(query_xyz)
    for j in range(nk):
        acc = acc + torch.where(use[:, j], pts[:, j], 0.0)
    centroid = acc / denom[:, None]
    d = torch.where(use, pts - centroid[:, None, :], 0.0)
    # The covariance as XLA's CPU backend runs the JAX package's einsum: a
    # sequential fma over the neighbours (measured bitwise).
    # All six (xx, xy, xz, yy, yz, zz) products at once.
    da, db = d[:, :, [0, 0, 0, 1, 1, 2]], d[:, :, [0, 1, 2, 1, 2, 2]]
    cov = torch.zeros((d.shape[0], 6), dtype=d.dtype, device=d.device)
    for j in range(nk):
        cov = fma_f32(da[:, j], db[:, j], cov)
    vec = torch.stack(cardano_smallest_eigvec_comps(*cov.unbind(1)), dim=1)
    length = _sqrt_f32(_dot3(vec, vec))
    unit = torch.where((length > 1e-10)[:, None],
                       vec / torch.clamp(length, min=1e-30)[:, None], vec)
    dot = _dot3(unit, vp[None, :] - query_xyz)
    oriented = torch.where((dot < 0.0)[:, None], -unit, unit)
    up = torch.tensor([0.0, 0.0, 1.0], device=xyz.device)
    return torch.where((cnt < 1.0)[:, None], up[None, :], oriented)


def normals_from_moment_rows(m1r, m2r, cnt, xyz, viewpoint):
    """Oriented unit PCA normals f32[N, 3] from query-centred kNN moment
    rows (m1r f32[3, N], m2r f32[6, N] in xx, yy, zz, xy, xz, yz order,
    cnt f32[N]); rows with no neighbour get (0, 0, 1), others are flipped
    to face ``viewpoint``."""
    vp = _viewpoint(viewpoint, xyz)
    denom = torch.clamp(cnt, min=1.0)
    mx, my, mz = m1r[0] / denom, m1r[1] / denom, m1r[2] / denom
    # cov = M2 - cnt * mean mean^T (query-relative moments)
    vx, vy, vz = cardano_smallest_eigvec_comps(
        m2r[0] - cnt * mx * mx,
        m2r[3] - cnt * mx * my,
        m2r[4] - cnt * mx * mz,
        m2r[1] - cnt * my * my,
        m2r[5] - cnt * my * mz,
        m2r[2] - cnt * mz * mz,
    )
    length = _sqrt_f32(vx * vx + vy * vy + vz * vz)
    ok_len = length > 1e-10
    inv_len = 1.0 / torch.clamp(length, min=1e-30)
    ux = torch.where(ok_len, vx * inv_len, vx)
    uy = torch.where(ok_len, vy * inv_len, vy)
    uz = torch.where(ok_len, vz * inv_len, vz)
    dot = (ux * (vp[0] - xyz[:, 0]) + uy * (vp[1] - xyz[:, 1])
           + uz * (vp[2] - xyz[:, 2]))
    flip = torch.where(dot < 0.0, -1.0, 1.0)
    none_found = cnt < 1.0
    return torch.stack([
        torch.where(none_found, 0.0, ux * flip),
        torch.where(none_found, 0.0, uy * flip),
        torch.where(none_found, 1.0, uz * flip),
    ], dim=1)
