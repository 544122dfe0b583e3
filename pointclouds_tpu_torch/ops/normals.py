"""PCA normals from kNN moments with the analytic Cardano 3x3 eigensolver:
the counterpart of `pointclouds_tpu/ops/normals.py`'s
`cardano_smallest_eigvec_comps` and `normals_from_moment_rows`.

The covariance is normalised by its largest absolute entry before the f32
eigensolve, with the reference's relative thresholds; the eigenvalue of
smallest *magnitude* is taken (the reference's quirk) and the eigenvector
comes from the first of three row-pair cross products that is long enough.
Every step is elementwise on 1-D component tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_PP_EPS = 1e-12  # relative analogue of the reference's 1e-30 absolute cutoff
_LEN_EPS = 1e-16
# XLA folds a division by a constant into a multiply by its float32
# reciprocal; the JAX reference's `/ 3.0` and `/ 6.0` run so.
_THIRD = float(np.float32(1.0 / 3.0))
_SIXTH = float(np.float32(1.0 / 6.0))


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

    sqrt_p = torch.sqrt(torch.where(near_identity, 1.0, pp))
    det_ratio = torch.clamp(q / (sqrt_p * (sqrt_p * sqrt_p)), -1.0, 1.0)
    phi = torch.arccos(det_ratio) * _THIRD

    two_pi_3 = 2.0 * math.pi / 3.0
    eig0 = m + 2.0 * sqrt_p * torch.cos(phi + two_pi_3)  # smallest
    eig2 = m + 2.0 * sqrt_p * torch.cos(phi)  # largest
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


def normals_from_moment_rows(m1r, m2r, cnt, xyz, viewpoint):
    """Oriented unit PCA normals f32[N, 3] from query-centred kNN moment
    rows (m1r f32[3, N], m2r f32[6, N] in xx, yy, zz, xy, xz, yz order,
    cnt f32[N]); rows with no neighbour get (0, 0, 1), others are flipped
    to face ``viewpoint``."""
    vp = torch.as_tensor(viewpoint, dtype=torch.float32, device=xyz.device)
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
    length = torch.sqrt(vx * vx + vy * vy + vz * vz)
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
