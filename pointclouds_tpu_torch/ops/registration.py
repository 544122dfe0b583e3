"""Rigid registration, point-to-point and point-to-plane ICP: the
counterpart of `pointclouds_tpu/ops/registration.py` on its kernel branch
(`_nn_1` through `nn_argmin`), with its packed (`icp_*_packed`, f32[16])
and masked (`icp_*_masked`, the 6-tuple, untrimmed) entries, and the
planar packing of a cloud for the kernels.

Dropped: ``use_kernel`` and ``interpret`` (the device of the input
tensors picks the CUDA kernel or its plain version), the `IcpCarry` of
the reference's `lax.while_loop` (the loop runs on the host) and
`nn_kernel_fits` (a VMEM residency gate; the card's kernel has none).

The loop is the JAX package's `lax.while_loop` as a host loop with one
host read per iteration (its stop flag). Its semantics are the
reference's: convergence is tested on |prev_rmse - rmse| < tolerance before
solving, the converging iteration counts, an empty correspondence set stops
without updating the last metrics, and the transform composes as R = R_inc
R, t = R_inc t + t_inc. The whole loop runs in a target-centred frame and
the transform is mapped back in float64 afterwards.

Numerics. The point-to-point rotation comes from Horn's quaternion method
(the 4x4 eigenproblem by repeated squaring), as in the JAX package, with
its two snaps (a sub-noise rotation to the identity, sub-ulp translation
components to 0) that make a fixed point repeat exactly. The
point-to-plane step solves the damped 6x6 normal equations in float64 on
the device. Sums over the points accumulate in float64 and round to
float32 where the JAX package holds float32; the small matrix products are
explicit float32 multiply-adds in a fixed order, and square roots, sines
and cosines go through float64, so the card and the CPU compute the same
bits wherever their float64 sums round alike. No float32 matrix product is
left for TF32 to touch; the loop still runs with TF32 off, scoped and
restored.
"""

from __future__ import annotations

import numpy as np
import torch

from ..spatial.kernels import _sqrt_f32, fma_f32, nn_argmin

F32 = torch.float32
F64 = torch.float64


def _to_planar(xyz, use):
    """Pack [N, 3] + validity into the kernels' [NR, 4, 128] planar layout
    (channels x/y/z/w, w = 0/1 validity; tail padded with w = 0)."""
    n = xyz.shape[0]
    nr = max(-(-n // 128), 1)
    pad = nr * 128 - n
    x = torch.cat([xyz, torch.zeros((pad, 3), dtype=xyz.dtype,
                                    device=xyz.device)])
    w = torch.cat([use.to(torch.float32),
                   torch.zeros(pad, dtype=torch.float32, device=xyz.device)])
    arr = torch.cat([x, w[:, None]], dim=1)  # [nr*128, 4]
    return arr.reshape(nr, 128, 4).permute(0, 2, 1).contiguous()


def _nn_1(qxyz, q_use, pxyz, p_use):
    """Exact 1-NN of each query (kernel `nn_argmin`): (dist f32[Q], idx
    i64[Q], found bool[Q]); ties at equal distance to the last target
    row."""
    qn = qxyz.shape[0]
    d2, posf = nn_argmin(_to_planar(qxyz, q_use), _to_planar(pxyz, p_use))
    d2 = d2[:qn]
    idx = torch.clamp(posf[:qn], 0.0, float(pxyz.shape[0] - 1)).long()
    found = q_use & torch.isfinite(d2)
    return _sqrt_f32(torch.clamp(d2, min=0.0)), idx, found


def _sum32(x, dim=0):
    """Sum along ``dim`` accumulated in float64, rounded to float32."""
    return x.to(F64).sum(dim).to(F32)


def _matmul3(a, b):
    """[M, K] x [K, P] float32 product, each entry the sequential fma chain
    fma(a_k, b_k, ... fma(a_1, b_1, a_0 * b_0))."""
    acc = a[:, 0:1] * b[0:1, :]
    for i in range(1, a.shape[1]):
        acc = fma_f32(a[:, i:i + 1], b[i:i + 1, :], acc)
    return acc


def _cross(a, b):
    """Row cross products in the form XLA's CPU backend gives `jnp.cross`:
    fma(a_j, b_k, -(a_k * b_j)) per component."""
    return torch.stack([fma_f32(a[:, j], b[:, k], -(a[:, k] * b[:, j]))
                        for j, k in ((1, 2), (2, 0), (0, 1))], dim=1)


def _quat_from_cross_covariance(h):
    """Optimal rotation quaternion (w, x, y, z) from a 3x3 cross-covariance
    by Horn's method: the top eigenvector of the symmetric 4x4 matrix N,
    shifted so its largest eigenvalue dominates, by six squarings (64 power
    steps) from an identity-biased start."""
    h00, h01, h02 = h[0, 0], h[0, 1], h[0, 2]
    h10, h11, h12 = h[1, 0], h[1, 1], h[1, 2]
    h20, h21, h22 = h[2, 0], h[2, 1], h[2, 2]
    n = torch.stack([
        torch.stack([h00 + h11 + h22, h12 - h21, h20 - h02, h01 - h10]),
        torch.stack([h12 - h21, h00 - h11 - h22, h01 + h10, h02 + h20]),
        torch.stack([h20 - h02, h01 + h10, -h00 + h11 - h22, h12 + h21]),
        torch.stack([h01 - h10, h02 + h20, h12 + h21, -h00 - h11 + h22]),
    ])
    eye = torch.eye(4, dtype=F32, device=h.device)
    ns = n + (_sqrt_f32(_sum32((n * n).reshape(-1))) + 1e-12) * eye
    for _ in range(6):
        ns = ns / torch.clamp(_sqrt_f32(_sum32((ns * ns).reshape(-1))),
                              min=1e-30)
        ns = _matmul3(ns, ns)
    q0 = torch.tensor([1.0, 1e-2, 1e-2, 1e-2], dtype=F32, device=h.device)
    q0 = q0 / _sqrt_f32(_sum32(q0 * q0))
    q = _matmul3(ns, q0[:, None])[:, 0]
    return q / torch.clamp(_sqrt_f32(_sum32(q * q)), min=1e-30)


def _quat_to_rot(q):
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
                     2.0 * (x * z + w * y)]),
        torch.stack([2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
                     2.0 * (y * z - w * x)]),
        torch.stack([2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
                     1.0 - 2.0 * (x * x + y * y)]),
    ])


def _svd_rigid_solve(src, tgt_pts, w):
    """Weighted optimal rigid transform src -> tgt_pts over the rows with
    ``w`` (bool[N]): centroids, the cross-covariance, Horn's rotation, then
    the snaps that make ICP's fixed point exact. Returns (rot f32[3, 3],
    trans f32[3])."""
    wc = w[:, None]
    wsum = torch.clamp(_sum32(w.to(F32)), min=1e-12)
    src_c = _sum32(torch.where(wc, src, 0.0)) / wsum
    tgt_c = _sum32(torch.where(wc, tgt_pts, 0.0)) / wsum
    sc = torch.where(wc, src - src_c, 0.0)
    tc = torch.where(wc, tgt_pts - tgt_c, 0.0)
    h = (sc.to(F64).T @ tc.to(F64)).to(F32)
    q = _quat_from_cross_covariance(h)
    # A rotation with |q_vec| < 1e-6 moves centred f32 points by less than
    # their rounding: the identity, so the fixed point repeats bit-exactly.
    vmag2 = q[1] * q[1] + q[2] * q[2] + q[3] * q[3]
    q = torch.where(vmag2 < 1e-12,
                    torch.tensor([1.0, 0.0, 0.0, 0.0], device=q.device), q)
    rot = _quat_to_rot(q)
    trans = tgt_c - _matmul3(rot, src_c[:, None])[:, 0]
    # Components under ~2 ulps of the largest coordinate cannot move an f32
    # point: exactly 0.
    scale = torch.where(wc, tgt_pts, 0.0).abs().amax()
    trans = torch.where(trans.abs() < 2.4e-7 * scale, 0.0, trans)
    return rot, trans


def _plane_solve(src, tgt_pts, tgt_nrm, w):
    """Linearised point-to-plane step: the 6x6 normal equations (weights
    ``w``) with Tikhonov damping 1e-6 * max |diag|, solved in float64, and
    the Rodrigues rotation of the solved angles (the small-angle linear form
    below 1e-10 rad). Returns (rot f32[3, 3], trans f32[3])."""
    wc = w[:, None]
    a = torch.where(wc, torch.cat([_cross(src, tgt_nrm), tgt_nrm], dim=1), 0.0)
    d = tgt_pts - src
    b = torch.where(w, fma_f32(d[:, 2], tgt_nrm[:, 2], fma_f32(
        d[:, 1], tgt_nrm[:, 1], d[:, 0] * tgt_nrm[:, 0])), 0.0)
    a64 = a.to(F64)
    # The f32 dot products of the JAX package, then promoted to float64.
    ata = (a64.T @ a64).to(F32).to(F64)
    atb = (a64.T @ b.to(F64)).to(F32).to(F64)
    lam = 1e-6 * torch.clamp(torch.diagonal(ata).abs().amax(), min=1e-12)
    ata = ata + lam * torch.eye(6, dtype=F64, device=ata.device)
    x = torch.linalg.solve(ata, atb).to(F32)
    alpha, beta, gamma = x[0], x[1], x[2]
    angle = _sqrt_f32(alpha * alpha + beta * beta + gamma * gamma)
    small = angle < 1e-10
    safe = torch.where(small, 1.0, angle)
    ax, ay, az = alpha / safe, beta / safe, gamma / safe
    c = torch.cos(angle.to(F64)).to(F32)
    s = torch.sin(angle.to(F64)).to(F32)
    t = 1.0 - c
    rod = torch.stack([
        torch.stack([t * ax * ax + c, t * ax * ay - s * az,
                     t * ax * az + s * ay]),
        torch.stack([t * ax * ay + s * az, t * ay * ay + c,
                     t * ay * az - s * ax]),
        torch.stack([t * ax * az - s * ay, t * ay * az + s * ax,
                     t * az * az + c]),
    ])
    one = torch.ones((), dtype=F32, device=x.device)
    lin = torch.stack([torch.stack([one, -gamma, beta]),
                       torch.stack([gamma, one, -alpha]),
                       torch.stack([-beta, alpha, one])])
    return torch.where(small, lin, rod), x[3:6]


def _apply(pts, rot, trans):
    """R p + t per row: fma(z, r_j2, fma(y, r_j1, x * r_j0)) + t_j, the form
    of the JAX package's [N, 3] x [3, 3] product on the CPU."""
    return _matmul3(pts, rot.T) + trans[None, :]


def _icp_loop(src_xyz, src_valid, tgt_xyz, tgt_valid, tgt_normals,
              max_iterations: int, tolerance, max_dist,
              point_to_plane: bool):
    """The ICP loop. Returns f32[16]: rotation (9, row-major), translation
    (3), fitness, rmse, converged, iterations."""
    from .segmentation import _full_fp32_matmul

    dev = src_xyz.device
    src_use = src_valid & torch.isfinite(src_xyz).all(dim=-1)
    tgt_use = tgt_valid & torch.isfinite(tgt_xyz).all(dim=-1)
    n_src = torch.clamp(_sum32(src_valid.to(F32)), min=1.0)
    inf = torch.tensor(torch.inf, device=dev)
    tlo = torch.where(tgt_use[:, None], tgt_xyz, inf).amin(dim=0)
    thi = torch.where(tgt_use[:, None], tgt_xyz, -inf).amax(dim=0)
    center = torch.where(torch.isfinite(tlo), 0.5 * tlo + 0.5 * thi, 0.0)
    current = src_xyz - center
    tgt = tgt_xyz - center
    tol = torch.tensor(np.float32(tolerance), device=dev)
    max_dist = torch.tensor(np.float32(max_dist), device=dev)

    rot = torch.eye(3, dtype=F32, device=dev)
    trans = torch.zeros(3, dtype=F32, device=dev)
    prev_rmse = last_rmse = inf
    last_fitness = torch.zeros((), dtype=F32, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    iterations = 0
    with _full_fp32_matmul():
        while iterations < max_iterations:
            dist, idx, found = _nn_1(current, src_use, tgt, tgt_use)
            w = found & (dist <= max_dist)
            n_corr = _sum32(w.to(F32))
            empty = n_corr == 0.0
            rmse = _sqrt_f32(_sum32(torch.where(w, dist * dist, 0.0))
                             / torch.clamp(n_corr, min=1.0))
            conv = ~empty & ((prev_rmse - rmse).abs() < tol)
            last_rmse = torch.where(empty, last_rmse, rmse)
            last_fitness = torch.where(empty, last_fitness, n_corr / n_src)
            converged = converged | conv
            iterations += 1
            if bool(empty | conv):  # host read: the loop's stop flag
                break
            tgt_pts = tgt[idx]
            if point_to_plane:
                rot_i, trans_i = _plane_solve(current, tgt_pts,
                                              tgt_normals[idx], w)
            else:
                rot_i, trans_i = _svd_rigid_solve(current, tgt_pts, w)
            rot = _matmul3(rot_i, rot)
            trans = _matmul3(rot_i, trans[:, None])[:, 0] + trans_i
            current = _apply(current, rot_i, trans_i)
            prev_rmse = rmse
    # Back to raw coordinates: R (p - C) + t + C = R p + (t + C - R C); the
    # C - R C cancellation is offset-scale, so it runs in float64.
    c64 = center.to(F64)
    trans_raw = (trans.to(F64) + c64 - rot.to(F64) @ c64).to(F32)
    return torch.cat([rot.reshape(9), trans_raw, torch.stack([
        last_fitness, last_rmse, converged.to(F32),
        torch.tensor(float(iterations), device=dev)])])


def _trim(rows, a):
    """Head slice to ``rows``: clouds are leading-compact, so the rows past
    the valid count are padding and the 1-NN pass is quadratic in rows."""
    if a is None or rows is None or rows >= a.shape[0]:
        return a
    return a[:rows]


def icp_point_to_point_packed(src_xyz, src_valid, tgt_xyz, tgt_valid,
                              max_iterations: int, tolerance, max_dist, *,
                              src_rows: int | None = None,
                              tgt_rows: int | None = None):
    """Point-to-point ICP (Horn's solve); f32[16] as `_icp_loop`."""
    return _icp_loop(_trim(src_rows, src_xyz), _trim(src_rows, src_valid),
                     _trim(tgt_rows, tgt_xyz), _trim(tgt_rows, tgt_valid),
                     None, max_iterations, tolerance, max_dist,
                     point_to_plane=False)


def icp_point_to_plane_packed(src_xyz, src_valid, tgt_xyz, tgt_valid,
                              tgt_normals, max_iterations: int, tolerance,
                              max_dist, *, src_rows: int | None = None,
                              tgt_rows: int | None = None):
    """Point-to-plane ICP (6x6 float64 solve); f32[16] as `_icp_loop`."""
    return _icp_loop(_trim(src_rows, src_xyz), _trim(src_rows, src_valid),
                     _trim(tgt_rows, tgt_xyz), _trim(tgt_rows, tgt_valid),
                     _trim(tgt_rows, tgt_normals), max_iterations, tolerance,
                     max_dist, point_to_plane=True)


def _unpack_icp(out):
    """f32[16] -> the JAX package's 6-tuple: rotation f32[3, 3],
    translation f32[3], fitness f32[], rmse f32[], converged bool[],
    iterations i32[]."""
    return (out[:9].reshape(3, 3), out[9:12], out[12], out[13],
            out[14] > 0.5, out[15].to(torch.int32))


def icp_point_to_point_masked(src_xyz, src_valid, tgt_xyz, tgt_valid,
                              max_iterations: int, tolerance, max_dist):
    """Point-to-point ICP on the whole padded clouds (no trim): `_icp_loop`
    unpacked to (rot, trans, fitness, rmse, converged, iterations)."""
    return _unpack_icp(_icp_loop(src_xyz, src_valid, tgt_xyz, tgt_valid,
                                 None, max_iterations, tolerance, max_dist,
                                 point_to_plane=False))


def icp_point_to_plane_masked(src_xyz, src_valid, tgt_xyz, tgt_valid,
                              tgt_normals, max_iterations: int, tolerance,
                              max_dist):
    """Point-to-plane ICP on the whole padded clouds (no trim): `_icp_loop`
    unpacked to (rot, trans, fitness, rmse, converged, iterations)."""
    return _unpack_icp(_icp_loop(src_xyz, src_valid, tgt_xyz, tgt_valid,
                                 tgt_normals, max_iterations, tolerance,
                                 max_dist, point_to_plane=True))
