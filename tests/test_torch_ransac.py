"""RANSAC of the PyTorch port against the JAX package: the same threefry
hypotheses give the same winning plane under the tournament, full scoring
(kernel `ransac_score_counts`) and the sequential adaptive scan."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.core.cloud import compaction_order as jax_compaction_order
from pointclouds_tpu.core.cloud import make_cloud_arrays as jax_make_cloud
from pointclouds_tpu.ops import segmentation as JS
from pointclouds_tpu.ops.registration import _to_planar as _jax_to_planar
from pointclouds_tpu.ops.segmentation import (
    ransac_plane_masked as jax_ransac,
)
from pointclouds_tpu.spatial import pallas_kernels as jpk
from pointclouds_tpu_torch.ops import segmentation as TS
from pointclouds_tpu_torch.ops.registration import _to_planar
from pointclouds_tpu_torch.ops.segmentation import ransac_plane_masked
from pointclouds_tpu_torch.spatial import kernels
from pointclouds_tpu_torch.utils.interop import to_torch

from _hypotheses import assert_same_bits, hypothesis_cloud, position_map

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


def _strip_cloud(seed, n_plane, n_noise, z_noise, size=10.0):
    rng = np.random.default_rng(seed)
    data = np.vstack([
        (rng.random((n_plane, 3)) * [size, size, z_noise]).astype(np.float32),
        (rng.random((n_noise, 3)) * size).astype(np.float32),
    ])
    return jax_make_cloud(data)


@pytest.mark.parametrize("case", ["strip", "edge"])
def test_score_counts_plain_matches_pallas(case):
    """Kernel 5's plain version against the Pallas kernel in interpret mode
    on the explicit hypotheses of tests/test_segmentation.py, pad slots
    included (128 slots); "edge": hypotheses 0-7 each take as threshold the
    pinned distance of a valid point, which then lies exactly on it (and
    counts)."""
    arrs = _strip_cloud(17, 4_000, 1_200, 0.02)
    rng = np.random.default_rng(17)
    rng.random((5_200, 3))  # the cloud's draws, as that test makes them
    normal = rng.standard_normal((64, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    d = rng.standard_normal(64).astype(np.float32)
    hyp = np.zeros((5, 128), np.float32)
    hyp[0, :64], hyp[1, :64], hyp[2, :64] = normal.T
    hyp[3, :64] = d
    hyp[4, :64] = 0.3
    hyp[4, 64:] = -1.0
    use = np.asarray(arrs.valid) & np.isfinite(np.asarray(arrs.xyz)).all(-1)
    if case == "edge":
        p = torch.from_numpy(np.asarray(arrs.xyz)[np.nonzero(use)[0][:8]])
        h = torch.from_numpy(hyp[:, :8])
        hyp[4, :8] = (kernels.fma_f32(p[:, 2], h[2], kernels.fma_f32(
            p[:, 0], h[0], p[:, 1] * h[1])) + h[3]).abs().numpy()
    jplanar = _jax_to_planar(arrs.xyz, jnp.asarray(use))
    want = np.asarray(jpk.ransac_score_counts(jnp.asarray(hyp), jplanar,
                                              interpret=True))
    kernels.reset_launch_counts()
    got = kernels.ransac_score_counts(torch.from_numpy(hyp),
                                      _to_planar(to_torch(arrs.xyz),
                                                 torch.from_numpy(use)))
    assert kernels.LAUNCHES["ransac_score_counts"] == 0  # CPU: plain
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[64:] == 0).all() and want[:64].sum() > 0
    if case == "edge":
        assert (want[:8] >= 1).all()


@pytest.mark.parametrize("seed", [0, 5])
def test_full_scoring_matches_pallas_path(seed):
    """Full scoring (every hypothesis through kernel 5's plain version)
    against the JAX package's kernel path in interpret mode."""
    arrs = _strip_cloud(17, 4_000, 1_200, 0.02)
    jn, jd, jin = jax_ransac(arrs.xyz, arrs.valid, jnp.float32(0.05), seed,
                             300, assume_compact=True, use_kernel=True,
                             interpret=True)
    tn, td, tin = ransac_plane_masked(to_torch(arrs.xyz),
                                      to_torch(arrs.valid), np.float32(0.05),
                                      seed, 300, assume_compact=True)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6)
    assert abs(float(td) - float(jd)) <= 1e-6
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
def test_sequential_scan_matches_jax(seed):
    """The chunked replay of the reference's sequential early termination:
    the same (best_iter, best_count, n_evaluated) as the JAX scan on the
    cases of tests/test_segmentation.py, and the same winning plane."""
    rng = np.random.default_rng(1)
    base = rng.random((4000, 3)).astype(np.float32) * [10, 10, 0]
    base[:, 2] = rng.normal(0, 0.03, 4000).astype(np.float32)
    out = (rng.random((600, 3)) * [10, 10, 4] + [0, 0, 0.5]).astype(
        np.float32)
    arrs = jax_make_cloud(np.vstack([base, out]))
    iters, thr = 500, jnp.float32(0.05)
    cnt = jnp.sum(arrs.valid.astype(jnp.int32))
    samples = JS._sample_three_distinct(jax.random.PRNGKey(seed), iters, cnt)
    order = jax_compaction_order(arrs.valid)
    p = jnp.take(arrs.xyz, jnp.take(order, samples.reshape(-1)),
                 axis=0).reshape(iters, 3, 3)
    nrm = jnp.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    ln = jnp.linalg.norm(nrm, axis=1)
    deg = ln < 1e-10
    normal = nrm / jnp.where(deg, 1.0, ln)[:, None]
    d = -jnp.sum(normal * p[:, 0], axis=1)
    use = jnp.logical_and(arrs.valid, jnp.all(jnp.isfinite(arrs.xyz), -1))
    want = JS._ransac_sequential_scan(arrs.xyz, use, normal, d, deg, thr,
                                      cnt, iters)
    got = TS._ransac_sequential_scan(
        to_torch(arrs.xyz), to_torch(use), to_torch(normal), to_torch(d),
        to_torch(deg), np.float32(0.05), to_torch(cnt), iters)
    assert got == tuple(int(w) for w in want)
    jn, jd, _ = jax_ransac(arrs.xyz, arrs.valid, thr, seed, iters,
                           adaptive=True)
    tn, td, _ = ransac_plane_masked(to_torch(arrs.xyz), to_torch(arrs.valid),
                                    np.float32(0.05), seed, iters,
                                    adaptive=True)
    np.testing.assert_allclose(tn.numpy(), np.asarray(normal[got[0]]),
                               atol=1e-6)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6)
    assert abs(float(td) - float(jd)) <= 1e-6


@pytest.mark.parametrize("n_plane,seed", [(4_000, 2), (10_000, 9)])
def test_adaptive_dispatch_matches_jax(n_plane, seed):
    """``adaptive=True`` on both sides of the 10K dispatch: ~5K valid
    points take the sequential scan, ~12K score every hypothesis."""
    arrs = _strip_cloud(seed, n_plane, n_plane // 5, 0.06, size=20.0)
    n_valid = int(np.asarray(arrs.valid).sum())
    assert (n_valid >= 10_000) == (n_plane == 10_000)
    jn, jd, jin = jax_ransac(arrs.xyz, arrs.valid, jnp.float32(0.05), seed,
                             200, adaptive=True)
    tn, td, tin = ransac_plane_masked(to_torch(arrs.xyz),
                                      to_torch(arrs.valid), np.float32(0.05),
                                      seed, 200, adaptive=True)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6)
    assert abs(float(td) - float(jd)) <= 1e-6
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))


@pytest.mark.parametrize("flag", [False, True])
def test_scoring_leaves_tf32_flag_alone(flag):
    """The matmul scoring scopes TF32 off to itself: the process-wide flag
    is the caller's before and after a call."""
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = flag
        xyz, valid, rows = _cloud(0, 300, 512)
        ransac_plane_masked(torch.from_numpy(xyz), torch.from_numpy(valid),
                            THR, 0, 64, score_subsample=256,
                            position_rows=torch.from_numpy(rows))
        assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@functools.partial(jax.jit, static_argnames=("iterations", "mapping"))
def _jax_hypotheses(xyz, valid, seed, rows, iterations: int, mapping: str):
    """The hypothesis block of the JAX package's `ransac_plane_masked`
    (normal, d, degenerate), jitted as there."""
    cnt = jnp.sum(valid.astype(jnp.int32))
    samples = JS._sample_three_distinct(jax.random.PRNGKey(seed), iterations,
                                        cnt)
    if mapping == "compact":
        idx = samples
    else:
        order = (rows.astype(jnp.int32) if mapping == "rows"
                 else jax_compaction_order(valid))
        idx = jnp.take(order, samples.reshape(-1)).reshape(samples.shape)
    p = jnp.take(xyz, idx.reshape(-1), axis=0).reshape(idx.shape[0], 3, 3)
    nrm = jnp.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    length = jnp.linalg.norm(nrm, axis=1)
    degenerate = length < 1e-10
    normal = nrm / jnp.where(degenerate, 1.0, length)[:, None]
    return normal, -jnp.sum(normal * p[:, 0], axis=1), degenerate


HYPOTHESIS_CASES = [("cnt0", 0, 300), ("cnt1", 1, 300), ("cnt2", 2, 300),
                    ("cnt3", 3, 300), ("full", 4, 300), ("iters1", 5, 1),
                    ("iters500", 2**31 - 1, 500), ("iters4097", 7, 4097),
                    ("degenerate", 8, 500), ("nan", 9, 500)]


@pytest.mark.parametrize("mapping", ["rows", "compact", "compaction"])
@pytest.mark.parametrize("case,seed,iterations", HYPOTHESIS_CASES)
def test_hypotheses_plain_match_jax(case, seed, iterations, mapping):
    """`kernels.ransac_hypotheses` on CPU tensors (its plain version, no
    launch) against the JAX package's hypotheses, bit for bit but the sign
    of a zero offset: valid counts
    0-3 and a full cloud, 1 to 4,097 hypotheses, the three position maps
    (`position_rows`, `assume_compact`, the compaction order), degenerate
    triples and a NaN point."""
    xyz, valid, rows = hypothesis_cloud(case, mapping, seed)
    want = _jax_hypotheses(jnp.asarray(xyz), jnp.asarray(valid), seed,
                           jnp.asarray(rows), iterations, mapping)
    tv = torch.from_numpy(valid)
    order = position_map(mapping, tv, rows)
    kernels.reset_launch_counts()
    got = kernels.ransac_hypotheses(torch.from_numpy(xyz), tv.sum(), seed,
                                    iterations, order)
    assert kernels.LAUNCHES["ransac_hypotheses"] == 0  # CPU: plain
    assert [tuple(g.shape) for g in got] == [(iterations, 3), (iterations,),
                                             (iterations,)]
    for name, g, w in zip(("normal", "d", "degenerate"), got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "d":
            # XLA's sum starts from +0, the pinned form from nx*px, so a
            # zero offset (a degenerate triple, a plane through the origin)
            # may carry the other sign; every use takes |n.p + d|.
            zero = w == 0
            assert (g[zero] == 0).all()
            g, w = g[~zero], w[~zero]
        assert_same_bits(g, w)
    deg = got[2].numpy()
    nan = np.isnan(got[0].numpy()).any(axis=1)
    assert deg.any() == (case == "degenerate")
    assert nan.any() == (case == "nan")
    if case in ("degenerate", "nan"):
        assert (~deg & ~nan).any()
