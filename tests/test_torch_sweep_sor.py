"""SOR sweep of the PyTorch port against the JAX package: the plain
versions of the `sweep_select_rows` / `rescue_select` kernels against the
Pallas kernels in interpret mode on the same JAX-built inputs, and the
two-pass SOR with lower bounds end to end.

Contract: the port selects an exact top-k, so its ``ok`` is always True;
wherever the Pallas kernel reports ok, total, count and kth are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.ops.filters import (
    voxel_downsample_sweep_fused as jax_voxel_fused,
)
from pointclouds_tpu.spatial import pallas_kernels as jpk
from pointclouds_tpu.spatial import sweep as jsweep
from pointclouds_tpu_torch.ops.filters import voxel_downsample_sweep_fused
from pointclouds_tpu_torch.spatial import kernels, sweep
from pointclouds_tpu_torch.utils.interop import to_torch

VOXEL = np.float32(0.4)
FACTOR = 3
K = 20


def _scene(seed=23):
    rng = np.random.default_rng(seed)
    pts = np.vstack([
        (rng.random((4000, 3)) * [25.0, 25.0, 2.0]).astype(np.float32),
        (rng.random((20, 3)) * 30.0 + 30.0).astype(np.float32),  # isolated
        (rng.random((500, 3)) * 0.5 + 10.0).astype(np.float32),  # clump
    ])
    xyz = np.zeros((8192, 3), np.float32)
    xyz[: len(pts)] = pts
    valid = np.zeros(8192, bool)
    valid[: len(pts)] = True
    return xyz, valid


@pytest.fixture(scope="module")
def jax_front():
    xyz, valid = _scene()
    fe = jax_voxel_fused(jnp.asarray(xyz), jnp.asarray(valid), VOXEL,
                         factor=FACTOR, ds_cap=8192)
    prebuilt = jsweep.structure_from_sorted(
        fe["centroids"], fe["out_valid"], fe["slin"], fe["extent"],
        fe["hi_cells"], fe["table_overflow"], wr=4,
        grid_origin=(fe["mn_v"], VOXEL, FACTOR))
    return xyz, valid, fe, prebuilt


def _assert_contract(got, want):
    total, count, kth, ok = (t.numpy() for t in got)
    wt, wc, wk, wok = (np.asarray(a) for a in want)
    assert ok.all()
    assert wok.mean() > 0.5  # the comparison covers most rows
    np.testing.assert_allclose(total[wok], wt[wok], rtol=1e-6)
    np.testing.assert_array_equal(count[wok], wc[wok])
    np.testing.assert_array_equal(kth[wok], wk[wok])


def test_structure_from_sorted_matches_jax(jax_front):
    xyz, valid, fe, prebuilt = jax_front
    tfe = voxel_downsample_sweep_fused(torch.from_numpy(xyz),
                                       torch.from_numpy(valid), VOXEL,
                                       factor=FACTOR, ds_cap=8192)
    s = sweep.structure_from_sorted(
        tfe["centroids"], tfe["out_valid"], tfe["slin"], tfe["extent"],
        tfe["hi_cells"], tfe["table_overflow"], wr=4,
        grid_origin=(tfe["mn_v"], float(VOXEL), FACTOR))
    for key in ("planar", "starts_skip", "block_ok", "slin_p"):
        np.testing.assert_array_equal(s[key].numpy(), np.asarray(prebuilt[key]),
                                      err_msg=key)


@pytest.mark.parametrize("cap", [12, 4])
def test_sweep_select_rows_plain_vs_pallas(jax_front, cap):
    _, _, _, prebuilt = jax_front
    rowlist, fits = jsweep._window_row_lists(prebuilt["starts_skip"], cap,
                                             prebuilt["planar"].shape[0])
    padded = jsweep._planar_padded(prebuilt["planar"])
    want = jpk.sweep_select_rows(padded, rowlist, k=K + 1, cap=cap,
                                 per_seg=2, interpret=True)
    t_rowlist, t_fits = sweep._window_row_lists(
        to_torch(prebuilt["starts_skip"]), cap, prebuilt["planar"].shape[0])
    np.testing.assert_array_equal(t_rowlist.numpy(), np.asarray(rowlist))
    np.testing.assert_array_equal(t_fits.numpy(), np.asarray(fits))
    kernels.reset_launch_counts()
    got = kernels.sweep_select_rows(to_torch(padded), t_rowlist, k=K + 1,
                                    cap=cap)
    assert kernels.LAUNCHES["sweep_select_rows"] == 0
    _assert_contract(got, want)


def test_rescue_select_plain_vs_pallas(jax_front):
    _, _, _, prebuilt = jax_front
    planar = prebuilt["planar"]
    use = planar[:, 3, :].reshape(-1) > 0.5
    rng = np.random.default_rng(5)
    flagged = jnp.logical_and(use, jnp.asarray(rng.random(use.shape) < 0.1))
    prio = jnp.asarray(rng.random(use.shape) < 0.5)
    radius = jnp.float32(8.0) * jnp.float32(VOXEL * FACTOR)
    planar_g, q_planar, active, qvalid, qsel = jsweep._rescue_structure(
        planar, None, flagged, 512, use.shape[0], radius, priority=prio)
    t = sweep._rescue_structure(to_torch(planar), to_torch(flagged), 512,
                                use.shape[0], to_torch(radius),
                                priority=to_torch(prio))
    for g, w in zip(t, (planar_g, q_planar, active, qvalid, qsel)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jpk.rescue_select(planar_g, q_planar, active, k=K + 1, per_seg=5,
                             gr=8, interpret=True)
    kernels.reset_launch_counts()
    got = kernels.rescue_select(t[0], t[1], t[2], k=K + 1, gr=8)
    assert kernels.LAUNCHES["rescue_select"] == 0
    _assert_contract(got, want)


def test_window_starts_dense_table_matches_jax():
    """The dense first-row table branch (more than 2048 query blocks)."""
    rng = np.random.default_rng(3)
    slin = np.sort(rng.integers(0, 5000, 1024)).astype(np.int32)
    slin_p = np.concatenate([slin, np.full(1024, 1 << 21, np.int32)])
    suse_p = slin_p < (1 << 21)
    extent = np.array([10, 20, 25], np.int32)
    lo = np.sort(rng.integers(0, 5000, 2100)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 30, 2100), 4999).astype(np.int32)
    has_valid = rng.random(2100) < 0.9
    want = jsweep._window_starts_from_bounds(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(has_valid),
        jnp.asarray(slin_p), jnp.asarray(suse_p), jnp.asarray(extent), 16, 8,
        4, 1 << 21)
    got = sweep._window_starts_from_bounds(
        *(torch.from_numpy(a) for a in (lo, hi, has_valid, slin_p, suse_p,
                                        extent)), 16, 8, 4, 1 << 21)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _brute_means(cents, valid, k):
    p = cents[valid].astype(np.float64)
    d = np.sqrt(((p[:, None, :] - p[None, :, :]) ** 2).sum(-1))
    d.sort(axis=1)
    out = np.full(len(cents), np.inf)
    out[valid] = d[:, 1:k + 1].mean(axis=1)
    return out


@pytest.mark.parametrize("fix_cap", [1024, 128])
def test_sweep_sor_two_pass_matches_jax(jax_front, fix_cap):
    _, _, fe, prebuilt = jax_front
    cell = np.float32(VOXEL * np.float32(FACTOR))
    jp1 = jsweep._sweep_pass1(fe["centroids"], fe["out_valid"], cell, k=K,
                              wr=4, per_seg=2, use_kernel=True,
                              interpret=True, prebuilt=prebuilt, row_cap=12)
    mean, ok, cert, lb = (np.asarray(a) for a in jsweep.sweep_sor_two_pass(
        fe["centroids"], fe["out_valid"], cell, k=K, fix_cap=fix_cap,
        rescue_cells=8.0, per_seg=2, use_kernel=True, interpret=True,
        prebuilt=prebuilt, row_cap=12, with_lb=True))
    tpre = to_torch(prebuilt)
    tp1 = sweep._sweep_pass1(torch.tensor(cell), k=K, prebuilt=tpre,
                             row_cap=12)
    # Pass-1 certification radius: bitwise.
    np.testing.assert_array_equal(tp1["safe2_s"].numpy(),
                                  np.asarray(jp1["safe2_s"]))
    kernels.reset_launch_counts()
    tmean, tok, tcert, tlb = sweep.sweep_sor_two_pass(
        to_torch(fe["centroids"]), to_torch(fe["out_valid"]), cell, k=K,
        fix_cap=fix_cap, rescue_cells=8.0, prebuilt=tpre, row_cap=12)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    tmean, tok, tlb = tmean.numpy(), tok.numpy(), tlb.numpy()
    assert ok.sum() > 100
    assert (tok | ~ok).all()  # the port certifies a superset
    np.testing.assert_allclose(tmean[ok], mean[ok], rtol=1e-6)
    np.testing.assert_allclose(tlb[ok], lb[ok], rtol=1e-6)
    assert bool(tcert) or not bool(cert)
    # Soundness against an f64 brute-force oracle, for every valid row.
    v = np.asarray(fe["out_valid"])
    truth = _brute_means(np.asarray(fe["centroids"]), v, K)
    np.testing.assert_allclose(tmean[tok], truth[tok], rtol=1e-5)
    assert (tlb[v] <= truth[v] * (1 + 1e-4) + 1e-4).all()
    fin = v & np.isfinite(tmean)
    assert (tmean[fin] >= truth[fin] * (1 - 1e-4) - 1e-4).all()
