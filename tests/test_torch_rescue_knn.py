"""The group-pruned exact kNN rescue of the PyTorch port against the JAX
package: the plain version of the `rescue_knn_idx` kernel against the
Pallas kernel in interpret mode and its XLA mirror, and
`sweep_moments_two_pass_rows` end to end.

Distances and counts are equal (the same pinned d2, exact selection).
Positions equal the mirror's everywhere (both take the smaller position
at equal distances) and the Pallas kernel's where the distances are not
tied: there its order depends on its lane segments. The lattice cases
put points on a 1 m grid, so duplicates and equal distances tie at the
kth; they pin the tie order that the CUDA kernel must reproduce.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.spatial import pallas_kernels as jpk
from pointclouds_tpu.spatial import sweep as jsweep
from pointclouds_tpu_torch.spatial import kernels, sweep
from pointclouds_tpu_torch.utils.interop import to_torch


def _cloud(seed, n, lattice=False):
    rng = np.random.default_rng(seed)
    xyz = np.vstack([rng.uniform(0, 10, (n - n // 8, 3)),
                     rng.uniform(0, 40, (n // 8, 3))]).astype(np.float32)
    if lattice:
        xyz = np.round(xyz).astype(np.float32)
    valid = rng.random(n) > 0.05
    xyz[~valid & (rng.random(n) > 0.5)] = np.nan
    xyz[7] = xyz[8]  # an exact duplicate: a tie at some kth
    return xyz, valid


def _rescue_inputs(xyz, valid, k, cell):
    s = jsweep._sorted_structure(jnp.asarray(xyz), jnp.asarray(valid),
                                 np.float32(cell), 4, jsweep.SWEEP_TABLE_SIZE)
    _, _, _, ok = jsweep._moments_pass1(s, np.float32(cell), k=k, wr=4,
                                        per_seg=3, interpret=False,
                                        use_kernel=False)
    flagged = jnp.logical_and(s["use"], jnp.logical_not(ok))
    return jsweep._rescue_structure(s["planar"], s["order"], flagged, 512,
                                    xyz.shape[0], 4.0 * np.float32(cell))


@pytest.mark.parametrize("n,k,cell,lattice", [
    (3000, 15, 0.8, False), (2000, 6, 1.0, False), (2000, 10, 1.0, True),
    (2000, 1, 1.0, True), (2000, 32, 1.0, False)])
def test_rescue_knn_plain_matches_pallas_and_mirror(n, k, cell, lattice):
    """k 32 is the most the port's kernels take."""
    xyz, valid = _cloud(n, n, lattice)
    planar_g, q_planar, active, qvalid, _ = _rescue_inputs(xyz, valid, k,
                                                           cell)
    assert int(np.asarray(qvalid).sum()) > 128  # rows to rescue
    pal = np.asarray(jpk.rescue_knn_idx(planar_g, q_planar, active, k=k,
                                        per_seg=4, gr=8, interpret=True))
    mir = np.asarray(jsweep._rescue_knn_xla(planar_g, q_planar, active, k=k,
                                            gr=8))
    kernels.reset_launch_counts()
    got = kernels.rescue_knn_idx(to_torch(planar_g), to_torch(q_planar),
                                 to_torch(active), k=k, gr=8).numpy()
    assert kernels.LAUNCHES["rescue_knn_idx"] == 0  # CPU: plain
    assert (got[2 * k + 2] == 1.0).all()
    # Rows whose k + 1 nearest distances all differ (the mirror's; a
    # missing one is no tie): there no order among equal distances enters.
    mir1 = np.asarray(jsweep._rescue_knn_xla(planar_g, q_planar, active,
                                             k=k + 1, gr=8))[:k + 1]
    with np.errstate(invalid="ignore"):  # inf - inf past the count
        distinct = (np.diff(mir1, axis=0) != 0).all(axis=0)
    for want in (pal, mir):
        cert = want[2 * k + 2] > 0.5
        assert cert.mean() > 0.9
        np.testing.assert_array_equal(got[:k, cert], want[:k, cert])
        np.testing.assert_array_equal(got[2 * k:2 * k + 2, cert],
                                      want[2 * k:2 * k + 2, cert])
        if lattice:  # ties at the kth: compared where the k + 1 differ
            assert (cert & ~distinct).mean() > 0.1
            untied = cert & distinct
        else:  # where the k distances differ
            d = got[:k]
            untied = cert & np.isfinite(d).all(axis=0)
            with np.errstate(invalid="ignore"):
                untied &= (np.diff(d, axis=0) != 0).all(axis=0)
            assert untied.mean() > 0.5
        np.testing.assert_array_equal(got[k:2 * k, untied],
                                      want[k:2 * k, untied])
    # Ties go to the smaller position in the port and the mirror alike.
    cert = mir[2 * k + 2] > 0.5
    np.testing.assert_array_equal(got[k:2 * k, cert], mir[k:2 * k, cert])
    # The positions name the candidates at the reported distances.
    pos = got[k:2 * k]
    found = pos >= 0
    gx = np.asarray(planar_g)[:, :3, :].transpose(1, 0, 2).reshape(3, -1)
    qx = np.asarray(q_planar)[:, :3, :].transpose(1, 0, 2).reshape(3, -1)
    p = pos.astype(np.int64)
    cand = gx[:, np.where(found, p, 0)]  # [3, k, Q]
    dist = np.sqrt(((cand - qx[:, None, :]).astype(np.float64) ** 2).sum(0))
    np.testing.assert_allclose(dist[found], got[:k][found], rtol=1e-6,
                               atol=1e-6)


def test_moments_two_pass_rows_matches_jax():
    xyz, valid = _cloud(5, 3000)
    k, cell = 15, np.float32(0.8)
    want = [np.asarray(a) for a in jsweep.sweep_moments_two_pass_rows(
        jnp.asarray(xyz), jnp.asarray(valid), cell, k=k, fix_cap=1024,
        use_kernel=False)]
    got = [a.numpy() for a in sweep.sweep_moments_two_pass_rows(
        torch.from_numpy(xyz), torch.from_numpy(valid), cell, k=k,
        fix_cap=1024)]
    one = [np.asarray(a) for a in jsweep.sweep_knn_moments_rows(
        jnp.asarray(xyz), jnp.asarray(valid), cell, k=k, use_kernel=False)]
    jok, tok = want[3], got[3]
    assert jok.sum() > one[3].sum()  # the rescue certified more rows
    assert not (jok & ~tok).any()
    np.testing.assert_array_equal(got[2][jok], want[2][jok])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g[:, jok], w[:, jok], rtol=1e-5,
                                   atol=1e-5 * float(cell) ** 2 * k)
