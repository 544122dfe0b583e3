"""SOR over the nine windows (no row cap) in the PyTorch port against the JAX
package: the plain version of the `sweep_select` kernel against the Pallas
kernel in interpret mode and its XLA mirror; `sweep_sor_two_pass` in its
general form (sorting here, windows pass 1, no lower bounds); and
`engine.sor_means`, the exact fallback of the fused SOR.

The port selects an exact top-k, so its ``ok`` is always true; wherever
the JAX kernel certifies a query the total, count and kth are bitwise
equal. Means are compared where both packages certified the row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.spatial import engine as jengine
from pointclouds_tpu.spatial import pallas_kernels as jpk
from pointclouds_tpu.spatial import sweep as jsweep
from pointclouds_tpu_torch.spatial import engine, kernels, sweep
from pointclouds_tpu_torch.utils.interop import to_torch


def _cloud(seed, n):
    rng = np.random.default_rng(seed)
    xyz = np.vstack([rng.uniform(0, 10, (n - n // 20, 3)),
                     rng.uniform(-15, 25, (n // 20, 3))]).astype(np.float32)
    valid = rng.random(n) > 0.05
    xyz[~valid & (rng.random(n) > 0.5)] = np.nan
    xyz[5] = xyz[6]  # a duplicate: a zero distance besides self
    return xyz, valid


@pytest.mark.parametrize("k,wr", [(11, 4), (21, 6)])
def test_sweep_select_plain_matches_pallas_and_mirror(k, wr):
    xyz, valid = _cloud(k, 3000)
    s = jsweep._sorted_structure(jnp.asarray(xyz), jnp.asarray(valid),
                                 np.float32(0.9), wr, jsweep.SWEEP_TABLE_SIZE)
    planar, starts = s["planar"], s["starts_skip"]
    kernels.reset_launch_counts()
    got = [a.numpy() for a in kernels.sweep_select(
        to_torch(planar), to_torch(starts), k=k)]
    assert kernels.LAUNCHES["sweep_select"] == 0  # CPU: plain
    assert got[3].all()
    pal = [np.asarray(a) for a in jpk.sweep_select(
        planar, starts, k=k, wr=wr, per_seg=4, interpret=True)]
    mir = [np.asarray(a) for a in jsweep._sweep_select_xla(
        planar, starts, k=k, wr=wr, per_seg=4)]
    for want in (pal, mir):
        ok = want[3].astype(bool)
        assert ok.mean() > 0.9
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g[ok], np.asarray(w)[ok])


@pytest.mark.parametrize("fix_cap", [4096, 128])
def test_sweep_sor_two_pass_general_matches_jax(fix_cap):
    """prebuilt=None, with_lb=False, row_cap=None: the JAX package's CPU
    path (XLA mirrors, wr 4) against the port's (plain kernels, wr 4)."""
    xyz, valid = _cloud(1, 4000)
    cell, k = np.float32(1.0), 10
    want = [np.asarray(a) for a in jsweep.sweep_sor_two_pass(
        jnp.asarray(xyz), jnp.asarray(valid), cell, k=k, fix_cap=fix_cap,
        use_kernel=False)]
    got = sweep.sweep_sor_two_pass(torch.from_numpy(xyz),
                                   torch.from_numpy(valid), cell, k=k,
                                   fix_cap=fix_cap)
    assert len(got) == 3
    mean, ok, cert = (a.numpy() for a in got)
    jmean, jok, jcert = want
    assert not (jok & ~ok).any()  # the port certifies a superset
    both = jok & ok
    assert both.sum() > 2800
    np.testing.assert_array_equal(mean[both], jmean[both])
    assert bool(cert) or not bool(jcert)
    if fix_cap == 128:
        assert not bool(cert)  # the rescue overflowed


def test_sor_means_matches_jax():
    xyz, valid = _cloud(2, 5000)
    want = np.asarray(jengine.sor_means(jnp.asarray(xyz), jnp.asarray(valid),
                                        10))
    kernels.reset_launch_counts()
    got = engine.sor_means(torch.from_numpy(xyz), torch.from_numpy(valid),
                           10).numpy()
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    # Exact means; paths that certify a row differently may round their
    # last ulp differently (the brute force's d2 form differs from the
    # sweep's).
    np.testing.assert_allclose(got[fin], want[fin], rtol=3e-7)
