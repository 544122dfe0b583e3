"""Single-query radius search, the cell-graph radius blocks with their label
propagation, and the masked AABB of the PyTorch port against the JAX
package on the CPU: `knn.radius_within_mask`, `engine.radius_indices`,
`cellgrid.cell_radius_neighbor_blocks`, `cellgrid.cell_propagate_labels`
and `core.cloud.aabb`.

Tolerance: exact everywhere. Masks, indices, candidate blocks and labels
are equal (labels also to a float64 brute-force component labelling);
AABB corners are bitwise equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.core import cloud as jcloud
from pointclouds_tpu.core.cloud import make_cloud_arrays as jax_cloud
from pointclouds_tpu.spatial import cellgrid as jcg
from pointclouds_tpu.spatial import engine as jengine
from pointclouds_tpu.spatial import knn as jknn
import pointclouds_tpu_torch as port
from pointclouds_tpu_torch.core import cloud as tcloud
from pointclouds_tpu_torch.spatial import cellgrid as tcg
from pointclouds_tpu_torch.spatial import engine as tengine
from pointclouds_tpu_torch.spatial import knn as tknn


def _lattice(n_side, step):
    g = np.arange(n_side, dtype=np.float32) * np.float32(step)
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


# ── radius_within_mask / radius_indices ─────────────────────────────────────


def _radius_cloud():
    """A 0.25 m lattice (exact in f32: lattice neighbours lie at exactly
    d2 == r2 for r 0.5) with some rows invalid or non-finite."""
    xyz = _lattice(10, 0.25)
    rng = np.random.default_rng(7)
    valid = rng.random(len(xyz)) > 0.1
    xyz[rng.random(len(xyz)) < 0.02] = np.nan
    xyz[3, 1] = np.inf
    return xyz, valid


QUERIES = {
    "on_lattice": [1.0, 1.0, 1.0],
    "half_shift": [1.125, 1.125, 1.125],
    "corner": [0.0, 0.0, 0.0],
    "off_axis": [0.3, 0.4, 0.05],
    "far": [50.0, 50.0, 50.0],
    "nan": [np.nan, 0.0, 0.0],
}


@pytest.mark.parametrize("radius", [np.float32(0.5), 0.5, np.float32(0.3)])
@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_radius_within_mask_matches_jax(qname, radius):
    xyz, valid = _radius_cloud()
    q = np.asarray(QUERIES[qname], np.float32)
    want = np.asarray(jknn.radius_within_mask(
        jnp.asarray(xyz), jnp.asarray(valid), jnp.asarray(q), radius))
    got = tknn.radius_within_mask(torch.from_numpy(xyz),
                                  torch.from_numpy(valid),
                                  torch.from_numpy(q), radius).numpy()
    np.testing.assert_array_equal(got, want)
    if qname == "on_lattice" and radius == 0.5:
        d2 = ((xyz - q) ** 2).sum(axis=1)
        assert (got & (d2 == np.float32(0.25))).sum() >= 4  # on the radius
    if qname in ("far", "nan"):
        assert not got.any()

    jidx = jengine.radius_indices(jnp.asarray(xyz), jnp.asarray(valid), q,
                                  float(radius))
    tidx = tengine.radius_indices(torch.from_numpy(xyz),
                                  torch.from_numpy(valid), q, float(radius))
    np.testing.assert_array_equal(tidx, jidx)
    assert (np.diff(tidx) > 0).all()


# ── cell_radius_neighbor_blocks / cell_propagate_labels ─────────────────────


def _components(data, valid, r):
    """Float64 brute-force component labels: the smallest row of each
    component; invalid or non-finite rows their own."""
    n = len(data)
    use = valid & np.isfinite(data).all(axis=1)
    d = np.linalg.norm(data[:, None].astype(np.float64)
                       - data[None, :].astype(np.float64), axis=2)
    adj = (d <= r) & use[:, None] & use[None, :]
    labels = np.arange(n)
    seen = ~use
    for i in range(n):
        if seen[i]:
            continue
        stack, comp = [i], [i]
        seen[i] = True
        while stack:
            u = stack.pop()
            for v in np.nonzero(adj[u] & ~seen)[0]:
                seen[v] = True
                stack.append(v)
                comp.append(v)
        labels[comp] = min(comp)
    return labels


def _cluster_case(case):
    rng = np.random.default_rng(case)
    if case == 4:  # a 0.5 m lattice at r 0.5: every edge at d2 == r2
        data = _lattice(6, 0.5)[::2].copy()
        data[::7] += np.float32(0.01)
        valid = np.ones(len(data), bool)
        valid[5] = False
        data[11] = np.nan
        return data, valid, np.float32(0.5)
    n = int(rng.integers(50, 400))
    data = (rng.random((n, 3)) * 3).astype(np.float32)
    return data, np.ones(n, bool), np.float32(rng.uniform(0.25, 0.7))


@pytest.mark.parametrize("case", range(5))
def test_cell_radius_labels_match_jax(case):
    data, valid, r = _cluster_case(case)
    n = len(data)
    cell = np.float32(r * 1.0001 + 1e-5)
    kw = dict(m_per_cell=16, cell_cap=2048)
    a = jax_cloud(data)
    t = port.make_cloud_arrays(data, device="cpu")
    jvalid = a.valid.at[:n].set(jnp.asarray(valid))
    tvalid = t.valid.clone()
    tvalid[:n] = torch.from_numpy(valid)
    jg = jcg.build_cellgrid(a.xyz, jvalid, jnp.float32(cell), **kw)
    tg = tcg.build_cellgrid(t.xyz, tvalid, cell, **kw)
    assert not bool(tg.overflow) and not bool(tg.table_overflow)

    jnb, jwithin = jcg.cell_radius_neighbor_blocks(jg, jnp.float32(r))
    tnb, twithin = tcg.cell_radius_neighbor_blocks(tg, r)
    np.testing.assert_array_equal(tnb.numpy(), np.asarray(jnb))
    np.testing.assert_array_equal(twithin.numpy(), np.asarray(jwithin))

    jlab = np.asarray(jcg.cell_propagate_labels(jg, jnb, jwithin))
    tlab = tcg.cell_propagate_labels(tg, tnb, twithin).numpy()
    assert tlab.dtype == np.int32
    np.testing.assert_array_equal(tlab, jlab)
    np.testing.assert_array_equal(tlab[:n], _components(data, valid, r))
    np.testing.assert_array_equal(tlab[n:], np.arange(n, len(tlab)))


# ── aabb ────────────────────────────────────────────────────────────────────


def _aabb_case(name):
    rng = np.random.default_rng(3)
    xyz = (rng.normal(size=(300, 3)) * 40).astype(np.float32)
    valid = rng.random(300) > 0.2
    if name == "nonfinite":
        xyz[::9, 0] = np.nan
        xyz[4] = [np.inf, -np.inf, 1e30]
        xyz[5] = [-1e30, 0.0, 0.0]
    elif name == "all_invalid":
        valid[:] = False
    elif name == "all_nonfinite":
        xyz[:, 2] = np.nan
    return xyz, valid


@pytest.mark.parametrize("name", ["plain", "nonfinite", "all_invalid",
                                  "all_nonfinite"])
def test_aabb_matches_jax(name):
    xyz, valid = _aabb_case(name)
    want = [np.asarray(v) for v in jcloud.aabb(jnp.asarray(xyz),
                                                jnp.asarray(valid))]
    got = [v.numpy() for v in tcloud.aabb(torch.from_numpy(xyz),
                                          torch.from_numpy(valid))]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert bool(got[2]) == name.startswith("all")
