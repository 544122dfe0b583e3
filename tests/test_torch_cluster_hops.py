"""The port's cluster hop loop on the CPU against the JAX package: kernel 16
(`cluster_propagate`, plain version) against the Pallas kernel in
interpret mode and its XLA mirror; `sweep_cluster_labels` above the
residency gate against the reference's hop loop (`use_kernel=False`); and
`engine.cluster_labels`' ladder above the gate, then its cell-graph rung.

Tolerance: labels and change flags equal; ``exact`` equal.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.ops.segmentation import bruteforce_cluster_labels
from pointclouds_tpu.spatial import engine as jengine
from pointclouds_tpu.spatial.pallas_kernels import cluster_propagate as jprop
from pointclouds_tpu.spatial.sweep import (
    _cluster_propagate_xla,
    sweep_cluster_labels as jax_labels,
)
from pointclouds_tpu_torch.spatial import engine, kernels, sweep
from pointclouds_tpu_torch.spatial.grid import scalar_like
from test_torch_cluster import _exact_r, _frontier, _long_chain


def _blobs(seed: int = 7):
    rng = np.random.default_rng(seed)
    pts = np.vstack([
        rng.normal([0, 0, 0], 0.3, (300, 3)),
        rng.normal([5, 5, 0], 0.4, (400, 3)),
        rng.normal([9, 1, 1], 0.2, (150, 3)),
        rng.random((150, 3)) * 12,
    ]).astype(np.float32)
    xyz = np.zeros((1024, 3), np.float32)
    xyz[:len(pts)] = pts
    valid = np.zeros(1024, bool)
    valid[:len(pts)] = True
    xyz[50] = np.inf
    valid[60] = False
    return xyz, valid, 0.5


def _chain():
    n = 400
    t = np.linspace(0, 30, n)
    xyz = np.zeros((512, 3), np.float32)
    xyz[:n] = np.column_stack([t, np.sin(t), np.zeros(n)])
    valid = np.zeros(512, bool)
    valid[:n] = True
    return xyz, valid, 0.2


def _boundary():
    xyz = np.zeros((256, 3), np.float32)
    xyz[:3] = [[0, 0, 0], [1.0, 0, 0], [2.5, 0, 0]]
    valid = np.zeros(256, bool)
    valid[:3] = True
    return xyz, valid, 1.0


def _georeferenced():
    rng = np.random.default_rng(9)
    pts = np.vstack([rng.normal([2, 0, 0], 0.2, (200, 3)),
                     rng.normal([8, 3, 1], 0.2, (200, 3))]).astype(np.float32)
    xyz = np.zeros((512, 3), np.float32)
    xyz[:400] = pts + np.float32([4.5e5, 1.2e5, 300.0])
    valid = np.zeros(512, bool)
    valid[:400] = True
    return xyz, valid, 1.0


SCENES = {"blobs": _blobs, "chain": _chain, "boundary": _boundary,
          "georeferenced": _georeferenced, "long_chain": _long_chain,
          "exact_r": _exact_r, "frontier": _frontier}


@pytest.mark.parametrize("active", ["set", "cleared"])
def test_cluster_propagate_matches_jax(active):
    xyz, valid, r = _blobs()
    t, v = torch.from_numpy(xyz), torch.from_numpy(valid)
    cell = sweep.cluster_cell_size(scalar_like(np.float32(r), t),
                                   torch.where(v[:, None], t.abs(), 0.0).amax())
    s = sweep._sorted_structure(t, v, cell, 7, sweep.SWEEP_TABLE_SIZE)
    planar, nb, nrows = s["planar"], s["nb"], s["nrows"]
    rng = np.random.default_rng(3)
    lab = np.arange(nrows * 128, dtype=np.int32)
    lower = rng.random(lab.shape) < 0.3
    lab[lower] = (lab[lower] * rng.random(lower.sum())).astype(np.int32)
    act = np.ones(nb, np.int32) if active == "set" else (
        rng.random(nb) < 0.5).astype(np.int32)
    starts = np.concatenate([s["starts_skip"].numpy(), act[:, None]], axis=1)
    r2 = np.float32(r) * np.float32(r)
    p8 = np.concatenate([planar.numpy(), lab.reshape(nrows, 1, 128).astype(
        np.float32), np.full((nrows, 1, 128), r2, np.float32),
        np.zeros((nrows, 2, 128), np.float32)], axis=1)
    tl, tc = kernels.cluster_propagate(planar, torch.from_numpy(lab),
                                       torch.from_numpy(starts), r2)
    for jl, jc in (jprop(jnp.asarray(p8), jnp.asarray(starts), wr=7,
                         interpret=True),
                   _cluster_propagate_xla(jnp.asarray(p8),
                                          jnp.asarray(starts), wr=7)):
        np.testing.assert_array_equal(tl.numpy(),
                                      np.asarray(jl).astype(np.int32))
        np.testing.assert_array_equal(tc.numpy(),
                                      np.asarray(jc).astype(np.int32))
    assert tc.numpy().any()


def _hop_inputs(xyz, valid, r):
    """The port's sorted structure at wr 7, as the hop loop builds it."""
    t, v = torch.from_numpy(xyz), torch.from_numpy(valid)
    cell = sweep.cluster_cell_size(scalar_like(np.float32(r), t),
                                   torch.where(v[:, None], t.abs(), 0.0).amax())
    return sweep._sorted_structure(t, v, cell, 7, sweep.SWEEP_TABLE_SIZE)


def _propagate_vs_jax(planar, lab, starts, r):
    """Kernel 16's plain version against the Pallas kernel (interpret mode)
    and its XLA mirror on the same inputs: labels and flags equal."""
    nrows = planar.shape[0]
    r2 = np.float32(r) * np.float32(r)
    p8 = np.concatenate([planar, lab.reshape(nrows, 1, 128).astype(
        np.float32), np.full((nrows, 1, 128), r2, np.float32),
        np.zeros((nrows, 2, 128), np.float32)], axis=1)
    tl, tc = kernels.cluster_propagate(torch.from_numpy(planar),
                                       torch.from_numpy(lab),
                                       torch.from_numpy(starts), r2)
    for jl, jc in (jprop(jnp.asarray(p8), jnp.asarray(starts), wr=7,
                         interpret=True),
                   _cluster_propagate_xla(jnp.asarray(p8),
                                          jnp.asarray(starts), wr=7)):
        np.testing.assert_array_equal(tl.numpy(),
                                      np.asarray(jl).astype(np.int32))
        np.testing.assert_array_equal(tc.numpy(),
                                      np.asarray(jc).astype(np.int32))
    return tl.numpy(), tc.numpy()


PROPAGATE_SCENES = {"long_chain": _long_chain, "exact_r": _exact_r,
                    "dead_block": _long_chain, "frontier": _frontier}


@pytest.mark.parametrize("scene", sorted(PROPAGATE_SCENES))
def test_cluster_propagate_scenes_match_jax(scene):
    """The hop loop's first hop (own positions) on the new scenes: the long
    chain through 9 blocks; pairs at exactly d2 == r2 (inclusive); the
    chain with block 4's row invalid (a block with no valid query, a
    candidate row of 128 invalid candidates); the blob beside the chain
    with every other block inactive."""
    xyz, valid, r = PROPAGATE_SCENES[scene]()
    s = _hop_inputs(xyz, valid, r)
    planar = s["planar"].numpy().copy()
    nb, nrows = s["nb"], s["nrows"]
    act = np.ones(nb, np.int32)
    if scene == "frontier":
        act[1::2] = 0
    starts = np.concatenate([s["starts_skip"].numpy(), act[:, None]], axis=1)
    if scene == "dead_block":
        assert planar[4, 3].all() and starts[4, 27] != 0
        planar[4, 3] = 0.0
        starts[4, 27] = 0
    lab = np.arange(nrows * 128, dtype=np.int32)
    tl, tc = _propagate_vs_jax(planar, lab, starts, r)
    assert tc.any()
    if scene == "dead_block":  # passed through, unchanged
        assert (tl[512:640] == lab[512:640]).all() and not tc[512:640].any()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_hop_loop_matches_jax(scene, monkeypatch):
    monkeypatch.setattr(sweep, "CLUSTER_RESIDENT_BYTES", 0)
    xyz, valid, r = SCENES[scene]()
    jl, jexact = jax_labels(jnp.asarray(xyz), jnp.asarray(valid),
                            np.float32(r), use_kernel=False, wr=7)
    tl, texact = sweep.sweep_cluster_labels(
        torch.from_numpy(xyz), torch.from_numpy(valid), np.float32(r), wr=7)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert bool(texact) == bool(jexact) and bool(texact)


def _partition(labels, n):
    groups = collections.defaultdict(list)
    for i in range(n):
        groups[int(labels[i])].append(i)
    return sorted(groups.values())


def test_engine_takes_hop_ladder_above_the_gate(monkeypatch):
    """With the gate at 0 bytes the port's ladder is the reference's CPU
    ladder: the hop loop at wr 7 serves the cloud, as the JAX engine."""
    monkeypatch.setattr(sweep, "CLUSTER_RESIDENT_BYTES", 0)
    calls = []
    real = engine.sweep_cluster_labels

    def spy(*a, **kw):
        calls.append(kw["wr"])
        return real(*a, **kw)

    monkeypatch.setattr(engine, "sweep_cluster_labels", spy)
    xyz, valid, r = _blobs()
    got = engine.cluster_labels(torch.from_numpy(xyz),
                                torch.from_numpy(valid), r)
    want = jengine.cluster_labels(jnp.asarray(xyz), jnp.asarray(valid), r)
    assert calls == [7]
    assert _partition(got, 1024) == _partition(want, 1024)


@pytest.mark.parametrize("far", [False, True])
def test_engine_falls_to_cell_graph_rung(monkeypatch, far):
    """Every hop rung flagged: the engine tries wr 7, 14, 28, then the
    cell-graph rung; a cloud whose half-radius cells overflow the table
    goes on to the brute force. Components equal the JAX engine's."""
    monkeypatch.setattr(sweep, "CLUSTER_RESIDENT_BYTES", 0)
    calls, rung = [], []
    real_rung = engine._cell_graph_rung

    def flagged(xyz, valid, r32, *, wr, row_cap, sweeps):
        calls.append((wr, row_cap))
        return torch.arange(xyz.shape[0]), torch.tensor(False)

    def spy_rung(*a):
        out = real_rung(*a)
        rung.append(out is not None)
        return out

    monkeypatch.setattr(engine, "sweep_cluster_labels", flagged)
    monkeypatch.setattr(engine, "_cell_graph_rung", spy_rung)
    xyz, valid, r = _blobs()
    if far:
        xyz[900] = [3e4, 3e4, 3e4]
    got, filtered = engine.cluster_labels(torch.from_numpy(xyz),
                                          torch.from_numpy(valid), r,
                                          size_filter=(1, 10_000))
    want = bruteforce_cluster_labels(jnp.asarray(xyz), jnp.asarray(valid),
                                     jnp.float32(r))
    assert calls == [(7, 16), (14, 16), (28, 16)]
    assert rung == [not far] and filtered is False
    assert _partition(got, 1024) == _partition(want, 1024)
