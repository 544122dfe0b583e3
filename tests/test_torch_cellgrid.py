"""The port's cell grid (`pointclouds_tpu_torch/spatial/cellgrid.py`) and
kernels 17 (`sor_select`) and 18 (`segmented_select`) on the CPU against
the JAX package: the XLA paths, and the Pallas kernels in interpret mode.

Tolerance: bitwise. Grid fields, cell-centric means and adjacency are
equal; where the reference's segment certificate certifies a row, the
port's exact selection returns the same bits, and the port's ``ok`` is a
superset of the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.core.cloud import make_cloud_arrays as jax_cloud
from pointclouds_tpu.spatial import cellgrid as jcg
from pointclouds_tpu.spatial.pallas_kernels import segmented_select as jseg
import pointclouds_tpu_torch as port
from pointclouds_tpu_torch.spatial import cellgrid as tcg
from pointclouds_tpu_torch.spatial import kernels
from pointclouds_tpu_torch.utils.interop import to_torch


def _scene(seed: int, n: int = 1500, box: float = 5.0, extra=()):
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3)) * box - box / 2).astype(np.float32)
    if extra:
        pts = np.vstack([pts, np.asarray(extra, np.float32)])
    return pts


def _both(data):
    a = jax_cloud(data)
    return a, port.make_cloud_arrays(data, device="cpu")


def _grids(data, cell, **kw):
    a, t = _both(data)
    jg = jcg.build_cellgrid(a.xyz, a.valid, jnp.float32(cell), **kw)
    tg = tcg.build_cellgrid(t.xyz, t.valid, np.float32(cell), **kw)
    return a, t, jg, tg


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


GRID_CASES = {
    "ring1": (dict(seed=0), 0.9, dict(m_per_cell=32, cell_cap=2048)),
    "ring2": (dict(seed=1), 0.4, dict(m_per_cell=16, cell_cap=4096, ring=2)),
    "nonfinite": (dict(seed=2, n=300, extra=[[np.nan, 0, 0], [np.inf, 1, 1],
                                             [60, 60, 60]]),
                  1.0, dict(m_per_cell=8, cell_cap=2048)),
    "overflow": (dict(seed=3, n=800, box=1.0), 0.5,
                 dict(m_per_cell=16, cell_cap=2048)),
    "table_overflow": (dict(seed=4, n=50, extra=[[5000, 5000, 5000]]), 0.01,
                       dict(m_per_cell=8, cell_cap=2048)),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_build_cellgrid_fields_match_jax(case):
    scene, cell, kw = GRID_CASES[case]
    _, _, jg, tg = _grids(_scene(**scene), cell, **kw)
    for name in jcg.CellGrid._fields:
        j, t = np.asarray(getattr(jg, name)), getattr(tg, name).numpy()
        assert j.dtype == t.dtype and j.shape == t.shape, name
        np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=name)
    if case == "overflow":
        assert bool(tg.overflow)
    if case == "table_overflow":
        assert bool(tg.table_overflow)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_cell_sor_mean_dists_matches_jax(backend):
    """The chunked branch against JAX's; kernel 17's plain version against
    the Pallas kernel in interpret mode (its own d2 form)."""
    data = _scene(12, 800, 4.0, extra=[[np.nan, 0, 0], [50, 50, 50]])
    _, _, jg, tg = _grids(data, 0.8, m_per_cell=32, cell_cap=2048)
    jb = "xla" if backend == "xla" else "pallas_interpret"
    jm, jok, jcert = jcg.cell_sor_mean_dists(jg, k=7, chunk=256, backend=jb)
    tm, tok, tcert = tcg.cell_sor_mean_dists(tg, k=7, chunk=256,
                                             backend=backend)
    np.testing.assert_array_equal(_bits(tm.numpy()), _bits(jm))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert bool(tcert) == bool(jcert)


def test_sor_select_matches_pallas_interpret():
    """Kernel 17's outputs (total, count, kth) bitwise, on the gathered
    slabs of a grid with empty and partial cells."""
    from pointclouds_tpu.spatial.pallas_kernels import sor_select as jsel

    data = _scene(13, 600, 4.0)
    _, _, jg, tg = _grids(data, 0.7, m_per_cell=16, cell_cap=2048)
    nb_xyz, nb_mask, _ = jcg.gather_neighbor_blocks(jg, jg.neighbor_slots)
    cap = jg.cell_xyz.shape[0]
    q = jnp.transpose(jg.cell_xyz, (0, 2, 1))
    cand = nb_xyz.reshape(cap, -1, 3)
    cv = nb_mask.reshape(cap, -1)
    jt, jc, jk = jsel(q, jg.cell_mask, cand, cv, k=5, interpret=True)
    tt, tc, tk = kernels.sor_select(*(to_torch(x) for x in (q, jg.cell_mask,
                                                            cand, cv)), k=5)
    assert tc.dtype == kernels.torch.int32
    for t, j in ((tt, jt), (tc, jc), (tk, jk)):
        np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))


def _sor_case(case, rng, c=12, m=8):
    """Kernel 17's inputs [C, 3, M], [C, M], [C, 27 M, 3], [C, 27 M]:
    every slot valid ("dense"); valid queries with fewer than k + 1 valid
    candidates ("few"); coordinates on a 0.5 lattice, so that d2 ties at
    the kth value ("ties"); random masks ("random", also at k 31); a few
    valid slots at the front of each neighbour block ("sparse", the KITTI
    frame's ~4%)."""
    ncand = 27 * m
    q = (rng.random((c, 3, m)) * 2.0).astype(np.float32)
    cand = (rng.random((c, ncand, 3)) * 2.0).astype(np.float32)
    qm = rng.random((c, m)) < 0.7
    cv = rng.random((c, ncand)) < 0.5
    if case == "dense":
        cv[:] = True
    if case == "few":
        cv = np.arange(ncand) < rng.integers(0, 5, (c, 1))
    if case == "ties":
        q, cand = np.round(q * 2.0) / 2.0, np.round(cand * 2.0) / 2.0
    if case == "sparse":
        fill = rng.integers(0, 3, (c, 27))
        cv = np.arange(ncand) % m < np.repeat(fill, m, 1)
    qm[-2:] = False  # cells with no valid query
    return q, qm, cand, cv


@pytest.mark.parametrize("case,k", [("dense", 5), ("few", 5), ("ties", 6),
                                    ("random", 31), ("sparse", 4)])
def test_sor_select_cases_match_pallas_interpret(case, k):
    """Kernel 17 (plain version) bitwise against the Pallas kernel in
    interpret mode on the inputs the compacting kernel must get right."""
    from pointclouds_tpu.spatial.pallas_kernels import sor_select as jsel

    args = _sor_case(case, np.random.default_rng(len(case) + k))
    jt, jc, jk = jsel(*(jnp.asarray(a) for a in args), k=k, interpret=True)
    tt, tc, tk = kernels.sor_select(*(to_torch(a) for a in args), k=k)
    assert tc.dtype == kernels.torch.int32
    if case == "few":
        assert (np.asarray(jc)[args[1]] < k + 1).any()
    if case == "dense":
        assert (np.asarray(jc)[args[1]] == k + 1).all()
    for t, j in ((tt, jt), (tc, jc), (tk, jk)):
        np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))


def test_point_sor_mean_dists_matches_jax():
    data = _scene(21, 1500, 5.0, extra=[[np.nan, 0, 0], [80, 80, 80]])
    a, t, jg, tg = _grids(data, 0.9, m_per_cell=32, cell_cap=2048)
    jm, jok, jcert = jcg.point_sor_mean_dists(jg, a.xyz, a.valid, k=9,
                                              qchunk=512)
    tm, tok, tcert = tcg.point_sor_mean_dists(tg, t.xyz, t.valid, k=9,
                                              qchunk=512)
    jok = np.asarray(jok)
    tok = tok.numpy()
    assert jok.sum() > 0.9 * len(data)
    assert not (jok & ~tok).any()  # the port certifies a superset
    np.testing.assert_array_equal(_bits(tm.numpy())[jok], _bits(jm)[jok])
    assert bool(tcert) or not bool(jcert)


@pytest.mark.parametrize("k", [21, 11, 32])
def test_segmented_select_matches_pallas_interpret(k):
    """Kernel 18 (plain version) against the Pallas kernel in interpret
    mode on a [512, 1536] work array: equal where the reference's segment
    certificate holds (and it holds on most rows, the tied ones too);
    ``ok`` everywhere."""
    rng = np.random.default_rng(5)
    work = (rng.random((512, 1536)) * 9.0).astype(np.float32)
    work[rng.random(work.shape) < 0.3] = np.inf
    work[:, 1512:] = np.inf  # 27 * 56 candidates padded to 1536
    # Rows 0-15 hold 12 of their smallest values in one segment (column
    # j % 128): the reference's certificate fails there.
    work[:16, ::128] = np.float32(0.01) * rng.random((16, 12))
    work[16:24] = np.inf  # no candidate
    work[24:28] = 0.5  # every value tied
    work[28:32] = np.round(work[28:32] * 2.0) / 2.0  # ties on a 0.5 lattice
    jt, jc, jk, jok = (np.asarray(x) for x in jseg(jnp.asarray(work), k=k,
                                                  interpret=True))
    tt, tc, tk, tok = kernels.segmented_select(to_torch(work), k=k)
    assert tok.numpy().all()
    assert not jok[:16].any() and jok.sum() > 400 and jok[24:32].all()
    assert (jc[24:32] == k).all()
    for t, j in ((tt, jt), (tc, jc), (tk, jk)):
        np.testing.assert_array_equal(_bits(t.numpy())[jok], _bits(j)[jok])


def test_cell_knn_subset_matches_jax():
    data = _scene(31, 2000, 12.0)
    a, t, jg, tg = _grids(data, 2.4, m_per_cell=64, cell_cap=2048)
    rows = np.arange(0, 2000, 5, dtype=np.int32)
    qvalid = np.ones(len(rows), bool)
    qvalid[::7] = False
    jm, jok = jcg.cell_knn_subset(jg, a.xyz[rows], jnp.asarray(rows),
                                  jnp.asarray(qvalid), k=20)
    tm, tok = tcg.cell_knn_subset(tg, t.xyz[rows], to_torch(rows),
                                  to_torch(qvalid), k=20)
    jok, tok = np.asarray(jok), tok.numpy()
    assert jok.sum() > 0.5 * len(rows)
    assert not (jok & ~tok).any()
    np.testing.assert_array_equal(_bits(tm.numpy())[jok], _bits(jm)[jok])


@pytest.mark.parametrize("seed,radius", [(5, 0.5), (6, 0.31)])
def test_cell_graph_adjacency_and_labels_match_jax(seed, radius):
    data = _scene(seed, 400, 3.0, extra=[[np.nan, 0, 0], [np.inf, 1, 1]])
    _, _, jg, tg = _grids(data, radius / 2, m_per_cell=32, cell_cap=2048,
                          ring=2)
    jadj = jcg.cell_graph_adjacency(jg, jnp.float32(radius))
    tadj = tcg.cell_graph_adjacency(tg, np.float32(radius))
    np.testing.assert_array_equal(tadj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(tcg.cell_graph_labels(tg, tadj).numpy(),
                                  np.asarray(jcg.cell_graph_labels(jg, jadj)))
