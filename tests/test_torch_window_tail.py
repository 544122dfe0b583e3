"""The same-cloud window pack's padded last block (`spatial/sweep.py::
_window_starts`): the one block that holds valid rows and sentinel padding.

The reference bounds that block's windows by its last row's cell, the
sentinel, so they run to the last valid row of the cloud; on a cloud whose
last x-column holds more than ``wr`` rows the reference flags the block
(``block_ok`` False, ``exact`` False). The port ends those windows at the
block's last valid cell where the sentinel-bounded ones fail: the block is
certified, every other block's pack and ``block_ok`` are the reference's
bit for bit, and the labels are the reference's and the brute force's.
Above the residency gate the hop loop takes every window whole, so a full
block whose windows overflow ``wr`` is certified there too.

The CPU cases import JAX inside their helpers; the one `cuda` case, the
pack on the card against the CPU's with every synchronisation raising, runs
without it, from the repository root:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_window_tail.py -m cuda
"""

import numpy as np
import pytest
import torch

from pointclouds_tpu_torch.spatial import sweep
from pointclouds_tpu_torch.utils import profiling

TABLE = sweep.SWEEP_TABLE_SIZE
R = np.float32(1.0)


def _jax():
    import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
    from pointclouds_tpu.spatial import sweep as jsweep

    return jsweep


def _cells(dense: bool):
    """Sorted cell ids and the extent of a grid with one cell in z. Dense:
    [2, 40] cells, column 0 with 39 rows in every cell, column 1, the last,
    with 80 in every other cell: 3,160 valid rows (3,160 % 128 = 88). The
    control: [3, 20] cells with 15 rows each, so that a whole column and the
    end of the one before fit four rows of 128: 900 valid rows. Padded to a
    whole block with the sentinel."""
    if dense:
        slin = np.concatenate([np.repeat(np.arange(40), 39),
                               np.repeat(np.arange(40, 80, 2), 80)])
        extent = [2, 40, 1]
    else:
        slin, extent = np.repeat(np.arange(60), 15), [3, 20, 1]
    n = -(-slin.size // 128) * 128
    slin_p = np.concatenate([slin, np.full(n - slin.size, TABLE)])
    return slin_p.astype(np.int32), np.array(extent, np.int32)


def _packs(dense, wr):
    jsweep = _jax()
    import jax.numpy as jnp

    slin_p, extent = _cells(dense)
    nb = slin_p.size // 128
    nrows = max(nb, wr)  # the wr padding, as the structures add it
    slin_p = np.concatenate([slin_p, np.full((nrows - nb) * 128, TABLE,
                                             np.int32)])
    suse_p = slin_p < TABLE
    want = [np.asarray(a) for a in jsweep._window_starts(
        jnp.asarray(slin_p), jnp.asarray(suse_p), jnp.asarray(extent), nrows,
        nb, wr, TABLE)]
    got = [a.numpy() for a in sweep._window_starts(
        torch.from_numpy(slin_p), torch.from_numpy(suse_p),
        torch.from_numpy(extent), nrows, nb, wr, TABLE)]
    return want, got, int(suse_p.sum())


@pytest.mark.parametrize("wr", [4, 7, 12])
def test_padded_block_certified_others_bitwise(wr):
    (jpack, jok), (tpack, tok), n_use = _packs(True, wr)
    tail = (n_use - 1) // 128
    assert n_use % 128 != 0
    # The reference flags the padded block alone; the port certifies it.
    assert np.flatnonzero(~jok).tolist() == [tail]
    assert tok.all()
    others = np.arange(len(jok)) != tail
    np.testing.assert_array_equal(tpack[others], jpack[others])
    # Its windows start where the reference's do and are no longer.
    np.testing.assert_array_equal(tpack[tail, :9], jpack[tail, :9])
    assert (tpack[tail, 18:27] <= jpack[tail, 18:27]).all()
    assert (tpack[tail, 18:27] < jpack[tail, 18:27]).any()
    assert tpack[tail, 27] == jpack[tail, 27] == 1


@pytest.mark.parametrize("wr", [4, 7, 12])
def test_padded_block_that_fits_is_the_reference(wr):
    """The control: a padded block whose sentinel-bounded windows fit; the
    pack and ``block_ok`` are the reference's bit for bit."""
    (jpack, jok), (tpack, tok), _ = _packs(False, wr)
    assert jok.all()
    np.testing.assert_array_equal(tpack, jpack)
    np.testing.assert_array_equal(tok, jok)


def _cloud():
    """Points in the dense cells of `_cells` (cluster radius 1, cells of ~1 m):
    column 0 a thin strip, column 1 clumps 1.1 m apart and more than r from
    column 0, each clump a component of its own. Six rows invalid, two of
    them non-finite."""
    rng = np.random.default_rng(11)
    parts = [np.column_stack([rng.uniform(0.05, 0.3, 39 * 40),
                              np.repeat(np.arange(40), 39)
                              + rng.uniform(0.05, 0.95, 39 * 40),
                              rng.uniform(0.0, 0.9, 39 * 40)])]
    for y in range(0, 40, 2):
        parts.append(np.column_stack([
            rng.uniform(1.5, 1.95, 80),
            rng.uniform(y + 0.05, y + 0.95, 80),
            rng.uniform(0.0, 0.9, 80)]))
    pts = np.vstack(parts).astype(np.float32)
    pts = pts[rng.permutation(len(pts))]
    xyz = np.concatenate([pts, rng.uniform(0, 2, (6, 3))]).astype(np.float32)
    valid = np.arange(len(xyz)) < len(pts)
    xyz[-2:] = np.nan
    valid[-1] = True  # valid but not finite: never served
    return xyz, valid


def _brute_labels(xyz, valid):
    """Each point's smallest row among the points within R of it,
    transitively (float64 distances); invalid points keep their own."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    use = valid & np.isfinite(xyz).all(axis=1)
    rows = np.flatnonzero(use)
    p = xyz[rows].astype(np.float64)
    near = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1) <= float(R) ** 2
    _, comp = connected_components(csr_matrix(near), directed=False)
    first = np.full(comp.max() + 1, len(xyz))
    np.minimum.at(first, comp, rows)
    out = np.arange(len(xyz))
    out[rows] = first[comp]
    return out


@pytest.mark.parametrize("branch", ["windows", "hop_loop"])
def test_cluster_labels_on_padded_tail(branch, monkeypatch):
    """`sweep_cluster_labels` on the dense cloud: the reference's run
    flags it (its padded block overflows), the port's is exact; the labels
    are the reference's and the brute force's, in the windows branch and in
    the hop loop above the residency gate."""
    jsweep = _jax()
    import jax.numpy as jnp

    xyz, valid = _cloud()
    if branch == "windows":
        jkw = dict(wr=12, row_cap=None, sweeps=12, use_kernel=True,
                   interpret=True)
        tkw = dict(wr=12, row_cap=None, sweeps=12)
    else:
        monkeypatch.setattr(sweep, "CLUSTER_RESIDENT_BYTES", 0)
        jkw = dict(wr=7, use_kernel=False)
        tkw = dict(wr=7)
    want, jexact = jsweep.sweep_cluster_labels(
        jnp.asarray(xyz), jnp.asarray(valid), R, **jkw)
    got, texact = sweep.sweep_cluster_labels(
        torch.from_numpy(xyz), torch.from_numpy(valid), R, **tkw)
    assert not bool(jexact) and bool(texact)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    brute = _brute_labels(xyz, valid)
    np.testing.assert_array_equal(got.numpy(), brute)
    assert len(np.unique(brute[valid])) > 20  # the clumps apart


def _sparse_beside_dense():
    """One full block of 128 points strung one to every other cell along y
    (x in cell 0: alternately 0.02, alone, and 0.95, within R of the
    column beside it), beside a dense column of 3,072 points (x in cell 1):
    the block's windows into that column take 24 rows or more. 3,200 rows,
    no padded block."""
    rng = np.random.default_rng(5)
    j = np.arange(128)
    sparse = np.column_stack([np.where(j % 2, 0.95, 0.02), 2.0 * j + 0.5,
                              np.full(128, 0.5)])
    dense = np.column_stack([rng.uniform(1.05, 1.95, 3072),
                             rng.uniform(0.0, 256.0, 3072),
                             rng.uniform(0.0, 0.9, 3072)])
    xyz = np.vstack([sparse, dense]).astype(np.float32)
    xyz = xyz[rng.permutation(len(xyz))]
    return xyz, np.ones(len(xyz), bool)


def test_hop_loop_takes_overflowing_windows_whole(monkeypatch):
    """A full block whose windows overflow ``wr``: the reference flags it
    in the hop loop, and the port's windows branch below the gate, whose
    pack is the reference's, does too. The port's hop loop takes the
    windows whole: exact, the brute force's labels, and every other
    block's pack as the capped one has it."""
    jsweep = _jax()
    import jax.numpy as jnp

    xyz, valid = _sparse_beside_dense()
    x, v = torch.from_numpy(xyz), torch.from_numpy(valid)
    _, jexact = jsweep.sweep_cluster_labels(
        jnp.asarray(xyz), jnp.asarray(valid), R, wr=7, use_kernel=False)
    _, wexact = sweep.sweep_cluster_labels(x, v, R, wr=7, row_cap=None)
    assert not bool(jexact) and not bool(wexact)
    monkeypatch.setattr(sweep, "CLUSTER_RESIDENT_BYTES", 0)
    got, texact = sweep.sweep_cluster_labels(x, v, R, wr=7)
    assert bool(texact)
    brute = _brute_labels(xyz, valid)
    np.testing.assert_array_equal(got.numpy(), brute)
    assert 60 < len(np.unique(brute)) < 70  # the lone half apart

    cell = torch.tensor(np.float32(1.0))
    capped = sweep._sorted_structure(x, v, cell, 7, TABLE)
    whole = sweep._sorted_structure(x, v, cell, 7, TABLE, capped["nrows"])
    assert capped["nb"] == 25 and not capped["block_ok"][0]
    assert capped["block_ok"][1:].all() and whole["block_ok"].all()
    cp, wp = capped["starts_skip"], whole["starts_skip"]
    assert int(wp[0, 18:27].max()) >= 24  # the dense column, whole
    # Only the flagged block's lengths grow (and its skips, which follow
    # them); its starts are the capped pack's.
    assert torch.equal(wp[1:], cp[1:]) and torch.equal(wp[0, :9], cp[0, :9])
    assert (wp[0, 18:27] >= cp[0, 18:27]).all() and wp[0, 27] == cp[0, 27]


def test_normals_certified_on_padded_tail():
    """`sweep_knn_moments_rows` (wr 4) on the dense cloud: the reference
    leaves every row of the padded block uncertified, the port certifies
    them, with the counts and moments of the reference at a window budget
    that fits (wr 16); elsewhere the port certifies the reference's rows."""
    jsweep = _jax()
    import jax.numpy as jnp

    xyz, valid = _cloud()
    cell = np.float32(1.0)
    jx, jv = jnp.asarray(xyz), jnp.asarray(valid)
    want = [np.asarray(a) for a in jsweep.sweep_knn_moments_rows(
        jx, jv, cell, k=15, use_kernel=False)]
    wide = [np.asarray(a) for a in jsweep.sweep_knn_moments_rows(
        jx, jv, cell, k=15, wr=16, use_kernel=False)]
    got = [a.numpy() for a in sweep.sweep_knn_moments_rows(
        torch.from_numpy(xyz), torch.from_numpy(valid), cell, k=15)]
    s = sweep._sorted_structure(torch.from_numpy(xyz),
                                torch.from_numpy(valid), torch.tensor(cell),
                                4, TABLE)
    n_use = int(s["suse_p"].sum())
    tail = s["order"][(n_use - 1) // 128 * 128: n_use].numpy()
    jok, wok, tok = want[3], wide[3], got[3]
    assert not jok[tail].any()
    assert wok[tail].mean() > 0.9 and tok[tail].mean() > 0.9
    assert not (jok & ~tok).any()
    both = np.zeros_like(tok)
    both[tail] = tok[tail] & wok[tail]
    both |= jok
    ref = [np.where(jok, w, v) for w, v in zip(want[:3], wide[:3])]
    np.testing.assert_array_equal(got[2][both], ref[2][both])
    for g, w in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g[..., both], w[..., both], rtol=1e-5,
                                   atol=1e-5 * 15)


def test_hop_loop_update_span_once_a_hop(monkeypatch):
    """Traced, the hop loop times each hop's update after kernel 16 in one
    ``cluster.hop.update`` span: as many as the hops it counts."""
    monkeypatch.setattr(sweep, "CLUSTER_RESIDENT_BYTES", 0)
    xyz, valid = _cloud()
    profiling.set_tracing(True)
    try:
        with profiling.frame("probe") as rec:
            sweep.sweep_cluster_labels(torch.from_numpy(xyz),
                                       torch.from_numpy(valid), R, wr=7)
    finally:
        profiling.set_tracing(False)
    hops = rec.count("cluster.rounds")
    assert hops >= 2
    assert sum(s.name == "cluster.hop.update" for s in rec.spans) == hops
    assert rec.host_ms("cluster.hop.update") > 0


@pytest.mark.cuda
def test_card_padded_block_pack_matches_cpu():
    """The dense tail's pack built on the card with every synchronisation
    raising (`torch.cuda.set_sync_debug_mode("error")`): equal to the
    CPU's, the padded block certified, no host read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    slin_p, extent = _cells(True)
    slin = torch.from_numpy(slin_p)
    xyz = torch.rand((slin.numel(), 3), generator=torch.Generator()
                     .manual_seed(3))
    inputs = (xyz, slin < TABLE, slin, torch.from_numpy(extent),
              torch.tensor(1.0), torch.tensor(False))

    def build(args):
        return sweep.structure_from_sorted(*args, 7)

    want = build(inputs)
    card = [a.cuda() for a in inputs]
    build(card)
    torch.cuda.synchronize()
    calls = []
    real = profiling.host_read
    profiling.host_read = lambda site: calls.append(site) or real(site)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = build(card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        profiling.host_read = real
    torch.cuda.synchronize()
    for key in ("starts_skip", "block_ok"):
        assert torch.equal(got[key].cpu(), want[key]), key
    assert want["block_ok"].all()
    assert not calls


@pytest.mark.cuda
def test_card_hop_loop_whole_windows_match_cpu(monkeypatch):
    """Kernel 16 walks the whole windows of 24 rows and more on the card:
    labels and ``exact`` equal to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    monkeypatch.setattr(sweep, "CLUSTER_RESIDENT_BYTES", 0)
    xyz, valid = _sparse_beside_dense()
    x, v = torch.from_numpy(xyz), torch.from_numpy(valid)
    want, wexact = sweep.sweep_cluster_labels(x, v, R, wr=7)
    got, gexact = sweep.sweep_cluster_labels(x.cuda(), v.cuda(), R, wr=7)
    assert bool(wexact) and bool(gexact)
    assert torch.equal(got.cpu(), want)
