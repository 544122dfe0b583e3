"""The PyTorch port's host C++ (`pointclouds_tpu_torch/native/`) against
its numpy paths and the JAX package on the CPU: the host cell index
(`knn`, `knn_batch`, `radius`; the CPython extension and the ctypes
handle) against the numpy `HostCellIndex` and the JAX package's native
index, the cluster epilogue against the numpy epilogue, the readers'
C++ bodies against the numpy readers, `core.view` against the JAX
package's, and the build's failure rule.

Everything is compared exactly (the port's index takes its float64
distances in numpy's order with no FMA contraction; the epilogue and the
readers are integer and parse work), except the JAX package's own index's
distances, which its -march=native build may move by an ulp: rtol 4e-16.
"""

from pathlib import Path

import numpy as np
import pytest

import pointclouds_tpu  # noqa: F401
from pointclouds_tpu import core as jcore
from pointclouds_tpu import native as jnative
from pointclouds_tpu.io import las as jlas
from pointclouds_tpu.io import pcd as jpcd
from pointclouds_tpu_torch import api, core, native
from pointclouds_tpu_torch.io import las, pcd
from pointclouds_tpu_torch.spatial.hostindex import HostCellIndex

DATA = Path(__file__).resolve().parents[1] / "data"
REPO = Path(__file__).resolve().parents[1]


def _points(seed, n=4000, box=10.0):
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3)) * box).astype(np.float32)
    pts[17] = np.nan
    pts[40] = pts[41]  # a tie
    valid = np.ones(n, bool)
    valid[23] = False
    queries = np.vstack([pts[rng.integers(0, n, 30)] + 0.003, pts[40:42],
                         (rng.random((10, 3)) * box * 1.4 - 0.2 * box)
                         ]).astype(np.float32)
    return pts, valid, queries


def test_native_builds_here_and_outside_the_jax_package():
    assert native.available()
    assert native.index_kind() == "_pcquery"
    lib = Path(native._load_index()._name)
    assert lib.parent == REPO / "build" / "native"
    assert lib.name.startswith("libpcindex_")


def _numpy_index(monkeypatch, pts, valid):
    with monkeypatch.context() as m:
        m.setattr(native, "create_index", lambda *a: None)
        return HostCellIndex(pts, valid)


@pytest.mark.parametrize("seed,box", [(0, 10.0), (1, 0.5), (2, 300.0)])
def test_index_matches_numpy_and_jax(seed, box, monkeypatch):
    pts, valid, queries = _points(seed, box=box)
    ext = HostCellIndex(pts, valid)
    assert type(ext._native) is native.ExtCellIndex
    lib = native._load_index()
    ctypes_ix = native.NativeCellIndex(lib, lib.pcidx_build(
        pts.ctypes.data_as(native._P),
        np.ascontiguousarray(valid, np.uint8).ctypes.data_as(native._P),
        len(pts)))
    plain = _numpy_index(monkeypatch, pts, valid)
    assert plain._native is None
    jax_ix = jnative.create_index(pts, valid)
    assert jax_ix is not None
    assert ext.n_valid == plain.n_valid == ctypes_ix.nvalid() == len(pts) - 2
    r = 0.04 * box
    for q in queries:
        want_rows, want_d = plain.knn(q, 9)
        for ix in (ext, ctypes_ix, jax_ix):
            rows, d = ix.knn(q, 9)
            np.testing.assert_array_equal(rows, want_rows)
            _same_dists(d, want_d, ix is jax_ix)
            np.testing.assert_array_equal(ix.radius(q, r), plain.radius(q, r))
    for ix in (ext._native, ctypes_ix, jax_ix):
        rows, d, cnt = ix.knn_batch(queries, 9)
        assert (cnt == 9).all()
        for i, q in enumerate(queries):
            want_rows, want_d = plain.knn(q, 9)
            np.testing.assert_array_equal(rows[i], want_rows)
            _same_dists(d[i], want_d, ix is jax_ix)


def _same_dists(got, want, jax_build):
    """Bitwise; the JAX package builds its C++ with -march=native, whose
    FMA contraction may move a float64 distance by an ulp."""
    if jax_build:
        np.testing.assert_allclose(got, want, rtol=4e-16, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_api_small_batch_knn_one_c_call(monkeypatch):
    """`knn` of at most 128 finite queries makes one `knn_batch` call and
    equals the numpy index's per-query answers."""
    pts, _, queries = _points(3)
    pts = pts[np.isfinite(pts).all(axis=1)]
    cloud = api.PointCloud.from_numpy(pts, device="cpu")
    calls = []
    orig = native.ExtCellIndex.knn_batch

    def spy(self, qs, k):
        calls.append(len(qs))
        return orig(self, qs, k)

    monkeypatch.setattr(native.ExtCellIndex, "knn_batch", spy)
    idx, dist = api.knn(cloud, queries, 7)
    assert calls == [len(queries)]
    plain = _numpy_index(monkeypatch, pts, np.ones(len(pts), bool))
    for i, q in enumerate(queries):
        rows, d = plain.knn(q, 7)
        np.testing.assert_array_equal(idx[i], rows)
        np.testing.assert_array_equal(dist[i], d.astype(np.float32))
    bad = queries.copy()
    bad[2] = np.nan  # a non-finite query: the per-query path, no results
    idx, dist = api.knn(cloud, bad, 7)
    assert (idx[2] == -1).all() and np.isinf(dist[2]).all()
    assert calls == [len(queries)]


def _numpy_epilogue(labels, lo, hi):
    order = np.argsort(labels, kind="stable")
    sl = labels[order]
    starts = np.nonzero(np.r_[True, sl[1:] != sl[:-1]])[0]
    ends = np.r_[starts[1:], len(sl)]
    out = [order[a:b].tolist() for a, b in zip(starts, ends)
           if lo <= b - a <= hi]
    out.sort(key=lambda c: (-len(c), c))
    return out


@pytest.mark.parametrize("n,lo,hi", [(1, 1, 10), (50, 1, 50),
                                     (3000, 2, 300), (5000, 1, 4),
                                     (5000, 3, 5000)])
def test_cluster_epilogue_matches_numpy(n, lo, hi):
    rng = np.random.default_rng(n + lo)
    groups = rng.integers(0, max(n // 7, 1), n)
    _, first = np.unique(groups, return_index=True)
    labels = first[np.searchsorted(np.unique(groups), groups)].astype(
        np.int32)
    order, starts = native.cluster_epilogue(labels, lo, hi)
    got = [order[s:e].tolist() for s, e in zip(starts[:-1], starts[1:])]
    assert got == _numpy_epilogue(labels, lo, hi)


def test_euclidean_cluster_epilogue_paths_agree(monkeypatch):
    rng = np.random.default_rng(5)
    pts = np.vstack([c + rng.normal(0, 0.3, (150, 3)) for c in
                     rng.uniform(0, 20, (8, 3))]).astype(np.float32)
    cloud = api.PointCloud.from_numpy(pts, device="cpu")
    got = api.euclidean_cluster(cloud, 0.5, 3, 400)
    monkeypatch.setattr(native, "cluster_epilogue", lambda *a: None)
    assert api.euclidean_cluster(cloud, 0.5, 3, 400) == got
    assert len(got) > 3


@pytest.mark.parametrize("name", ["bunny.pcd", "two_scans.pcd",
                                  "plane_with_noise.pcd"])
def test_ascii_pcd_parser_matches_numpy(name, monkeypatch):
    raw = (DATA / name).read_bytes()
    body = raw[pcd._parse_header(raw)[3]:]
    fast = native.parse_ascii_xyz(body, body.count(b"\n") + 1)
    want = jpcd.read_pcd(str(DATA / name))
    np.testing.assert_array_equal(fast, want)
    monkeypatch.setattr(native, "parse_ascii_xyz", lambda *a: None)
    np.testing.assert_array_equal(pcd.read_pcd(str(DATA / name)), want)


def test_ascii_parser_edge_lines():
    text = (b"1 2 3\n# comment\n\n  4.5\t-6e2 7 extra\n8 9\nx 1 2\n"
            b"1e-3 2.5e+1 -0.0\r\n3.4028235e38 1e-45 0.1")
    got = native.parse_ascii_xyz(text, text.count(b"\n") + 1)
    want = np.array([[1, 2, 3], [4.5, -600, 7], [0, 1, 2],
                     [1e-3, 25, -0.0], [3.4028235e38, 1e-45, 0.1]],
                    np.float32)
    np.testing.assert_array_equal(got, want)


def test_binary_pcd_and_las_match_numpy(tmp_path, monkeypatch):
    rng = np.random.default_rng(9)
    xyz = (rng.normal(size=(3000, 3)) * 40).astype(np.float32)
    pcd.write_pcd_binary(str(tmp_path / "a.pcd"), xyz)
    np.testing.assert_array_equal(pcd.read_pcd(str(tmp_path / "a.pcd")), xyz)
    raw = (tmp_path / "a.pcd").read_bytes()
    body = raw[pcd._parse_header(raw)[3]:]
    np.testing.assert_array_equal(
        native.gather_xyz_f32(body, 3000, 12, 8, 4, 0), xyz[:, ::-1])
    inten = rng.integers(0, 900, 3000)
    jlas.write_las(str(tmp_path / "a.las"), xyz, inten)
    jlas.write_las(str(tmp_path / "z.las"), xyz)
    got = [las.read_las(str(tmp_path / f)) for f in ("a.las", "z.las")]
    monkeypatch.setattr(native, "decode_las", lambda *a: None)
    monkeypatch.setattr(native, "gather_xyz_f32", lambda *a: None)
    plain = [las.read_las(str(tmp_path / f)) for f in ("a.las", "z.las")]
    want = [jlas.read_las(str(tmp_path / f)) for f in ("a.las", "z.las")]
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(p[0], w[0])
        assert (g[1] is None) == (p[1] is None) == (w[1] is None)
        if w[1] is not None:
            np.testing.assert_array_equal(g[1], w[1])
            np.testing.assert_array_equal(p[1], w[1])
    np.testing.assert_array_equal(pcd.read_pcd(str(tmp_path / "a.pcd")), xyz)


def test_core_view_matches_jax():
    buf = np.arange(12, dtype=np.float32)
    got, want = core.CloudView(buf, 4), jcore.CloudView(buf, 4)
    assert len(got) == len(want) == 4 and not got.is_empty()
    assert list(got.iter_points()) == list(want.iter_points())
    assert np.shares_memory(got.as_array(), buf)
    np.testing.assert_array_equal(got.as_array(), want.as_array())
    with pytest.raises(ValueError):
        core.CloudView(buf, 5)
    with pytest.raises(IndexError):
        got.point(4)
    recs = [(core.PointXYZ(1, 2, 3), jcore.PointXYZ(1, 2, 3)),
            (core.PointXYZRGB(1, 2, 3, 4, 5, 6),
             jcore.PointXYZRGB(1, 2, 3, 4, 5, 6)),
            (core.PointXYZI(1, 2, 3, 0.5), jcore.PointXYZI(1, 2, 3, 0.5)),
            (core.PointXYZNormal(1, 2, 3, 0, 0, 1),
             jcore.PointXYZNormal(1, 2, 3, 0, 0, 1))]
    for g, w in recs:
        assert g.position() == w.position()
        for proto in ("HasPosition", "HasColor", "HasNormal",
                      "HasIntensity"):
            assert (isinstance(g, getattr(core, proto))
                    == isinstance(w, getattr(jcore, proto)))
    for name in ("CloudView", "HasColor", "HasIntensity", "HasNormal",
                 "HasPosition", "PointXYZ", "PointXYZI", "PointXYZNormal",
                 "PointXYZRGB"):
        assert getattr(core, name).__name__ == getattr(jcore, name).__name__


def test_failed_build_raises_and_no_compiler_gives_none(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ["-DPC_BROKEN=1", "-include",
                                            "no_such_header.h"])
    with pytest.raises(RuntimeError, match="no_such_header"):
        native._build("libpcio", [])
    assert not list(tmp_path.iterdir())  # no half-written library
    monkeypatch.setattr(native, "_compiler", lambda: None)
    assert native._build("libpcio", []) is None
