"""The PyTorch port's readers and writers against the JAX package's: the
three sample files under `data/` read to equal arrays, the writers produce
the same bytes, and each format round-trips through the port's API.
Everything is compared exactly (the same numpy parsing and formatting)."""

from pathlib import Path

import numpy as np
import pytest

import pointclouds_tpu  # noqa: F401
from pointclouds_tpu import api as japi
from pointclouds_tpu.io import las as jlas
from pointclouds_tpu.io import pcd as jpcd
from pointclouds_tpu.io import ply as jply
from pointclouds_tpu_torch import api
from pointclouds_tpu_torch.io import las, pcd, ply

DATA = Path(__file__).resolve().parents[1] / "data"


@pytest.mark.parametrize("name", ["bunny.pcd", "two_scans.pcd",
                                  "plane_with_noise.pcd"])
def test_sample_files_read_equal(name, monkeypatch):
    got = pcd.read_pcd(str(DATA / name))
    want = jpcd.read_pcd(str(DATA / name))
    assert got.dtype == np.float32 and got.shape == want.shape and len(got)
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(api, "DEFAULT_DEVICE", "cpu")
    cloud = api.read_pcd(str(DATA / name))
    np.testing.assert_array_equal(cloud.to_numpy(), want)


def _cloud_arrays(seed, n=300):
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(n, 3)) * 50).astype(np.float32)
    xyz[0] = [1e-8, -0.0, 3.4e38]
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    return xyz, nrm, rgb


@pytest.mark.parametrize("fmt", ["pcd", "pcd_binary", "ply", "ply_binary"])
def test_writers_match_and_round_trip(tmp_path, fmt, monkeypatch):
    monkeypatch.setattr(api, "DEFAULT_DEVICE", "cpu")
    xyz, nrm, rgb = _cloud_arrays(1)
    got_p, want_p = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
    if fmt.startswith("pcd"):
        write = "write_pcd_binary" if fmt.endswith("binary") else "write_pcd"
        getattr(pcd, write)(str(got_p), xyz)
        getattr(jpcd, write)(str(want_p), xyz)
        back = api.read_pcd(str(got_p))
        assert not back._has_normals
    else:
        write = "write_ply_binary" if fmt.endswith("binary") else "write_ply"
        getattr(ply, write)(str(got_p), xyz, nrm, rgb)
        getattr(jply, write)(str(want_p), xyz, nrm, rgb)
        back = api.read_ply(str(got_p))
        for g, w in zip(ply.read_ply(str(got_p)), jply.read_ply(str(want_p))):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(back._normals_numpy(), nrm)
        np.testing.assert_array_equal(back._colors_numpy(), rgb)
    assert got_p.read_bytes() == want_p.read_bytes()
    np.testing.assert_array_equal(back.to_numpy(), xyz)
    # The API's writer writes the same file as the module's.
    api_p = tmp_path / f"api.{fmt}"
    getattr(api, write)(str(api_p), back)
    assert api_p.read_bytes() == got_p.read_bytes()


def test_las_reads_equal(tmp_path):
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-1e3, 1e3, (500, 3))
    inten = rng.integers(0, 60000, 500)
    path = tmp_path / "a.las"
    jlas.write_las(str(path), xyz, inten)
    for want, got in zip(jlas.read_las(str(path)), las.read_las(str(path))):
        np.testing.assert_array_equal(got, want)
    zero = tmp_path / "zero.las"
    jlas.write_las(str(zero), xyz)
    assert las.read_las(str(zero))[1] is None  # no intensity attached


def test_api_readers_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(api, "DEFAULT_DEVICE", "cpu")
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-10, 10, (50, 3))
    jlas.write_las(str(tmp_path / "b.las"), xyz, rng.integers(1, 9, 50))
    got = api.read_las(str(tmp_path / "b.las"))
    want = japi.read_las(str(tmp_path / "b.las"))
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    np.testing.assert_array_equal(got._intensity_numpy(),
                                  want._intensity_numpy())
    assert got.device.type == "cpu"
    for fn in (api.read_pcd, api.read_ply, api.read_las):
        with pytest.raises(IOError):
            fn(str(tmp_path / "missing"))
    bad = tmp_path / "bad.pcd"
    bad.write_bytes(b"VERSION 0.7\nPOINTS 2\nDATA binary\n\x00")
    with pytest.raises(IOError):
        api.read_pcd(str(bad))
