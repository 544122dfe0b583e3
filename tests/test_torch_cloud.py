"""The PyTorch port's cloud tensors and `PointCloud` against the JAX package:
padding, the masked primitives (`compact` is the same stable compaction,
with every attribute riding along), the rigid transform, the `PointCloud`
methods and their exceptions, and where clouds are made: on the card
unless the caller asks for the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu.api as japi
from pointclouds_tpu.core import cloud as jcloud
from pointclouds_tpu_torch import api
from pointclouds_tpu_torch.core import cloud


def _attrs(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.integers(0, 256, (n, 3)).astype(np.uint8),
            rng.random(n).astype(np.float32))


def _both(seed=0, n=300):
    xyz, nrm, col, inten = _attrs(seed, n)
    j = jcloud.make_cloud_arrays(xyz, nrm, col, inten)
    t = cloud.make_cloud_arrays(xyz, device="cpu", normals=nrm, colors=col,
                                intensity=inten)
    return j, t


def _assert_same_cloud(t, j):
    for name in ("xyz", "valid", "normals", "colors", "intensity"):
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


def test_make_cloud_arrays_with_attributes_matches_jax():
    j, t = _both()
    assert t.capacity == j.capacity == 512
    _assert_same_cloud(t, j)


def test_default_device_is_the_card():
    """Clouds go to the card unless the caller names a device. Without
    one that is an error, never a silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    pts = np.zeros((5, 3), np.float32)
    assert cloud.DEFAULT_DEVICE == api.DEFAULT_DEVICE == "cuda"
    for make in (lambda: cloud.make_cloud_arrays(pts),
                 lambda: api.PointCloud.from_numpy(pts), api.PointCloud):
        with pytest.raises((AssertionError, RuntimeError)):
            make()


def test_masked_primitives_match_jax():
    j, t = _both(1)
    keep = np.random.default_rng(1).random(j.capacity) > 0.4
    jm = jcloud.mask_cloud(j, jnp.asarray(keep))
    tm = cloud.mask_cloud(t, torch.from_numpy(keep))
    _assert_same_cloud(tm, jm)
    _assert_same_cloud(cloud.compact(tm), jcloud.compact(jm))
    assert int(cloud.count(tm)) == int(jcloud.count(jm))
    idx = np.random.default_rng(2).integers(-5, 600, 64).astype(np.int32)
    sub_valid = np.arange(64) < 50
    _assert_same_cloud(
        cloud.gather_cloud(t, torch.from_numpy(idx),
                           torch.from_numpy(sub_valid)),
        jcloud.gather_cloud(j, jnp.asarray(idx), jnp.asarray(sub_valid)))


def test_apply_rigid_matches_jax():
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-100, 100, (4000, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    rot = q.astype(np.float32)
    t = rng.normal(size=3).astype(np.float32) * 10
    # Jitted, as the JAX API runs it (a lone dot compiles differently).
    want = np.asarray(jax.jit(jcloud.apply_rigid)(
        jnp.asarray(xyz), jnp.asarray(rot), jnp.asarray(t)))
    got = cloud.apply_rigid(torch.from_numpy(xyz), torch.from_numpy(rot),
                            torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, want)


def _pc(pts):
    return (japi.PointCloud.from_numpy(pts),
            api.PointCloud.from_numpy(pts, device="cpu"))


def test_point_cloud_methods_match_jax():
    pts = np.random.default_rng(4).normal(size=(100, 3)).astype(np.float32)
    j, t = _pc(pts)
    assert t.device == torch.device("cpu")
    assert (t.len(), len(t), t.is_empty(), repr(t)) == (
        j.len(), len(j), j.is_empty(), repr(j))
    np.testing.assert_array_equal(t.to_numpy(), j.to_numpy())
    for idx in ([3, 1, 99, 3], [], range(0, 100, 7)):
        for name in ("select", "select_inverse"):
            a, b = getattr(t, name)(idx), getattr(j, name)(idx)
            assert a.len() == b.len() and a.device == t.device
            np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
    for bad in ([100], [-1]):
        with pytest.raises(IndexError, match="out of bounds"):
            t.select(bad)
        with pytest.raises(IndexError, match="out of bounds"):
            j.select(bad)
    assert t._normals_numpy() is None and t._colors_numpy() is None
    assert t._intensity_numpy() is None and not t._has_normals


@pytest.mark.parametrize("bad,exc", [
    (np.zeros((4, 3), np.int32), TypeError),
    ([[0.0, 0.0, 0.0]], TypeError),
    (np.zeros(3, np.float32), ValueError),
    (np.zeros((4, 2), np.float32), ValueError),
    (np.asfortranarray(np.zeros((4, 3), np.float32)), ValueError),
])
def test_from_numpy_rejects_like_jax(bad, exc):
    for mod in (japi, api):
        with pytest.raises(exc):
            mod.PointCloud.from_numpy(bad)


def test_empty_point_cloud_on_cpu():
    e = api.PointCloud(device="cpu")
    assert e.len() == 0 and e.is_empty() and e.to_numpy().shape == (0, 3)
    assert repr(e) == repr(japi.PointCloud()) == "PointCloud(n=0)"
