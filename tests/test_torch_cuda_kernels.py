"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU with nvcc (the kernels build at first use)
and skip without one. They import no JAX, so they also run where JAX is
not installed; from the repository root:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from pointclouds_tpu_torch.pipelines.scenes import kitti_scene
from pointclouds_tpu_torch.spatial import kernels, sweep

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _planar(rng, nr, frac_valid=0.9, scale=5.0):
    p = rng.random((nr, 4, 128)).astype(np.float32) * scale
    p[:, 3] = rng.random((nr, 128)) < frac_valid
    p[:, :3] *= p[:, 3:4]
    return torch.from_numpy(p)


@pytest.mark.parametrize("n", [128, 640, 2 * 512 * 128 + 384])
def test_segmented_scan_sums(dev, n):
    rng = np.random.default_rng(n)
    first = (rng.random(n) < 0.3).astype(np.float32)
    first[0] = 1.0
    vals = [rng.normal(size=n).astype(np.float32) for _ in range(3)]
    vals[0][rng.random(n) < 0.05] = -0.0
    args = [torch.from_numpy(a).to(dev) for a in
            (first, *vals, np.ones(n, np.float32))]
    got = kernels.segmented_scan_sums(*args)
    want = kernels.segmented_scan_sums_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("k", [1, 11, 21, 32])
def test_sweep_select_rows(dev, k):
    rng = np.random.default_rng(k)
    nb, cap = 40, 12
    pts = torch.cat([_planar(rng, nb), torch.zeros((1, 4, 128))]).to(dev)
    pts[nb, :3] = 1e9
    n_rows = rng.integers(0, cap + 1, nb)
    rows = rng.integers(0, nb, (nb, cap))
    rows[np.arange(cap)[None, :] >= n_rows[:, None]] = nb
    rl = np.concatenate([rows, (rng.random((nb, 1)) < 0.9),
                         n_rows[:, None]], axis=1).astype(np.int32)
    rl = torch.from_numpy(rl).to(dev)
    before = kernels.LAUNCHES["sweep_select_rows"]
    got = kernels.sweep_select_rows(pts, rl, k=k, cap=cap)
    assert kernels.LAUNCHES["sweep_select_rows"] == before + 1
    want = kernels.sweep_select_rows_plain(pts, rl, k=k, cap=cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_rescue_select(dev):
    rng = np.random.default_rng(0)
    nr, qb, gr = 64, 5, 8
    cand = _planar(rng, nr).to(dev)
    q = _planar(rng, qb).to(dev)
    q[qb - 1, 3] = 0.0  # an all-invalid block
    ng = nr // gr
    act = np.full((qb, 1 + ng), 12345, np.int32)  # garbage past the count
    for b in range(qb):
        g = np.sort(rng.choice(ng, rng.integers(0, ng + 1), replace=False))
        act[b, 0] = len(g)
        act[b, 1:1 + len(g)] = g
    act = torch.from_numpy(act).to(dev)
    got = kernels.rescue_select(cand, q, act, k=21, gr=gr)
    want = kernels.rescue_select_plain(cand, q, act, k=21, gr=gr)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_sweep_cluster_labels_gpu_equals_cpu(dev):
    data = kitti_scene(seed=5, scale=0.05)
    xyz = np.zeros((4096, 3), np.float32)
    xyz[: len(data)] = data
    valid = np.zeros(4096, bool)
    valid[: len(data)] = True
    args = dict(wr=12, row_cap=32)
    lab_c, ex_c = sweep.sweep_cluster_labels(
        torch.from_numpy(xyz), torch.from_numpy(valid), np.float32(0.8),
        **args)
    lab_g, ex_g = sweep.sweep_cluster_labels(
        torch.from_numpy(xyz).to(dev), torch.from_numpy(valid).to(dev),
        np.float32(0.8), **args)
    assert bool(ex_c) and bool(ex_g)
    assert torch.equal(lab_g.cpu(), lab_c)
