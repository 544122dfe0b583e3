"""The benchmark's frozen copies equal their originals today: the scene
generators, the Threefry bits and the kernels' yardstick (`work`, with its
one change: the two labelling kernels count one pass over their pairs)."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from pointclouds_tpu_torch.pipelines import scenes as program_scenes  # noqa: E402
from pointclouds_tpu_torch.utils import threefry as program_threefry  # noqa: E402
from portbench import scenes, yardstick  # noqa: E402
from portbench.reference import threefry  # noqa: E402


@pytest.mark.parametrize("fn,args", [
    ("kitti_scene", (3, 0.1)),
    ("velodyne_scene", (2**31 + 9, 9000)),
    ("velodyne_scene", (4, 60_000)),
    ("aerial_scene", (5, 0.03)),
])
def test_scenes_equal_the_programs(fn, args):
    np.testing.assert_array_equal(getattr(scenes, fn)(*args),
                                  getattr(program_scenes, fn)(*args))


def test_threefry_equals_the_programs():
    for seed in (0, 7, 2**31 - 1):
        a = threefry.random_bits64(seed, (3, 257))
        b = program_threefry.random_bits64(seed, (3, 257))
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    hi, lo = threefry.random_bits64(11, (1000,))
    m = torch.tensor(99_991)
    assert torch.equal(threefry.mod_u64(hi, lo, m),
                       program_threefry.mod_u64(hi, lo, m))


def _calls():
    """Arguments of the kernel wrappers at small shapes, as their callers
    shape them."""
    g = torch.Generator().manual_seed(0)
    planar = torch.rand((6, 4, 128), generator=g)
    planar[:, 3] = (planar[:, 3] > 0.2).float()
    starts = torch.zeros((4, 28), dtype=torch.int32)
    starts[:, 9:18] = torch.randint(0, 3, (4, 9), generator=g)
    starts[:, 18:27] = starts[:, 9:18] + torch.randint(0, 3, (4, 9),
                                                        generator=g)
    starts[:, 27] = torch.tensor([1, 0, 1, 1])
    rowlist = torch.zeros((4, 16 + 2), dtype=torch.int32)
    rowlist[:, 16] = torch.tensor([1, 1, 0, 1])
    rowlist[:, 17] = torch.tensor([3, 20, 5, 7])
    active = torch.tensor([[2, 0, 1, 0], [1, 1, 0, 0]], dtype=torch.int32)
    hyp = torch.rand((5, 256), generator=g)
    hyp[4, 200:] = -1.0
    pts = torch.rand((300, 4), generator=g)
    q = torch.rand((2, 4, 128), generator=g)
    cand = torch.rand((384, 3), generator=g)
    out = torch.zeros(8)
    return [
        ("segmented_scan_sums", (torch.ones(512), planar), {}, out),
        ("sweep_select_rows", (planar, rowlist), {"cap": 16}, out),
        ("rescue_select", (planar, q, active), {"gr": 8}, out),
        ("rescue_knn_idx", (planar, q, active), {"gr": 2}, out),
        ("rescue_radius_count_groups", (planar, q, active), {"gr": 2}, out),
        ("sweep_moments", (planar, starts), {}, out),
        ("sweep_select", (planar, starts), {}, out),
        ("count_within", (planar, starts), {}, out),
        ("sweep_knn_select", (planar, starts), {}, out),
        ("ransac_score_counts", (hyp, pts), {}, out),
        ("brute_knn_idx", (q, cand), {}, out),
        ("brute_radius_count", (q, cand), {}, out),
        ("nn_argmin", (q, cand), {}, out),
        ("cluster_propagate", (planar, None, torch.cat(
            [starts, torch.ones((4, 1), dtype=torch.int32)], 1)), {}, out),
        ("segmented_select", (torch.rand(1000),), {}, out),
        ("cluster_multisweep_windows", (planar, starts), {}, (out, out, 3)),
    ]


@pytest.mark.parametrize("name,args,kwargs,out", _calls(),
                         ids=[c[0] for c in _calls()])
def test_yardstick_equals_chip_smoke(name, args, kwargs, out):
    mine = yardstick.work(name, args, kwargs, out)
    theirs = chip_smoke.work(name, args, kwargs, out)
    if name == "cluster_multisweep_windows":
        # The original counts the rounds the kernel ran; the copy one pass.
        theirs = (theirs[0], theirs[1] // out[2])
    assert mine == theirs
    assert yardstick.bound_ms(*mine) == chip_smoke.bound_ms(*theirs)
    assert name in yardstick.KERNELS
