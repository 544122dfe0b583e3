"""The traffic generator: the same seed gives the same frames; another seed
other frames of the same sizes; the clutter replaces its share."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent))

from portbench import generator  # noqa: E402

SMALL = {"velodyne": {"kind": "velodyne", "n_points": 4096},
         "aerial": {"kind": "aerial", "scale": 0.02}}


def mix(name):
    m = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    m["ring"] = 3
    return m


@pytest.mark.parametrize("scene,name", [("velodyne", "stream"),
                                        ("velodyne", "snow"),
                                        ("aerial", "tiles")])
def test_ring_is_deterministic_for_a_seed(scene, name):
    big = 2**31 + 12345  # a run's seed may pass 32 signed bits
    a = generator.ring(SMALL[scene], mix(name), big)
    b = generator.ring(SMALL[scene], mix(name), big)
    c = generator.ring(SMALL[scene], mix(name), big + 1)
    assert len(a) == 3
    for x, y, z in zip(a, b, c):
        assert x.dtype == np.float32 and x.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(x, y)
        assert x.shape == z.shape and not np.array_equal(x, z)
    assert not np.array_equal(a[0], a[1])


def test_clutter_replaces_its_share_in_its_annulus():
    spec = mix("snow")["clutter"]
    clean = generator.scene(SMALL["velodyne"], 77)
    snowy = generator.add_clutter(clean, spec, 77)
    changed = np.any(clean != snowy, axis=1)
    assert changed.sum() == round(spec["share"] * len(clean))
    r = np.hypot(snowy[changed, 0], snowy[changed, 1])
    assert r.min() >= spec["range_m"][0] - 1e-4
    assert r.max() <= spec["range_m"][1] + 1e-4
    z = snowy[changed, 2]
    assert z.min() >= spec["height_m"][0] and z.max() <= spec["height_m"][1]


def test_crop_keeps_the_square_at_the_scenes_density():
    full = generator.scene(SMALL["aerial"], 5)
    crop = generator.scene(dict(SMALL["aerial"], crop_m=100), 5)
    inside = ((full[:, 0] >= 0) & (full[:, 0] < 100) & (full[:, 1] >= 0)
              & (full[:, 1] < 100))
    np.testing.assert_array_equal(crop, full[inside])
    assert 0 < len(crop) < len(full)
