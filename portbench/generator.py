"""The one traffic generator: a ring of frames made from the seed by the
frozen scene generators, as a configuration's ``scene`` and a traffic
mix's file (`traffic/<mix>.json`) describe it.

A mix's keys: ``ring``, the number of distinct frames replayed in turn,
and optionally ``clutter``: ``share`` of each frame's points replaced by
returns at a horizontal range drawn uniformly from ``range_m`` (around the
sensor at the origin) and a height drawn uniformly from ``height_m``.
"""

from __future__ import annotations

import numpy as np

from . import scenes


def frame_seeds(seed: int, n: int) -> list[int]:
    """``n`` frame seeds derived from the run's ``--seed`` (any size)."""
    return [int(s) for s in np.random.SeedSequence(int(seed))
            .generate_state(n, dtype=np.uint32)]


def scene(spec: dict, seed: int) -> np.ndarray:
    """The configuration's scene for one frame seed; with ``crop_m``, only
    its points with 0 <= x, y < ``crop_m`` (a small tile at the scene's own
    density)."""
    if spec["kind"] == "velodyne":
        pts = scenes.velodyne_scene(seed, spec["n_points"])
    elif spec["kind"] == "aerial":
        pts = scenes.aerial_scene(seed, spec["scale"])
    else:
        raise ValueError(f"unknown scene kind {spec['kind']!r}")
    if "crop_m" in spec:
        c = spec["crop_m"]
        pts = pts[(pts[:, 0] >= 0) & (pts[:, 0] < c) & (pts[:, 1] >= 0)
                  & (pts[:, 1] < c)]
    return pts


def add_clutter(pts: np.ndarray, spec: dict, seed: int) -> np.ndarray:
    """``pts`` with ``spec["share"]`` of its rows replaced by clutter."""
    rng = np.random.default_rng([seed, 1])
    n = int(round(spec["share"] * len(pts)))
    rows = rng.choice(len(pts), size=n, replace=False)
    r = rng.uniform(*spec["range_m"], n)
    az = rng.uniform(0.0, 2.0 * np.pi, n)
    z = rng.uniform(*spec["height_m"], n)
    out = pts.copy()
    out[rows] = np.column_stack([r * np.cos(az), r * np.sin(az), z]).astype(
        np.float32)
    return out


def frame(scene_spec: dict, mix: dict, seed: int) -> np.ndarray:
    """The mix's frame for one frame seed: float32 [N, 3]."""
    pts = scene(scene_spec, seed)
    if mix.get("clutter"):
        pts = add_clutter(pts, mix["clutter"], seed)
    return np.ascontiguousarray(pts, dtype=np.float32)


def ring(scene_spec: dict, mix: dict, seed: int) -> list[np.ndarray]:
    """The mix's ring of frames for the run's ``seed``."""
    return [frame(scene_spec, mix, s)
            for s in frame_seeds(seed, mix["ring"])]
