"""Frozen copy of the port's synthetic scene generators
(`pointclouds_tpu_torch/pipelines/scenes.py`), kept here so that no later
change to the program can move the benchmark's inputs. The same seed gives
the same points as the original;
`portbench/tests/test_portbench_copies.py` checks that the two still agree.
"""

from __future__ import annotations

import numpy as np


def kitti_scene(seed: int = 42, scale: float = 1.0) -> np.ndarray:
    """KITTI-like LiDAR frame: ~68K points at scale=1.0 (ground 60k,
    2 cars 3k each, pedestrian 500, noise 1.5k)."""
    rng = np.random.default_rng(seed)
    parts = []

    n_ground = int(60_000 * scale)
    gx = rng.uniform(-30, 30, n_ground).astype(np.float32)
    gy = rng.uniform(-20, 20, n_ground).astype(np.float32)
    gz = rng.normal(0, 0.03, n_ground).astype(np.float32)
    parts.append(np.column_stack([gx, gy, gz]))

    n_car = int(3_000 * scale)
    for cx, cy, cz in ((8.0, 3.0, 0.8), (-5.0, -8.0, 0.8)):
        parts.append(
            np.column_stack(
                [
                    rng.uniform(cx - 2.0, cx + 2.0, n_car),
                    rng.uniform(cy - 0.9, cy + 0.9, n_car),
                    rng.uniform(cz, cz + 1.5, n_car),
                ]
            ).astype(np.float32)
        )

    n_ped = int(500 * scale)
    px, py, pz = 3.0, -2.0, 0.9
    parts.append(
        np.column_stack(
            [
                rng.uniform(px - 0.25, px + 0.25, n_ped),
                rng.uniform(py - 0.25, py + 0.25, n_ped),
                rng.uniform(pz, pz + 1.8, n_ped),
            ]
        ).astype(np.float32)
    )

    n_noise = int(1_500 * scale)
    parts.append(
        np.column_stack(
            [
                rng.uniform(-35, 35, n_noise),
                rng.uniform(-25, 25, n_noise),
                rng.uniform(-3, 8, n_noise),
            ]
        ).astype(np.float32)
    )
    return np.vstack(parts)


def velodyne_scene(seed: int = 0, n_points: int = 122_000) -> np.ndarray:
    """~122K-point frame matching the README's real-Velodyne benchmark size
    (ref: README.md:23-25): denser ground + several vehicle/pedestrian
    clusters + noise, scaled to exactly ``n_points``."""
    scale = n_points / 68_000
    pts = kitti_scene(seed=seed, scale=scale)
    # Trim/pad to the exact requested count for stable benchmarking shapes.
    if len(pts) > n_points:
        pts = pts[:n_points]
    elif len(pts) < n_points:
        rng = np.random.default_rng(seed + 1)
        extra = np.column_stack(
            [
                rng.uniform(-30, 30, n_points - len(pts)),
                rng.uniform(-20, 20, n_points - len(pts)),
                rng.normal(0, 0.03, n_points - len(pts)),
            ]
        ).astype(np.float32)
        pts = np.vstack([pts, extra])
    return pts


def aerial_scene(seed: int = 7, scale: float = 1.0) -> np.ndarray:
    """Aerial LiDAR over a 500x500 m tile: undulating terrain + 5 buildings
    + 8 trees. ~241K points at scale=1.0."""
    rng = np.random.default_rng(seed)
    parts = []

    # Terrain: 200K ground points on gentle hills
    n_terrain = int(200_000 * scale)
    tx = rng.uniform(0, 500, n_terrain)
    ty = rng.uniform(0, 500, n_terrain)
    tz = (
        2.0 * np.sin(tx * 0.02) * np.cos(ty * 0.015)
        + rng.normal(0, 0.05, n_terrain)
    )
    parts.append(np.column_stack([tx, ty, tz]).astype(np.float32))

    # Buildings: boxes with roofs
    for _ in range(5):
        bx, by = rng.uniform(50, 450, 2)
        w, l = rng.uniform(15, 40, 2)
        h = rng.uniform(8, 30)
        n_b = int(6_000 * scale)
        base = 2.0 * np.sin(bx * 0.02) * np.cos(by * 0.015)
        # roof
        rx = rng.uniform(bx, bx + w, n_b // 2)
        ry = rng.uniform(by, by + l, n_b // 2)
        rz = np.full(n_b // 2, base + h) + rng.normal(0, 0.05, n_b // 2)
        parts.append(np.column_stack([rx, ry, rz]).astype(np.float32))
        # walls
        wx = rng.uniform(bx, bx + w, n_b // 2)
        wy = np.where(rng.random(n_b // 2) < 0.5, by, by + l) + rng.normal(
            0, 0.02, n_b // 2
        )
        wz = base + rng.uniform(0, h, n_b // 2)
        parts.append(np.column_stack([wx, wy, wz]).astype(np.float32))

    # Trees: vertical gaussian blobs
    for _ in range(8):
        cx, cy = rng.uniform(20, 480, 2)
        base = 2.0 * np.sin(cx * 0.02) * np.cos(cy * 0.015)
        n_t = int(1_400 * scale)
        parts.append(
            np.column_stack(
                [
                    rng.normal(cx, 2.0, n_t),
                    rng.normal(cy, 2.0, n_t),
                    base + rng.uniform(2, 12, n_t),
                ]
            ).astype(np.float32)
        )

    return np.vstack(parts).astype(np.float32)
