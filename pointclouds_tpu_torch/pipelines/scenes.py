"""Synthetic benchmark scenes, copied as numpy code from
`pointclouds_tpu/pipelines/scenes.py` so the port runs where JAX is not
installed (the same seed gives the same points in both packages)."""

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

