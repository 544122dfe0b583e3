"""Public API on torch tensors: the `PointCloud` class, `PlaneResult` and the
filter, normals, transform and plane functions of `pointclouds_tpu/api.py`
(the reference ``pointclouds_rs`` surface), with the same signatures,
kwargs defaults, exception types and results.

A cloud lives on one device: `PointCloud.from_numpy` puts it on
`DEFAULT_DEVICE`, the card, unless the caller names another
(``device="cpu"``), and every cloud an op derives from it stays on its
device. On the card the ops run the CUDA kernels; on the CPU their plain
torch versions. A machine without a card raises; it never falls back to
the CPU.

Still to port from the JAX API: `knn`, `knn_indices`, `radius_search`,
`radius_search_unsorted`, `euclidean_cluster`, ICP and the readers and
writers.
"""

from __future__ import annotations

import dataclasses
import math
import secrets
from typing import Optional

import numpy as np
import torch

from .core.cloud import (
    CloudTensors,
    apply_rigid,
    bucket_size,
    compact,
    gather_cloud,
    make_cloud_arrays,
    mask_cloud,
)
from .ops import fusedops as _fusedops
from .ops import segmentation as _segmentation
from .ops.filters import sor_keep_mask
from .spatial import engine as _engine

__all__ = [
    "DEFAULT_DEVICE",
    "PointCloud",
    "PlaneResult",
    "voxel_downsample",
    "passthrough_filter",
    "statistical_outlier_removal",
    "radius_outlier_removal",
    "estimate_normals",
    "estimate_normals_with_viewpoint",
    "apply_transform",
    "ransac_plane",
    "ransac_plane_seeded",
]

# Where `PointCloud.from_numpy` and `PointCloud()` put a cloud unless told.
DEFAULT_DEVICE = "cuda"

# The sweep kernels' per-thread top-k holds at most this many neighbours;
# SOR (k + 1) and normals (k) above it take the brute-force path, as small
# clouds do.
_SWEEP_MAX_K = 32


def _slice_arrays(arrs: CloudTensors, cap: int) -> CloudTensors:
    return CloudTensors(*(None if a is None else a[:cap] for a in arrs))


class PointCloud:
    """A point cloud on one device: compacted padded tensors, rows [0, len)
    the points in order, rows beyond masked padding."""

    __slots__ = ("_arrs", "_count")

    def __init__(self, device=None):
        self._arrs = make_cloud_arrays(
            np.zeros((0, 3), np.float32),
            DEFAULT_DEVICE if device is None else device)
        self._count = 0

    @classmethod
    def _from(cls, arrs: CloudTensors, count: int) -> "PointCloud":
        """From already-compacted tensors holding ``count`` points."""
        self = cls.__new__(cls)
        cap = bucket_size(count)
        if cap < arrs.capacity:
            arrs = _slice_arrays(arrs, cap)
        self._arrs = arrs
        self._count = int(count)
        return self

    @classmethod
    def _from_masked(cls, arrs: CloudTensors) -> "PointCloud":
        out = compact(arrs)
        return cls._from(out, int(out.valid.sum()))  # host read: the count

    @staticmethod
    def from_numpy(array, *, device=None) -> "PointCloud":
        if not isinstance(array, np.ndarray):
            raise TypeError(
                "expected NumPy array with dtype float32 or float64, shape (N, 3)"
            )
        if array.dtype not in (np.float32, np.float64):
            raise TypeError(
                "expected NumPy array with dtype float32 or float64, shape (N, 3)"
            )
        if array.ndim != 2 or array.shape[1] != 3:
            raise ValueError("expected shape (N, 3)")
        if not array.flags["C_CONTIGUOUS"]:
            raise ValueError(
                "array must be C-contiguous (row-major). "
                "Use numpy.ascontiguousarray(arr) to convert."
            )
        self = PointCloud.__new__(PointCloud)
        self._arrs = make_cloud_arrays(
            array.astype(np.float32, copy=False),
            DEFAULT_DEVICE if device is None else device)
        self._count = int(array.shape[0])
        return self

    @property
    def device(self) -> torch.device:
        return self._arrs.xyz.device

    def len(self) -> int:
        return self._count

    def is_empty(self) -> bool:
        return self._count == 0

    def to_numpy(self) -> np.ndarray:
        return self._arrs.xyz[: self._count].cpu().numpy().copy()

    def _check_indices(self, indices) -> np.ndarray:
        idx = np.asarray(list(indices), dtype=np.int64)
        if idx.size:
            bad = idx[(idx < 0) | (idx >= self._count)]
            if bad.size:
                raise IndexError(
                    f"index {int(bad[0])} out of bounds for cloud with "
                    f"{self._count} points"
                )
        return idx

    def select(self, indices) -> "PointCloud":
        idx = self._check_indices(indices)
        m = idx.shape[0]
        cap = bucket_size(m)
        idx_pad = np.zeros((cap,), np.int64)
        idx_pad[:m] = idx
        dev = self.device
        out = gather_cloud(self._arrs, torch.from_numpy(idx_pad).to(dev),
                           torch.arange(cap, device=dev) < m)
        return PointCloud._from(out, m)

    def select_inverse(self, indices) -> "PointCloud":
        idx = self._check_indices(indices)
        exclude = np.zeros((self._count,), bool)
        exclude[idx] = True
        return self.select(np.nonzero(~exclude)[0])

    def __len__(self) -> int:
        return self._count

    def __repr__(self) -> str:
        return f"PointCloud(n={self._count})"

    # Attribute access (not part of the reference's binding surface).

    @property
    def _has_normals(self) -> bool:
        return self._arrs.normals is not None

    def _host_rows(self, a) -> Optional[np.ndarray]:
        return None if a is None else a[: self._count].cpu().numpy().copy()

    def _normals_numpy(self) -> Optional[np.ndarray]:
        return self._host_rows(self._arrs.normals)

    def _colors_numpy(self) -> Optional[np.ndarray]:
        return self._host_rows(self._arrs.colors)

    def _intensity_numpy(self) -> Optional[np.ndarray]:
        return self._host_rows(self._arrs.intensity)


@dataclasses.dataclass
class PlaneResult:
    normal: list
    d: float
    inliers: list

    def __repr__(self) -> str:
        return (
            f"PlaneResult(normal={self.normal}, d={self.d:.4f}, "
            f"inliers={len(self.inliers)})"
        )


def _info(t) -> list:
    """A fused op's small info tensor on the host (its one host read)."""
    return t.cpu().tolist()


# ── Filters ──────────────────────────────────────────────────────────────────


def voxel_downsample(cloud: PointCloud, voxel_size: float) -> PointCloud:
    voxel_size = float(voxel_size)
    if not math.isfinite(voxel_size) or voxel_size <= 0.0:
        raise ValueError("voxel_size must be > 0 and finite")
    if cloud.is_empty():
        return PointCloud(cloud.device)
    # Attributes are dropped, like the reference's result.
    arrs, cnt = _fusedops.voxel_fused(cloud._arrs.xyz, cloud._arrs.valid,
                                      np.float32(voxel_size))
    return PointCloud._from(arrs, int(cnt))  # host read: the count


_AXES = {"x": 0, "X": 0, "y": 1, "Y": 1, "z": 2, "Z": 2}


def passthrough_filter(
    cloud: PointCloud, axis: str, min: float, max: float
) -> PointCloud:
    if axis not in _AXES:
        raise ValueError("axis must be 'x', 'y', or 'z'")
    if cloud.is_empty():
        return PointCloud(cloud.device)
    arrs, cnt = _fusedops.passthrough_fused(
        cloud._arrs, _AXES[axis], np.float32(min), np.float32(max))
    return PointCloud._from(arrs, int(cnt))  # host read: the count


def statistical_outlier_removal(
    cloud: PointCloud, k: int, std_mul: float
) -> PointCloud:
    std_mul = float(std_mul)
    if not math.isfinite(std_mul) or std_mul < 0.0:
        raise ValueError("std_mul must be >= 0 and finite")
    k = int(k)
    if k < 0:
        raise ValueError("k must be >= 0")
    if cloud.is_empty() or k == 0:
        return PointCloud(cloud.device)
    if cloud.len() == 1:
        # A single point has nothing to compare against: kept.
        return cloud.select([0])

    arrs = cloud._arrs
    n = arrs.capacity
    std32 = np.float32(std_mul)
    if n <= _engine.BRUTE_THRESHOLD or k + 1 > _SWEEP_MAX_K:
        out, info = _fusedops.sor_fused_small(arrs, std32, k=k)
        return PointCloud._from(out, _info(info)[0])
    out, info = _fusedops.sor_fused(arrs, std32, k=k,
                                    wr=_engine._sweep_wr(n),
                                    cap=_fusedops.fused_rescue_cap(n))
    count, exact = _info(info)
    if exact:
        return PointCloud._from(out, count)
    # Rescue-cap overflow: the multi-dispatch engine path resolves every
    # flagged row exactly.
    means = _engine.sor_means(arrs.xyz, arrs.valid, k)
    return PointCloud._from_masked(
        mask_cloud(arrs, sor_keep_mask(means, arrs.valid, std32)))


def radius_outlier_removal(
    cloud: PointCloud, radius: float, min_neighbors: int
) -> PointCloud:
    radius = float(radius)
    if not math.isfinite(radius) or radius <= 0.0:
        raise ValueError("radius must be > 0 and finite")
    min_neighbors = int(min_neighbors)
    if cloud.is_empty():
        return PointCloud(cloud.device)
    arrs = cloud._arrs
    n = arrs.capacity
    r32 = torch.tensor(np.float32(radius), device=cloud.device)
    min32 = np.int32(min_neighbors)
    if n <= _engine.BRUTE_THRESHOLD:
        out, info = _fusedops.ror_fused_small(arrs, r32, min32)
        return PointCloud._from(out, _info(info)[0])
    out, info = _fusedops.ror_fused(arrs, r32, min32,
                                    wr=_engine._sweep_wr(n),
                                    cap=_fusedops.fused_rescue_cap(n))
    count, exact = _info(info)
    if exact:
        return PointCloud._from(out, count)
    counts = _engine.radius_count_sweep(arrs.xyz, arrs.valid, radius)
    return PointCloud._from_masked(
        mask_cloud(arrs, arrs.valid & (counts >= min_neighbors)))


# ── Normals ──────────────────────────────────────────────────────────────────


def estimate_normals(cloud: PointCloud, k: int) -> PointCloud:
    return estimate_normals_with_viewpoint(cloud, k, (0.0, 0.0, 0.0))


def estimate_normals_with_viewpoint(
    cloud: PointCloud, k: int, viewpoint
) -> PointCloud:
    """A new cloud with normals attached."""
    k = int(k)
    if k <= 0 or cloud.is_empty():
        # The reference attaches zero-length normals; padded tensors
        # cannot, so none are attached.
        return PointCloud._from(cloud._arrs._replace(normals=None),
                                cloud.len())
    xyz, valid = cloud._arrs.xyz, cloud._arrs.valid
    n = cloud._arrs.capacity
    vp = np.asarray(viewpoint, np.float32).reshape(3)
    if n <= _engine.BRUTE_THRESHOLD or k >= n or k > _SWEEP_MAX_K:
        normals = _fusedops.normals_fused_small(xyz, valid, vp,
                                                k=min(k, max(n, 1)))
    else:
        normals, exact = _fusedops.normals_fused(
            xyz, valid, vp, k=k, wr=_engine._sweep_wr(n),
            cap=_fusedops.fused_rescue_cap(n))
        if not bool(exact):  # host read: the rescue-cap test
            # Rescue-cap overflow: the multi-dispatch engine path rescues
            # any number of flagged rows exactly.
            normals = _engine.normals(xyz, valid, k, vp)
    return PointCloud._from(cloud._arrs._replace(normals=normals),
                            cloud.len())


# ── Transform ────────────────────────────────────────────────────────────────


def apply_transform(cloud: PointCloud, rotation, translation) -> PointCloud:
    """R p + t for every point; attributes are dropped, as the reference's
    apply_transform does."""
    dev = cloud.device
    rot = torch.from_numpy(np.asarray(rotation, np.float32).reshape(3, 3))
    trans = torch.from_numpy(np.asarray(translation, np.float32).reshape(3))
    new_xyz = apply_rigid(cloud._arrs.xyz, rot.to(dev), trans.to(dev))
    return PointCloud._from(CloudTensors(xyz=new_xyz, valid=cloud._arrs.valid),
                            cloud.len())


# ── Segmentation ─────────────────────────────────────────────────────────────


def ransac_plane_seeded(
    cloud: PointCloud, distance_threshold: float, iterations: int, seed: int,
    score_subsample: int | None = None,
) -> PlaneResult:
    """``score_subsample`` (not in the reference surface) selects the
    tournament scoring (`ops/segmentation.ransac_plane_masked`); final
    inliers are always full-cloud."""
    iterations = int(iterations)
    if cloud.len() < 3 or iterations <= 0:
        return PlaneResult(normal=[0.0, 0.0, 1.0], d=0.0, inliers=[])
    # assume_compact: a PointCloud's valid rows are exactly [0, len).
    buf = _segmentation.ransac_plane_bytes(
        cloud._arrs.xyz, cloud._arrs.valid, np.float32(distance_threshold),
        int(seed) % (2**31), iterations, assume_compact=True,
        score_subsample=score_subsample,
        adaptive=(score_subsample is None),
    ).cpu().numpy()  # host read: the one packed result
    # Bytes [0:16] are the f32 scalars, the rest the bit-packed mask.
    v = buf[:16].copy().view(np.float32).astype(np.float64)
    mask_np = np.unpackbits(buf[16:], bitorder="little")[: cloud.len()]
    return PlaneResult(
        normal=[float(x) for x in v[:3]],
        d=float(v[3]),
        inliers=np.nonzero(mask_np)[0].tolist(),
    )


def ransac_plane(
    cloud: PointCloud, distance_threshold: float, iterations: int
) -> PlaneResult:
    return ransac_plane_seeded(
        cloud, distance_threshold, iterations, secrets.randbits(32)
    )
