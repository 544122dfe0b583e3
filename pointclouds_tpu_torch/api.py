"""Public API on torch tensors: the whole surface of `pointclouds_tpu/api.py`
(the reference ``pointclouds_rs`` surface): `PointCloud`, `IcpResult`,
`PlaneResult`, the filters, normals, ICP, transform, clustering, plane,
kNN and spatial-query functions and the readers and writers, with the same
signatures, kwargs defaults, exception types and results.

A cloud lives on one device: `PointCloud.from_numpy` and the readers put
it on `DEFAULT_DEVICE`, the card, unless the caller names another
(``device="cpu"``), and every cloud an op derives from it stays on its
device. On the card the ops run the CUDA kernels; on the CPU their plain
torch versions. A machine without a card raises; it never falls back to
the CPU. Single-point queries (`radius_search`, `knn_indices`, `knn` of
at most 128 queries) run on the host, from a cell index built once per
cloud (the C++ index of `native/` where a compiler built it), and the
clusters are grouped there by the C++ epilogue.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import secrets
from typing import Optional

import numpy as np
import torch

from . import native as _native
from .core.cloud import (
    CloudTensors,
    apply_rigid,
    bucket_size,
    compact,
    gather_cloud,
    make_cloud_arrays,
    mask_cloud,
)
from .io import las as _las
from .io import pcd as _pcd
from .io import ply as _ply
from .ops import fusedops as _fusedops
from .ops import registration as _registration
from .ops import segmentation as _segmentation
from .ops.filters import sor_keep_mask
from .spatial import engine as _engine

__all__ = [
    "DEFAULT_DEVICE",
    "PointCloud",
    "IcpResult",
    "PlaneResult",
    "voxel_downsample",
    "passthrough_filter",
    "statistical_outlier_removal",
    "radius_outlier_removal",
    "estimate_normals",
    "estimate_normals_with_viewpoint",
    "icp_point_to_point",
    "icp_point_to_plane",
    "apply_transform",
    "euclidean_cluster",
    "ransac_plane",
    "ransac_plane_seeded",
    "knn",
    "knn_indices",
    "radius_search",
    "radius_search_unsorted",
    "read_pcd",
    "write_pcd",
    "write_pcd_binary",
    "read_ply",
    "write_ply",
    "write_ply_binary",
    "read_las",
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

    __slots__ = ("_arrs", "_count", "_host_index", "_host_xyz")

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
        data = array.astype(np.float32, copy=False)
        self = PointCloud.__new__(PointCloud)
        self._arrs = make_cloud_arrays(
            data, DEFAULT_DEVICE if device is None else device)
        self._count = int(array.shape[0])
        # Kept for the host index, so its build reads no device memory.
        self._host_xyz = (data, np.ones((data.shape[0],), bool))
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

    def _index(self):
        """The cloud's host cell index (`spatial/hostindex.py`), built on
        first use and kept: clouds are immutable."""
        idx = getattr(self, "_host_index", None)
        if idx is None:
            from .spatial.hostindex import HostCellIndex

            idx = HostCellIndex(*self._host_points())
            self._host_index = idx
        return idx

    def _host_points(self):
        """Host copy of (xyz, valid), cached: a `from_numpy` cloud keeps its
        array; any other pays one device read."""
        cached = getattr(self, "_host_xyz", None)
        if cached is None:
            cached = (self._arrs.xyz.cpu().numpy(),
                      self._arrs.valid.cpu().numpy())
            self._host_xyz = cached
        return cached

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


def _cloud_from_host(xyz, normals=None, colors=None, intensity=None
                     ) -> PointCloud:
    """A cloud on `DEFAULT_DEVICE` from host arrays (the readers')."""
    self = PointCloud.__new__(PointCloud)
    self._arrs = make_cloud_arrays(xyz, DEFAULT_DEVICE, normals=normals,
                                   colors=colors, intensity=intensity)
    self._count = int(np.asarray(xyz).reshape(-1, 3).shape[0])
    return self


@dataclasses.dataclass
class IcpResult:
    converged: bool
    fitness: float
    rmse: float
    num_iterations: int
    translation: list
    rotation: list

    def __repr__(self) -> str:
        return (
            f"IcpResult(converged={self.converged}, rmse={self.rmse:.6f}, "
            f"iterations={self.num_iterations})"
        )


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


# ── Registration ─────────────────────────────────────────────────────────────


def _empty_icp_result(source: PointCloud, target: PointCloud) -> IcpResult:
    return IcpResult(
        converged=source.is_empty() and target.is_empty(),
        fitness=0.0,
        rmse=0.0,
        num_iterations=0,
        translation=[0.0, 0.0, 0.0],
        rotation=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
    )


def _finish_icp(packed) -> IcpResult:
    """IcpResult from the loop's f32[16] ([rot(9), trans(3), fitness, rmse,
    converged, iterations]), read in one copy. rmse stays inf and fitness
    0 when no iteration found a correspondence, as in the reference."""
    v = packed.cpu().numpy().astype(np.float64)
    return IcpResult(
        converged=bool(v[14] > 0.5),
        fitness=float(v[12]),
        rmse=float(v[13]),
        num_iterations=int(v[15]),
        translation=[float(x) for x in v[9:12]],
        rotation=[[float(x) for x in row] for row in v[:9].reshape(3, 3)],
    )


def _icp_rows(cloud: PointCloud) -> int:
    """The valid count rounded up to 512 rows (at most the capacity): a
    cloud's rows past it are padding, trimmed before the quadratic 1-NN."""
    return min(cloud._arrs.capacity, max(512, -(-cloud.len() // 512) * 512))


def icp_point_to_point(
    source: PointCloud,
    target: PointCloud,
    max_iterations: int = 50,
    tolerance: float = 1e-5,
    max_correspondence_distance: float = float("inf"),
) -> IcpResult:
    if source.is_empty() or target.is_empty():
        return _empty_icp_result(source, target)
    return _finish_icp(_registration.icp_point_to_point_packed(
        source._arrs.xyz, source._arrs.valid, target._arrs.xyz,
        target._arrs.valid, int(max_iterations), np.float32(tolerance),
        np.float32(max_correspondence_distance), src_rows=_icp_rows(source),
        tgt_rows=_icp_rows(target)))


def icp_point_to_plane(
    source: PointCloud,
    target: PointCloud,
    max_iterations: int = 50,
    tolerance: float = 1e-5,
    max_correspondence_distance: float = float("inf"),
) -> IcpResult:
    if target._arrs.normals is None:
        raise ValueError(
            "target cloud must have normals for point-to-plane ICP. "
            "Use estimate_normals(target, k) first."
        )
    if source.is_empty() or target.is_empty():
        return _empty_icp_result(source, target)
    return _finish_icp(_registration.icp_point_to_plane_packed(
        source._arrs.xyz, source._arrs.valid, target._arrs.xyz,
        target._arrs.valid, target._arrs.normals, int(max_iterations),
        np.float32(tolerance), np.float32(max_correspondence_distance),
        src_rows=_icp_rows(source), tgt_rows=_icp_rows(target)))


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


def _cluster_lists(order, starts) -> list:
    """Cluster c as the list order[starts[c]:starts[c + 1]], sliced from one
    list of every row. The cyclic garbage collector pauses meanwhile:
    millions of new lists would set it off again and again (2-3x the time
    at 2^24 rows), and lists of ints hold no cycles."""
    rows, bounds = order.tolist(), starts.tolist()
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        return [rows[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    finally:
        if was_enabled:
            gc.enable()


def euclidean_cluster(
    cloud: PointCloud, distance_threshold: float, min_size: int, max_size: int
) -> list:
    distance_threshold = float(distance_threshold)
    min_size = int(min_size)
    max_size = int(max_size)
    if cloud.is_empty() or distance_threshold <= 0.0 or min_size == 0:
        return []
    if not math.isfinite(distance_threshold):
        return []
    # One host read: the labels of the valid rows. From the sweep, the
    # components outside [min_size, max_size] are already dropped on the
    # device (label -1) and the others carry surviving-component ranks.
    labels_np, filtered = _engine.cluster_labels(
        cloud._arrs.xyz, cloud._arrs.valid, distance_threshold,
        n_valid=cloud.len(), size_filter=(min_size, max_size))
    labels_np = labels_np[: cloud.len()]
    remap = None
    if filtered:
        # Group only the surviving rows; the compaction is monotone, so the
        # canonical order below survives the index remap.
        remap = np.nonzero(labels_np >= 0)[0].astype(np.int64)
        labels_np = labels_np[remap]
    # Components, canonically ordered: size descending, then first member;
    # members ascending. The C++ epilogue (a counting sort) where it is
    # built, else numpy.
    res = _native.cluster_epilogue(labels_np, min_size, max_size)
    if res is not None:
        order, starts = res
        if remap is not None:
            order = remap[order]
        return _cluster_lists(order, starts)
    order = np.argsort(labels_np, kind="stable")
    sorted_labels = labels_np[order]
    if remap is not None:
        order = remap[order]
    boundaries = np.nonzero(
        np.concatenate([[True], sorted_labels[1:] != sorted_labels[:-1]])
    )[0]
    ends = np.concatenate([boundaries[1:], [len(sorted_labels)]])
    clusters = []
    for s, e in zip(boundaries, ends):
        if min_size <= e - s <= max_size:
            clusters.append(order[s:e].tolist())
    clusters.sort(key=lambda c: (-len(c), c))
    return clusters


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


# ── I/O ──────────────────────────────────────────────────────────────────────


def read_pcd(path: str) -> PointCloud:
    try:
        xyz = _pcd.read_pcd(path)
    except OSError as e:
        raise IOError(str(e))
    return _cloud_from_host(xyz)


def write_pcd(path: str, cloud: PointCloud) -> None:
    try:
        _pcd.write_pcd(path, cloud.to_numpy())
    except OSError as e:
        raise IOError(str(e))


def write_pcd_binary(path: str, cloud: PointCloud) -> None:
    try:
        _pcd.write_pcd_binary(path, cloud.to_numpy())
    except OSError as e:
        raise IOError(str(e))


def read_ply(path: str) -> PointCloud:
    try:
        xyz, normals, colors = _ply.read_ply(path)
    except OSError as e:
        raise IOError(str(e))
    return _cloud_from_host(xyz, normals=normals, colors=colors)


def write_ply(path: str, cloud: PointCloud) -> None:
    try:
        _ply.write_ply(path, cloud.to_numpy(), cloud._normals_numpy(),
                       cloud._colors_numpy())
    except OSError as e:
        raise IOError(str(e))


def write_ply_binary(path: str, cloud: PointCloud) -> None:
    try:
        _ply.write_ply_binary(path, cloud.to_numpy(), cloud._normals_numpy(),
                              cloud._colors_numpy())
    except OSError as e:
        raise IOError(str(e))


def read_las(path: str) -> PointCloud:
    try:
        xyz, intensity = _las.read_las(path)
    except OSError as e:
        raise IOError(str(e))
    return _cloud_from_host(xyz, intensity=intensity)


# ── Spatial queries (the reference's KD-tree capability at crate level:
#    not in its Python bindings, but part of the library surface) ──────────


def knn(cloud: PointCloud, queries, k: int):
    """K nearest neighbours of each query point in ``cloud``.

    Returns (indices int32[Q, k'], distances f32[Q, k']) with k' = min(k,
    len(cloud)); distances Euclidean, ascending. An empty cloud, k == 0 or
    a non-finite query gives no results for that query (index -1, distance
    +inf). At most 128 queries are answered from the host index; larger
    batches by the device sweeps (`engine.knn`), the same-cloud sweep when
    the queries are the cloud's own points in order."""
    k = int(k)
    q = np.ascontiguousarray(np.asarray(queries, np.float32)).reshape(-1, 3)
    nq = q.shape[0]
    if k <= 0 or cloud.is_empty() or nq == 0:
        return np.zeros((nq, 0), np.int32), np.zeros((nq, 0), np.float32)
    k_eff = min(k, cloud.len())
    if nq <= 128:
        index = cloud._index()
        finite = np.isfinite(q).all(axis=1)
        if index._native is not None and finite.all():
            # One C call for the whole batch.
            rows_b, dd_b, cnt_b = index._native.knn_batch(q, k_eff)
            got = np.arange(k_eff)[None, :] < cnt_b[:, None]
            return (np.where(got, rows_b, -1).astype(np.int32),
                    np.where(got, dd_b, np.inf).astype(np.float32))
        i_out = np.full((nq, k_eff), -1, np.int32)
        d_out = np.full((nq, k_eff), np.inf, np.float32)
        for r in np.nonzero(finite)[0]:
            rows, dd = index.knn(q[r], k_eff)
            i_out[r, :len(rows)] = rows
            d_out[r, :len(rows)] = dd
        return i_out, d_out
    arrs = cloud._arrs
    hxyz, hvalid = cloud._host_points()
    if (nq == cloud.len() and hxyz.shape[0] >= nq and bool(hvalid[:nq].all())
            and np.array_equal(q, hxyz[:nq])):
        dists, idx, nvalid = _engine.knn(arrs.xyz, arrs.valid, arrs.xyz,
                                         arrs.valid, k_eff)
    else:
        qarrs = make_cloud_arrays(q, cloud.device)
        dists, idx, nvalid = _engine.knn(arrs.xyz, arrs.valid, qarrs.xyz,
                                         qarrs.valid, k_eff)
    # One host read: the distances' bits beside the indices, as int32 (the
    # indices stay exact at any cloud size).
    buf = torch.cat([torch.where(nvalid, dists, torch.inf)[:nq, :k_eff].view(
        torch.int32), torch.where(nvalid, idx, -1)[:nq, :k_eff].to(
            torch.int32)], dim=1).cpu().numpy()
    return buf[:, k_eff:].copy(), buf[:, :k_eff].view(np.float32).copy()


def radius_search(cloud: PointCloud, query, radius: float):
    """Indices of the points within ``radius`` (inclusive) of ``query``,
    ascending. Returns [] for an empty cloud, a non-positive or non-finite
    radius, or a non-finite query. A [Q, 3] query batch returns a list of
    lists.

    Runs on the host, not the card: the cloud's host cell index
    (`spatial/hostindex.py`, built once per cloud from a host copy of its
    points) gathers the candidate cells and tests their distances exactly
    in float64."""
    radius = float(radius)
    qa = np.asarray(query, np.float32)
    if qa.ndim == 2:
        if cloud.is_empty() or radius <= 0.0 or not math.isfinite(radius):
            return [[] for _ in range(qa.shape[0])]
        index = cloud._index()
        return [index.radius(row, radius).tolist()
                if np.all(np.isfinite(row)) else [] for row in qa]
    q = qa.reshape(3)
    if (cloud.is_empty() or radius <= 0.0 or not math.isfinite(radius)
            or not np.all(np.isfinite(q))):
        return []
    return cloud._index().radius(q, radius).tolist()


def radius_search_unsorted(cloud: PointCloud, query, radius: float):
    """The results of :func:`radius_search`, with no ordering guarantee (it
    returns them sorted all the same)."""
    return radius_search(cloud, query, radius)


def knn_indices(cloud: PointCloud, query, k: int):
    """Indices of the ``k`` nearest neighbours of one ``query`` point,
    nearest first, from the host index. Returns [] for k == 0, an empty
    cloud or a non-finite query."""
    k = int(k)
    q = np.asarray(query, np.float32).reshape(3)
    if k <= 0 or cloud.is_empty() or not np.all(np.isfinite(q)):
        return []
    rows, _ = cloud._index().knn(q, min(k, cloud.len()))
    return rows.tolist()
