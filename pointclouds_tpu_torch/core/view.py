"""Zero-copy view + typed point records (copied from
`pointclouds_tpu/core/view.py`: host numpy, no device code).

Equivalents of the reference's CloudView and point-type layer
(ref: crates/core/src/cloud_view.rs:1-41, point.rs:1-34, traits.rs:1-15).
Neither is used by any algorithm in the reference either — they are part of
the public core surface, so they exist here for capability parity:

- ``CloudView`` wraps an interleaved xyz buffer WITHOUT copying (a numpy
  reshape view), mirroring the zero-copy ``&[f32]`` semantics.
- The point dataclasses are plain typed records; the Has* traits become
  ``typing.Protocol``s so any structurally-compatible object satisfies them
  (the Python analogue of Rust trait bounds).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Protocol, runtime_checkable

import numpy as np


class CloudView:
    """Zero-copy view over an interleaved xyz float32 buffer
    (ref: crates/core/src/cloud_view.rs:8-40)."""

    __slots__ = ("_data", "_n")

    def __init__(self, data: np.ndarray, num_points: int):
        data = np.asarray(data)
        if data.size != num_points * 3:
            raise ValueError("view source must have num_points * 3 floats")
        self._data = data.reshape(-1)  # no copy for contiguous input
        self._n = int(num_points)

    @staticmethod
    def from_interleaved_xyz(data, num_points: int) -> "CloudView":
        return CloudView(data, num_points)

    def len(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    def is_empty(self) -> bool:
        return self._n == 0

    def point(self, i: int):
        if not 0 <= i < self._n:
            raise IndexError("index out of bounds")
        base = i * 3
        return (
            float(self._data[base]),
            float(self._data[base + 1]),
            float(self._data[base + 2]),
        )

    def iter_points(self) -> Iterator[tuple]:
        for i in range(self._n):
            yield self.point(i)

    def as_slice(self) -> np.ndarray:
        return self._data

    def as_array(self) -> np.ndarray:
        """[N, 3] reshape view (no copy)."""
        return self._data[: self._n * 3].reshape(self._n, 3)


# ── Typed point records (ref: crates/core/src/point.rs) ─────────────────────


@dataclass(frozen=True)
class PointXYZ:
    x: float
    y: float
    z: float

    def position(self):
        return (self.x, self.y, self.z)


@dataclass(frozen=True)
class PointXYZRGB:
    x: float
    y: float
    z: float
    r: int
    g: int
    b: int

    def position(self):
        return (self.x, self.y, self.z)

    def color(self):
        return (self.r, self.g, self.b)


@dataclass(frozen=True)
class PointXYZI:
    x: float
    y: float
    z: float
    intensity: float

    def position(self):
        return (self.x, self.y, self.z)


@dataclass(frozen=True)
class PointXYZNormal:
    x: float
    y: float
    z: float
    nx: float
    ny: float
    nz: float

    def position(self):
        return (self.x, self.y, self.z)

    def normal(self):
        return (self.nx, self.ny, self.nz)


# ── Structural traits (ref: crates/core/src/traits.rs) ──────────────────────


@runtime_checkable
class HasPosition(Protocol):
    def position(self) -> tuple: ...


@runtime_checkable
class HasColor(Protocol):
    def color(self) -> tuple: ...


@runtime_checkable
class HasNormal(Protocol):
    def normal(self) -> tuple: ...


@runtime_checkable
class HasIntensity(Protocol):
    intensity: float
