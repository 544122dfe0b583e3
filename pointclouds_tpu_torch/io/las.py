"""Minimal native LAS reader (versions 1.0-1.4, point formats 0-10).

The reference delegates to the Rust ``las`` crate
(ref: crates/io/src/las.rs:5-38): xyz are decoded from scaled int32s to f64
then cast to f32, and intensity is attached only when any point has non-zero
intensity. This is a from-scratch numpy implementation of the same contract
(no ``laspy`` in the environment). LAZ compression is not supported.

Copied from `pointclouds_tpu/io/las.py`: the point records are decoded by
the host C++ (`native/pcio.cpp`) where it is built, by numpy otherwise.
"""

from __future__ import annotations

import struct

import numpy as np

from .. import native as _native


def read_las(path: str):
    """Returns (xyz f32[N,3], intensity f32[N]|None)."""
    with open(path, "rb") as f:
        raw = f.read()

    if len(raw) < 227:
        raise OSError("LAS file too short for header")
    if raw[:4] != b"LASF":
        raise OSError("not a LAS file (missing LASF magic)")

    ver_major, ver_minor = raw[24], raw[25]
    (offset_to_points,) = struct.unpack_from("<I", raw, 96)
    point_format = raw[104]
    (record_len,) = struct.unpack_from("<H", raw, 105)
    (legacy_count,) = struct.unpack_from("<I", raw, 107)
    sx, sy, sz = struct.unpack_from("<3d", raw, 131)
    ox, oy, oz = struct.unpack_from("<3d", raw, 155)

    if point_format & 0x80:
        raise OSError("LAZ (compressed) files are not supported")

    count = legacy_count
    if ver_major == 1 and ver_minor >= 4 and len(raw) >= 255:
        (count64,) = struct.unpack_from("<Q", raw, 247)
        if count64:
            count = count64

    # All point formats 0-10 start with x, y, z int32 and intensity u16 at
    # byte offset 12 (LAS 1.4 spec, point data record formats).
    if record_len < 14:
        raise OSError(f"LAS point record length {record_len} too small")
    end = offset_to_points + count * record_len
    if len(raw) < end:
        raise OSError(
            f"LAS file truncated: need {end} bytes, have {len(raw)}"
        )

    fast = _native.decode_las(raw[offset_to_points:end], count, record_len,
                              (sx, sy, sz), (ox, oy, oz))
    if fast is not None:
        xyz, inten_f, any_i = fast
        return xyz, (inten_f if any_i else None)

    body = np.frombuffer(raw[offset_to_points:end], dtype=np.uint8).reshape(
        count, record_len
    )
    xi = body[:, 0:4].copy().view("<i4").reshape(-1).astype(np.float64)
    yi = body[:, 4:8].copy().view("<i4").reshape(-1).astype(np.float64)
    zi = body[:, 8:12].copy().view("<i4").reshape(-1).astype(np.float64)
    inten = body[:, 12:14].copy().view("<u2").reshape(-1)

    xyz = np.stack(
        [xi * sx + ox, yi * sy + oy, zi * sz + oz], axis=1
    ).astype(np.float32)
    intensity = (
        inten.astype(np.float32) if np.any(inten != 0) else None
    )
    return xyz, intensity


def write_las(path: str, xyz, intensity=None):
    """Write a minimal LAS 1.2, point-format-0 file (framework extra — the
    reference has no LAS writer; used for test roundtrips)."""
    xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
    n = xyz.shape[0]
    if n:
        mn = xyz.min(axis=0)
        mx = xyz.max(axis=0)
    else:
        mn = mx = np.zeros(3)
    scale = np.maximum((mx - mn) / (2**31 - 2), 1e-9)
    offset = mn

    header = bytearray(227)
    header[0:4] = b"LASF"
    header[24] = 1
    header[25] = 2
    struct.pack_into("<B", header, 94 + 0, 0)
    struct.pack_into("<H", header, 94, 227)  # header size
    struct.pack_into("<I", header, 96, 227)  # offset to point data
    struct.pack_into("<I", header, 100, 0)  # number of VLRs
    header[104] = 0  # point data format 0
    struct.pack_into("<H", header, 105, 20)  # record length
    struct.pack_into("<I", header, 107, n)
    struct.pack_into("<3d", header, 131, *scale)
    struct.pack_into("<3d", header, 155, *offset)
    struct.pack_into("<3d", header, 179, mx[0], mn[0], mx[1])
    struct.pack_into("<3d", header, 203, mn[1], mx[2], mn[2])

    ints = np.round((xyz - offset) / scale).astype("<i4")
    rec = np.zeros(n, dtype=np.dtype([("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
                                      ("intensity", "<u2"), ("rest", "V6")]))
    if n:
        rec["x"], rec["y"], rec["z"] = ints[:, 0], ints[:, 1], ints[:, 2]
        if intensity is not None:
            rec["intensity"] = np.asarray(intensity).astype("<u2")
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(rec.tobytes())
