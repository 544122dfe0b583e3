"""PCD (Point Cloud Data) reader/writer, numpy-vectorized.

Behavioral port of the reference PCD module (ref: crates/io/src/pcd.rs):
- reads ASCII and binary v0.7 files; POINTS count with WIDTH fallback
  (ref :152-188); FIELDS parse with x y z default (ref :190-200)
- ASCII read takes the first 3 whitespace columns, unparsable values
  become 0.0, short lines are skipped (ref :202-234)
- binary read assumes every field is a 4-byte little-endian f32 and locates
  x/y/z by field name (ref :236-308)
- writers emit FIELDS x y z only (normals/colors are NOT written,
  ref :23-71)

All failures raise OSError (the Python layer surfaces IOError like the
reference bindings, ref: crates/python/src/io.rs).

Copied from `pointclouds_tpu/io/pcd.py`: the ASCII and binary bodies go
through the host C++ (`native/pcio.cpp`: a multithreaded float parser and a
strided gather) where it is built; the numpy paths below have the same
semantics and serve where there is no compiler.
"""

from __future__ import annotations

import io as _stdio

import numpy as np

from .. import native as _native


def _parse_header(raw: bytes):
    """Scan for the DATA line byte-safely and parse header fields."""
    idx = raw.find(b"DATA")
    if idx < 0:
        raise OSError("PCD file missing DATA line")
    line_end = raw.find(b"\n", idx)
    if line_end < 0:
        raise OSError("PCD DATA line not terminated")
    header_text = raw[:line_end].decode("utf-8", errors="replace")
    data_offset = line_end + 1

    fmt = None
    points = None
    width = None
    fields = None
    for line in header_text.splitlines():
        t = line.strip()
        if t.startswith("DATA"):
            parts = t.split()
            if len(parts) >= 2:
                fmt = parts[1].lower()
        elif t.startswith("POINTS"):
            parts = t.split()
            if len(parts) >= 2:
                try:
                    points = int(parts[1])
                except ValueError as e:
                    raise OSError(f"invalid POINTS value: {e}")
        elif t.startswith("WIDTH"):
            parts = t.split()
            if len(parts) >= 2:
                try:
                    width = int(parts[1])
                except ValueError as e:
                    raise OSError(f"invalid WIDTH value: {e}")
        elif t.startswith("FIELDS"):
            fields = t.split()[1:]

    if fmt not in ("ascii", "binary"):
        raise OSError(f"unsupported or missing PCD DATA format: {fmt}")
    if points is None:
        points = width
    if points is None:
        raise OSError("PCD file missing POINTS/WIDTH header")
    if fields is None:
        fields = ["x", "y", "z"]
    return fmt, points, fields, data_offset


def read_pcd(path: str):
    """Returns xyz float32[N, 3]."""
    with open(path, "rb") as f:
        raw = f.read()
    fmt, num_points, fields, data_offset = _parse_header(raw)

    if fmt == "ascii":
        body_bytes = raw[data_offset:]
        fast = _native.parse_ascii_xyz(body_bytes,
                                       body_bytes.count(b"\n") + 1)
        if fast is not None:
            return fast
        body = body_bytes.decode("utf-8")
        rows = []
        for line in body.splitlines():
            t = line.strip()
            if not t or t.startswith("#"):
                continue
            parts = t.split()
            if len(parts) < 3:
                continue
            vals = []
            for p in parts[:3]:
                try:
                    vals.append(float(p))
                except ValueError:
                    vals.append(0.0)  # parse errors -> 0.0 (ref :214-218)
            rows.append(vals)
        if not rows:
            return np.zeros((0, 3), np.float32)
        return np.asarray(rows, dtype=np.float32)

    # binary
    num_fields = len(fields)
    point_size = num_fields * 4
    expected = num_points * point_size
    data = raw[data_offset:]
    if len(data) < expected:
        raise OSError(
            f"binary PCD data too short: have {len(data)} bytes, expected "
            f"{expected} ({num_points} points x {num_fields} fields x 4)"
        )
    try:
        ix, iy, iz = fields.index("x"), fields.index("y"), fields.index("z")
    except ValueError:
        raise OSError("binary PCD file missing x, y, z fields")
    fast = _native.gather_xyz_f32(data[:expected], num_points, point_size,
                                  ix * 4, iy * 4, iz * 4)
    if fast is not None:
        return fast
    arr = np.frombuffer(data[:expected], dtype="<f4").reshape(num_points, num_fields)
    return np.ascontiguousarray(arr[:, [ix, iy, iz]]).astype(np.float32)


def _format_f32(v: float) -> str:
    """Rust's {} float formatting: shortest representation that round-trips."""
    return np.format_float_positional(np.float32(v), unique=True, trim='-')


def _header(n: int, data_line: str) -> str:
    return (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z\n"
        "SIZE 4 4 4\n"
        "TYPE F F F\n"
        "COUNT 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {data_line}\n"
    )


def write_pcd(path: str, xyz: np.ndarray):
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    buf = _stdio.StringIO()
    buf.write(_header(xyz.shape[0], "ascii"))
    for row in xyz:
        buf.write(f"{_format_f32(row[0])} {_format_f32(row[1])} {_format_f32(row[2])}\n")
    with open(path, "w") as f:
        f.write(buf.getvalue())


def write_pcd_binary(path: str, xyz: np.ndarray):
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    with open(path, "wb") as f:
        f.write(_header(xyz.shape[0], "binary").encode())
        f.write(np.ascontiguousarray(xyz, "<f4").tobytes())
