"""PLY reader/writer, numpy-vectorized.

Behavioral port of the reference PLY module (ref: crates/io/src/ply.rs):
ASCII and binary_little_endian formats, x/y/z required, nx/ny/nz and
red/green/blue optional. One deliberate fix over the reference: ``double``
properties are read as true 8-byte doubles and cast to f32, instead of the
reference's latent 4-byte misread (ref: ply.rs:113 — flagged in SURVEY.md C19
as "do not replicate").

Copied from `pointclouds_tpu/io/ply.py`.
"""

from __future__ import annotations

import numpy as np

_TYPE_MAP = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "uchar": "u1",
    "uint8": "u1",
}


def _parse_header(raw: bytes):
    end_marker = b"end_header\n"
    pos = raw.find(end_marker)
    if pos < 0:
        raise OSError("missing end_header in PLY file")
    body_offset = pos + len(end_marker)
    try:
        text = raw[:pos].decode("utf-8")
    except UnicodeDecodeError:
        raise OSError("PLY header not valid UTF-8")

    fmt = None
    vertex_count = 0
    names: list[str] = []
    dtypes: list[str] = []
    in_vertex = False
    seen_magic = False
    for line in text.splitlines():
        line = line.strip()
        if not seen_magic:
            if line == "ply":
                seen_magic = True
                continue
            raise OSError("file does not start with 'ply'")
        if line.startswith("format"):
            if "ascii" in line:
                fmt = "ascii"
            elif "binary_little_endian" in line:
                fmt = "binary_little_endian"
            else:
                raise OSError(f"unsupported PLY format: {line}")
        elif line.startswith("element vertex"):
            in_vertex = True
            parts = line.split()
            if len(parts) < 3:
                raise OSError("invalid element vertex line")
            try:
                vertex_count = int(parts[2])
            except ValueError as e:
                raise OSError(f"invalid vertex count: {e}")
        elif line.startswith("element"):
            in_vertex = False
        elif line.startswith("property") and in_vertex:
            parts = line.split()
            if len(parts) >= 3:
                if parts[1] not in _TYPE_MAP:
                    raise OSError(f"unsupported property type: {parts[1]}")
                dtypes.append(_TYPE_MAP[parts[1]])
                names.append(parts[2])
    if fmt is None:
        raise OSError("PLY format line missing")
    return fmt, vertex_count, names, dtypes, body_offset


def read_ply(path: str):
    """Returns (xyz f32[N,3], normals f32[N,3]|None, colors u8[N,3]|None)."""
    with open(path, "rb") as f:
        raw = f.read()
    fmt, n, names, dtypes, body_offset = _parse_header(raw)

    for req in ("x", "y", "z"):
        if req not in names:
            raise OSError("PLY file missing required x, y, z properties")

    has_normals = all(k in names for k in ("nx", "ny", "nz"))
    has_colors = all(k in names for k in ("red", "green", "blue"))

    if fmt == "ascii":
        body = raw[body_offset:].decode("utf-8")
        rows = []
        for line in body.splitlines():
            if len(rows) >= n:
                break
            t = line.strip()
            if not t:
                continue
            rows.append(t.split())
        if len(rows) < n:
            raise OSError("PLY body has fewer vertices than declared")
        cols = {name: i for i, name in enumerate(names)}
        table = np.array(
            [[float(r[cols[name]]) for name in names] for r in rows],
            dtype=np.float64,
        )

        def col(name):
            return table[:, cols[name]]

    else:
        dtype = np.dtype([(f"f{i}", dt) for i, dt in enumerate(dtypes)])
        expected = n * dtype.itemsize
        data = raw[body_offset:]
        if len(data) < expected:
            raise OSError("PLY binary body too short")
        rec = np.frombuffer(data[:expected], dtype=dtype)
        cols = {name: f"f{i}" for i, name in enumerate(names)}

        def col(name):
            return rec[cols[name]].astype(np.float64)

    xyz = np.stack([col("x"), col("y"), col("z")], axis=1).astype(np.float32)
    normals = None
    colors = None
    if has_normals:
        normals = np.stack([col("nx"), col("ny"), col("nz")], axis=1).astype(
            np.float32
        )
    if has_colors:
        colors = np.stack(
            [col("red"), col("green"), col("blue")], axis=1
        ).astype(np.uint8)
    return xyz, normals, colors


def _fmt(v: float) -> str:
    return np.format_float_positional(np.float32(v), unique=True, trim='-')


def _write_header(f, n, has_normals, has_colors, binary: bool):
    f.write(b"ply\n")
    f.write(
        b"format binary_little_endian 1.0\n" if binary else b"format ascii 1.0\n"
    )
    f.write(f"element vertex {n}\n".encode())
    f.write(b"property float x\nproperty float y\nproperty float z\n")
    if has_normals:
        f.write(b"property float nx\nproperty float ny\nproperty float nz\n")
    if has_colors:
        f.write(b"property uchar red\nproperty uchar green\nproperty uchar blue\n")
    f.write(b"end_header\n")


def write_ply(path: str, xyz, normals=None, colors=None):
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    with open(path, "wb") as f:
        _write_header(f, n, normals is not None, colors is not None, binary=False)
        lines = []
        for i in range(n):
            parts = [_fmt(xyz[i, 0]), _fmt(xyz[i, 1]), _fmt(xyz[i, 2])]
            if normals is not None:
                parts += [_fmt(normals[i, j]) for j in range(3)]
            if colors is not None:
                parts += [str(int(colors[i, j])) for j in range(3)]
            lines.append(" ".join(parts))
        f.write(("\n".join(lines) + ("\n" if lines else "")).encode())


def write_ply_binary(path: str, xyz, normals=None, colors=None):
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if normals is not None:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.zeros(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if normals is not None:
        normals = np.asarray(normals, np.float32).reshape(-1, 3)
        rec["nx"], rec["ny"], rec["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if colors is not None:
        colors = np.asarray(colors, np.uint8).reshape(-1, 3)
        rec["red"], rec["green"], rec["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]
    with open(path, "wb") as f:
        _write_header(f, n, normals is not None, colors is not None, binary=True)
        f.write(rec.tobytes())
