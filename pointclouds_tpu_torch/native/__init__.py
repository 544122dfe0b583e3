"""The port's host C++: the I/O runtime (`pcio.cpp`: LAS decoding, ASCII
xyz parsing, strided f32 gathers), the build-once host cell index
(`pcindex.cpp`, with the canonical cluster epilogue) and the index's
CPython extension (`pcquery.cpp`), with the names and contracts of
`pointclouds_tpu/native/__init__.py`.

Each library is built with g++ at first use into ``build/native/`` at the
repository root, under a name keyed by a hash of its sources, the flags,
the compiler, the Python and numpy versions and the machine, so an edited
source rebuilds and an unchanged one loads the cached file. A build writes
a temporary file and renames it, so processes that start at once never
load a half-written library. No ``-march=native`` and no FMA contraction
(``-ffp-contract=off``): the index's float64 distances then equal the numpy
path's bit for bit, and a library built on one x86-64 host loads on
another.

Failures: where a C++ compiler is found, a failed build raises with its
stderr. Where none is found, every function here returns None and the
callers take their numpy paths; `available()` says which case holds. The
extension needs Python.h and numpy's headers; where they are missing the
index is served through ctypes instead, and `index_kind()` says which one
serves.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import sys
import sysconfig
import threading
from functools import partial
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
             "-ffp-contract=off"]
# Library -> (its translation unit, every source it includes).
_LIBS = {
    "libpcio": ("pcio.cpp", ("pcio.cpp",)),
    "libpcindex": ("pcindex.cpp", ("pcindex.cpp",)),
    "_pcquery": ("pcquery.cpp", ("pcquery.cpp", "pcindex.cpp")),
}


@functools.cache
def _compiler():
    """(g++ path, its version line), or None where there is no compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    out = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                         check=True).stdout
    return cxx, out.splitlines()[0] if out else ""


def _python_includes() -> list | None:
    """The include flags of Python.h and numpy's headers, or None where
    either is missing."""
    py = sysconfig.get_paths()["include"]
    npy = np.get_include()
    if not (Path(py, "Python.h").exists()
            and Path(npy, "numpy", "arrayobject.h").exists()):
        return None
    return [f"-I{py}", f"-I{npy}"]


def _build(name: str, extra: list) -> Path | None:
    """Build library ``name`` once per key; None where there is no
    compiler. Raises with g++'s stderr where the build fails."""
    comp = _compiler()
    if comp is None:
        return None
    cxx, version = comp
    unit, sources = _LIBS[name]
    h = hashlib.sha256()
    for src in sources:
        h.update(src.encode())
        h.update((SRC / src).read_bytes())
    for part in (*CXX_FLAGS, *extra, version, sys.version, np.__version__,
                 platform.machine()):
        h.update(part.encode())
    out = BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, *extra, "-o", str(tmp), str(SRC / unit)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("g++ failed (exit %d):\n%s\n%s"
                           % (proc.returncode, " ".join(cmd), proc.stderr))
    os.replace(tmp, out)
    return out


def _cdll(name: str, signatures: dict):
    path = _build(name, [])
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    for fn, (args, res) in signatures.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = res
    return lib


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_F64 = ctypes.c_double


@functools.cache
def _load():
    """The I/O runtime (libpcio), or None where there is no compiler."""
    return _cdll("libpcio", {
        "pcio_decode_las": ([ctypes.c_char_p, _I64, _I32, _F64, _F64, _F64,
                             _F64, _F64, _F64, _P, _P], ctypes.c_int),
        "pcio_parse_ascii_xyz": ([ctypes.c_char_p, _I64, _P, _I64], _I64),
        "pcio_gather_xyz_f32": ([ctypes.c_char_p, _I64, _I32, _I32, _I32,
                                 _I32, _P], None),
    })


@functools.cache
def _load_index():
    """The host cell index through ctypes (libpcindex), or None where
    there is no compiler."""
    return _cdll("libpcindex", {
        "pcidx_build": ([_P, _P, _I64], _P),
        "pcidx_nvalid": ([_P], _I64),
        "pcidx_free": ([_P], None),
        "pcidx_knn": ([_P, _P, _I64, _P, _P], _I64),
        "pcidx_radius": ([_P, _P, _F64, _P, _I64], _I64),
        "pcidx_knn_batch": ([_P, _P, _I64, _I64, _P, _P, _P], None),
        "pcidx_cluster_epilogue": ([_P, _I64, _I64, _I64, _P, _P], _I64),
    })


@functools.cache
def _load_pcquery():
    """The index's CPython extension (~0.3 us of call overhead a query
    against ~4 through ctypes), or None where there is no compiler or no
    Python.h / numpy headers."""
    inc = _python_includes()
    if inc is None:
        return None
    path = _build("_pcquery", inc)
    if path is None:
        return None
    import importlib.util

    spec = importlib.util.spec_from_file_location("_pcquery", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def get_lib():
    """The I/O runtime (libpcio) through ctypes, or None where there is no
    compiler."""
    return _load()


def available() -> bool:
    """True where the C++ libraries are built (a compiler exists); False
    where the numpy paths serve."""
    return _load() is not None


def index_kind() -> str | None:
    """Which native index `create_index` returns: "_pcquery" (the CPython
    extension), "ctypes", or None (no compiler: the numpy index serves)."""
    if _load_pcquery() is not None:
        return "_pcquery"
    return "ctypes" if _load_index() is not None else None


def decode_las(buf: bytes, n: int, stride: int, scale, offset):
    """(xyz f32[n, 3], intensity f32[n], any non-zero intensity) of ``n``
    LAS point records, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    xyz = np.empty((n, 3), np.float32)
    inten = np.empty((n,), np.float32)
    any_i = lib.pcio_decode_las(
        buf, n, stride, float(scale[0]), float(scale[1]), float(scale[2]),
        float(offset[0]), float(offset[1]), float(offset[2]),
        xyz.ctypes.data_as(_P), inten.ctypes.data_as(_P))
    return xyz, inten, bool(any_i)


def parse_ascii_xyz(text: bytes, max_points: int):
    """xyz f32[count, 3] of whitespace-separated ASCII triples, or None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((max_points, 3), np.float32)
    count = lib.pcio_parse_ascii_xyz(text, len(text), out.ctypes.data_as(_P),
                                     max_points)
    return out[:count].copy()


def gather_xyz_f32(buf: bytes, n: int, stride: int, off_x, off_y, off_z):
    """xyz f32[n, 3] gathered from packed records, or None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((n, 3), np.float32)
    lib.pcio_gather_xyz_f32(buf, n, stride, off_x, off_y, off_z,
                            out.ctypes.data_as(_P))
    return out


class NativeCellIndex:
    """ctypes handle of the C++ host index (pcindex.cpp): the semantics of
    `spatial/hostindex.HostCellIndex` (same grid, exact float64 distances,
    same tie order). Use `create_index`.

    Per-query scratch (query vector, output arrays and their ctypes
    pointers) is thread-local and reused; results are copied out of it, so
    returned arrays stay valid across later queries."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._h = handle
        self._tls = threading.local()

    def __del__(self):
        try:
            self._lib.pcidx_free(self._h)
        except Exception:
            pass

    def nvalid(self) -> int:
        return int(self._lib.pcidx_nvalid(self._h))

    def _scratch(self, k: int):
        s = getattr(self._tls, "s", None)
        if s is None or s[1].shape[0] < k:
            qa = np.empty((3,), np.float64)
            rows = np.empty((max(k, 32),), np.int64)
            dists = np.empty((max(k, 32),), np.float64)
            s = (qa, rows, dists, qa.ctypes.data_as(_P),
                 rows.ctypes.data_as(_P), dists.ctypes.data_as(_P))
            self._tls.s = s
        return s

    @staticmethod
    def _fill_query(qa, q):
        try:
            qa[:] = q
        except ValueError:  # e.g. a [1, 3]-shaped query
            qa[:] = np.asarray(q, np.float64).reshape(3)

    def knn(self, q, k: int):
        qa, rows, dists, qp, rp, dp = self._scratch(k)
        self._fill_query(qa, q)
        cnt = self._lib.pcidx_knn(self._h, qp, k, rp, dp)
        return rows[:cnt].copy(), dists[:cnt].copy()

    def knn_batch(self, qs, k: int):
        """(rows i64[nq, k], dists f64[nq, k], counts i64[nq]) in one C
        call; entries past counts[i] are garbage (callers mask)."""
        qa = np.ascontiguousarray(np.asarray(qs, np.float64).reshape(-1, 3))
        nq = qa.shape[0]
        rows = np.empty((nq, k), np.int64)
        dists = np.empty((nq, k), np.float64)
        counts = np.empty((nq,), np.int64)
        self._lib.pcidx_knn_batch(
            self._h, qa.ctypes.data_as(_P), nq, k, rows.ctypes.data_as(_P),
            dists.ctypes.data_as(_P), counts.ctypes.data_as(_P))
        return rows, dists, counts

    def radius(self, q, radius: float):
        qa, _, _, qp, _, _ = self._scratch(1)
        self._fill_query(qa, q)
        hits = getattr(self._tls, "hits", None)
        if hits is None:
            buf = np.empty((256,), np.int64)
            hits = self._tls.hits = (buf, buf.ctypes.data_as(_P))
        while True:
            buf, bp = hits
            cnt = self._lib.pcidx_radius(self._h, qp, float(radius), bp,
                                         buf.shape[0])
            if cnt <= buf.shape[0]:
                return buf[:cnt].copy()
            grown = np.empty((int(cnt),), np.int64)
            hits = self._tls.hits = (grown, grown.ctypes.data_as(_P))


class ExtCellIndex:
    """CPython-extension handle of the same C++ index (pcquery.cpp compiles
    pcindex.cpp into itself): the semantics of `NativeCellIndex`, with
    less overhead a call."""

    def __init__(self, mod, caps):
        self._mod = mod
        self._caps = caps
        # Direct entry points: no Python frame between the caller and C.
        self.knn = partial(mod.knn, caps)
        self.radius = partial(mod.radius, caps)

    def nvalid(self) -> int:
        return int(self._mod.nvalid(self._caps))

    def knn_batch(self, qs, k: int):
        qa = np.ascontiguousarray(np.asarray(qs, np.float64).reshape(-1, 3))
        return self._mod.knn_batch(self._caps, qa, int(k))


def cluster_epilogue(labels, min_size: int, max_size: int):
    """Rows grouped by component label in the reference's canonical order
    (size descending, then first member; members ascending), keeping the
    components whose size lies in [min_size, max_size]: (order i32[n],
    starts i64[k + 1]), cluster c being order[starts[c]:starts[c + 1]]; or
    None without the library (callers keep the numpy epilogue)."""
    lib = _load_index()
    if lib is None:
        return None
    lab = np.ascontiguousarray(np.asarray(labels, np.int32))
    n = lab.shape[0]
    order = np.empty((n,), np.int32)
    starts = np.empty((n + 1,), np.int64)
    k = lib.pcidx_cluster_epilogue(lab.ctypes.data_as(_P), n, int(min_size),
                                   int(max_size), order.ctypes.data_as(_P),
                                   starts.ctypes.data_as(_P))
    return order, starts[: k + 1]


def create_index(xyz, valid):
    """A native host index over (xyz f32[N, 3], valid bool[N]): the CPython
    extension where it builds, else the ctypes handle; None without a
    compiler."""
    xyz = np.ascontiguousarray(np.asarray(xyz, np.float32))
    v = np.ascontiguousarray(np.asarray(valid, np.uint8))
    mod = _load_pcquery()
    if mod is not None:
        return ExtCellIndex(mod, mod.build(xyz, v))
    lib = _load_index()
    if lib is None:
        return None
    return NativeCellIndex(lib, lib.pcidx_build(xyz.ctypes.data_as(_P),
                                                v.ctypes.data_as(_P),
                                                xyz.shape[0]))
