"""Build the port's CUDA kernels at first use and load them with ctypes.

All ``csrc/*.cu`` files compile with ``nvcc`` into ONE shared library with a
plain C interface (no PyTorch headers: seconds, not minutes), written to
``build/kernels/`` at the repository root under a name keyed by a hash of
the sources, so an edited source rebuilds and an unchanged one loads the
cached library. Each source compiles in its own nvcc process, all started
together, then one link. Pointers and the stream cross as ``c_void_p``. A
failed build raises with nvcc's stderr; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "pc_max_k": ([], _I),
    "pc_segscan5": ([_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _P],
                    _I),
    "pc_sweep_select_rows": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "pc_rescue_select": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "pc_cluster_rounds_lists": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 ctypes.c_float, _I, _I, _P], _I),
    "pc_ransac_score_counts": ([_P, _P, _P, _I, _I, _P, _P, _P], _I),
    "pc_sweep_moments": ([_P, _P, _P, _I, _I, ctypes.c_float,
                          ctypes.c_float, _P], _I),
    "pc_rescue_knn_idx": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "pc_cluster_rounds_windows": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   ctypes.c_float, _I, _I, _P], _I),
    "pc_sweep_select": ([_P, _P, _P, _I, _I, _P], _I),
    "pc_count_within": ([_P, _P, _P, _I, _P], _I),
    "pc_rescue_radius_count": ([_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
                               _I),
    "pc_brute_radius_count": ([_P, _P, _P, _I, _I, _P, _P, _P], _I),
    "pc_brute_knn_idx": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "pc_sweep_knn_select": ([_P, _P, _P, _P, _I, _I, _P], _I),
    "pc_nn_argmin": ([_P, _P, _P, _I, _I, _P, _P, _P], _I),
    "pc_cluster_propagate": ([_P, _P, _P, _P, _I, ctypes.c_float, _P], _I),
    "pc_sor_select": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "pc_segmented_select": ([_P, _P, ctypes.c_longlong, _I, _I, _P], _I),
    "pc_ransac_hypotheses": ([_P, _P, _P, _P, _I, ctypes.c_uint32,
                              ctypes.c_uint32, _P], _I),
}


class KernelLibrary:
    """The loaded library plus what its build reported."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.lib = ctypes.CDLL(str(path))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = args
            fn.restype = res

    def call(self, name: str, *args) -> None:
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed: CUDA error {err}")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise with the first failure's stderr.
    Returns their combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (o, e) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError("nvcc failed (exit %d):\n%s\n%s"
                               % (p.returncode, " ".join(cmd), e))
    return "".join(o + e for o, e in outs)


def _compile(out: Path) -> str:
    """One nvcc per source, all at once, then one link into ``out``."""
    nvcc = _nvcc()
    tag = f"{out.name}.{os.getpid()}"
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f".{tag}.{p.stem}.o" for p in srcs]
    tmp = BUILD_DIR / f".{tag}.tmp"
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                        for p, o in zip(srcs, objs)])
        log += _run_all([[nvcc, "-shared", "-o", str(tmp),
                          *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return log


@functools.cache
def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library; loaded
    once per process."""
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libpc_kernels_{key}.so"
    log_path = BUILD_DIR / f"libpc_kernels_{key}.log"
    t0 = time.perf_counter()
    if not out.exists():
        log_path.write_text(_compile(out))
    build_seconds = time.perf_counter() - t0
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(out, build_seconds, log)
