"""Every public top-level function and class of the JAX package has a twin
in the PyTorch port: the port's module at the same path defines the same
name, or a name of the rename map below, or the name stands in the
not-ported set (TPU machinery with no counterpart on the card).

Both packages are read with `ast`; neither is imported. One case per JAX
module.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "pointclouds_tpu"
PORT_PKG = ROOT / "pointclouds_tpu_torch"

_PALLAS = "spatial/pallas_kernels.py"
_PALLAS_NAMES = (
    "segmented_select", "sor_select", "sweep_select", "sweep_select_rows",
    "rescue_select", "cluster_propagate", "cluster_multisweep",
    "cluster_multisweep_windows", "sweep_moments", "count_within",
    "sweep_knn_select", "nn_argmin", "brute_knn_idx", "brute_radius_count",
    "rescue_knn_idx", "rescue_radius_count_groups", "ransac_score_counts",
    "segmented_scan_sums",
)

# (JAX module, name) -> (port module, name, reason).
RENAMED = {
    ("core/cloud.py", "CloudArrays"): (
        "core/cloud.py", "CloudTensors",
        "the padded cloud holds torch tensors, not JAX arrays"),
    ("spatial/pallas_kernels.py", "segmented_scan_sums_xla"): (
        "spatial/kernels.py", "segmented_scan_sums_plain",
        "the kernel's XLA mirror is its plain torch version"),
    **{(_PALLAS, name): (
        "spatial/kernels.py", name,
        "each Pallas kernel's CUDA wrapper sits in kernels.py")
       for name in _PALLAS_NAMES},
}

# (JAX module, name) -> reason: ROADMAP's "Not ported" TPU machinery.
NOT_PORTED = {
    (_PALLAS, "planar_resident_fits"):
        "VMEM residency gate; the card's kernels have no such limit",
    ("ops/registration.py", "nn_kernel_fits"):
        "VMEM residency gate of the 1-NN kernel",
    ("ops/registration.py", "IcpCarry"):
        "the lax.while_loop carry; the port's ICP loop runs on the host",
}


def _public_defs(path: Path) -> list:
    tree = ast.parse(path.read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
            and not n.name.startswith("_")]


def _all_defs(path: Path) -> set:
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))}


MODULES = sorted(p.relative_to(JAX_PKG).as_posix()
                 for p in JAX_PKG.rglob("*.py"))


def test_maps_name_real_jax_definitions():
    """Every entry of the two maps names a public definition of the JAX
    package, and every rename target a definition of the port."""
    for (mod, name), (pmod, pname, _) in RENAMED.items():
        assert name in _public_defs(JAX_PKG / mod), (mod, name)
        assert pname in _all_defs(PORT_PKG / pmod), (pmod, pname)
    for mod, name in NOT_PORTED:
        assert name in _public_defs(JAX_PKG / mod), (mod, name)


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_twin(module):
    names = _public_defs(JAX_PKG / module)
    port = PORT_PKG / module
    missing = []
    for name in names:
        if (module, name) in NOT_PORTED:
            continue
        pmod, pname = module, name
        if (module, name) in RENAMED:
            pmod, pname, _ = RENAMED[(module, name)]
        target = PORT_PKG / pmod
        if not target.exists() or pname not in _all_defs(target):
            missing.append(f"{name} -> {pmod}::{pname}")
    assert not missing, (f"{module}: no twin in the port for {missing}"
                         + ("" if port.exists() or module == _PALLAS
                            else " (the port has no such module)"))
