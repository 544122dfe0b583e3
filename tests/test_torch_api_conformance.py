"""The reference's own binding tests (`tests/test_reference_bindings.py`),
all 36, run against the PyTorch port: ``pointclouds_rs``
is bound to `pointclouds_tpu_torch.api` with clouds made on the CPU, for
the duration of each test, and the reference file itself is left as it is.
"""

import importlib.util
import inspect
import sys
import types
from pathlib import Path

import pytest

from pointclouds_tpu_torch import api

_REF = Path(__file__).with_name("test_reference_bindings.py")
_spec = importlib.util.spec_from_file_location("_reference_bindings", _REF)
reference = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference)

PORTED = [
    "test_import",
    "test_pointcloud_create_empty",
    "test_pointcloud_from_numpy",
    "test_pointcloud_roundtrip_numpy",
    "test_pointcloud_from_numpy_f64",
    "test_pointcloud_fortran_order_rejected",
    "test_pointcloud_repr",
    "test_voxel_downsample",
    "test_voxel_downsample_invalid_size",
    "test_passthrough_filter",
    "test_passthrough_filter_invalid_axis",
    "test_statistical_outlier_removal",
    "test_radius_outlier_removal",
    "test_estimate_normals",
    "test_icp_point_to_point",
    "test_icp_point_to_plane",
    "test_icp_point_to_plane_no_normals",
    "test_euclidean_cluster",
    "test_ransac_plane",
    "test_read_write_pcd",
    "test_read_write_ply",
    "test_read_write_ply_binary",
    "test_read_las_nonexistent",
    "test_read_las_available",
    "test_empty_cloud_to_numpy",
    "test_from_numpy_wrong_shape",
    "test_from_numpy_wrong_columns",
    "test_from_numpy_nan_values",
    "test_from_numpy_inf_values",
    "test_voxel_downsample_very_large_voxel",
    "test_voxel_downsample_very_small_voxel",
    "test_icp_identical_clouds",
    "test_ransac_with_only_3_points",
    "test_euclidean_cluster_single_point",
    "test_estimate_normals_two_points",
    "test_passthrough_filter_all_filtered",
]


def test_every_reference_test_is_ported():
    names = {n for n in dir(reference) if n.startswith("test_")}
    assert names == set(PORTED)


@pytest.fixture
def port_as_pointclouds_rs(monkeypatch):
    shim = types.ModuleType("pointclouds_rs")
    for name in api.__all__:
        setattr(shim, name, getattr(api, name))
    monkeypatch.setitem(sys.modules, "pointclouds_rs", shim)
    monkeypatch.setattr(api, "DEFAULT_DEVICE", "cpu")
    return shim


@pytest.mark.parametrize("name", PORTED)
def test_reference_binding_on_port(name, port_as_pointclouds_rs, tmp_path):
    fn = getattr(reference, name)
    # The file tests take pytest's tmp_path.
    fn(*([tmp_path] if inspect.signature(fn).parameters else []))
    import pointclouds_rs

    assert pointclouds_rs is port_as_pointclouds_rs
