"""The port's tracing (`utils/profiling.py`: `set_tracing`, `frame`, `span`,
`count`, `host_read`) inside the two pipelines, on the CPU at small sizes:
off it records nothing, on it leaves the outputs and the torch operations
as they were, its spans form the frame's tree of stages and phases, and
its counters count where the work happens. One `cuda` case runs a small
frame of each pipeline on the card with every synchronisation outside a
`host_read` raising, so no host read enters the path uncounted; from the
repository root:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_tracing.py

It imports no JAX."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _ranks_torch
import pointclouds_tpu_torch as port
from pointclouds_tpu_torch.parallel.launch import run_ranks
from pointclouds_tpu_torch.pipelines.scenes import aerial_scene, velodyne_scene
from pointclouds_tpu_torch.utils import profiling

VIEWPOINT = [0.0, 0.0, 1e4]
# The benchmark's kwargs (portbench/configs), caps cut to the small clouds,
# the pipelines' defaults, and the other backends.
KITTI = {
    "bench": dict(sor_k=20, ransac_iters=500, ransac_subsample=4096,
                  ds_cap=8192, obstacle_cap=2048, sor_backend="sweep",
                  sor_fix_cap=4096),
    "default": dict(ds_cap=8192, obstacle_cap=2048),
    "xla": dict(ds_cap=8192, obstacle_cap=2048, ransac_subsample=4096,
                sor_backend="xla"),
}
AERIAL = {
    "bench": dict(ds_cap=12_288, obstacle_cap=12_288, ransac_subsample=4096,
                  normals_cell_factor=6, cluster_sweeps=16),
    "rescue": dict(normals_rescue=True),
}
STAGES = {
    ("kitti", "bench"): ["frontend", "sor", "compact", "ransac", "compact",
                         "cluster"],
    ("kitti", "default"): ["frontend", "sor", "compact", "ransac", "compact",
                           "cluster"],
    # The plain front end: rows already in canonical order, no mini-sort.
    ("kitti", "xla"): ["frontend", "sor", "ransac", "compact", "cluster"],
    ("aerial", "bench"): ["frontend", "normals", "ransac", "compact",
                          "cluster"],
    ("aerial", "rescue"): ["frontend", "normals", "ransac", "compact",
                           "cluster"],
}
CASES = sorted(STAGES)


@pytest.fixture(scope="module")
def clouds():
    return {"kitti": velodyne_scene(seed=0, n_points=8192),
            "aerial": aerial_scene(seed=42, scale=0.05)}


@pytest.fixture
def tracing():
    """Tracing on for the test, off afterwards."""
    profiling.set_tracing(True)
    yield
    profiling.set_tracing(False)


def _run(clouds, case, device="cpu", cloud=None):
    pipe, config = case
    c = (port.make_cloud_arrays(clouds[pipe], device=device)
         if cloud is None else cloud)
    if pipe == "kitti":
        return port.kitti_obstacle_pipeline(
            c.xyz, c.valid, np.float32(0.15), np.float32(2.0),
            np.float32(0.15), 3, np.float32(0.8), **KITTI[config])
    return port.aerial_pipeline(
        c.xyz, c.valid, np.float32(0.5), np.float32(3.0), np.float32(0.3), 0,
        np.float32(2.0), VIEWPOINT, **AERIAL[config])


def _traced(clouds, case, device="cpu", cloud=None):
    before = profiling.last_frame()
    out = _run(clouds, case, device, cloud)
    rec = profiling.last_frame()
    assert rec is not None and rec is not before
    return out, rec


_RUNS = {}


def _both(clouds, case):
    """(traced output, its record, the `host_read` calls it made by site,
    untraced output) of ``case``: one run each, kept for the tests that
    read them."""
    if case not in _RUNS:
        calls = collections.Counter()
        real = profiling.host_read

        def spy(site):
            calls[site] += 1
            return real(site)

        profiling.host_read = spy
        profiling.set_tracing(True)
        try:
            on, rec = _traced(clouds, case)
        finally:
            profiling.set_tracing(False)
            profiling.host_read = real
        _RUNS[case] = (on, rec, calls, _run(clouds, case))
    return _RUNS[case]


@pytest.mark.parametrize("case", [("kitti", "bench"), ("aerial", "bench")])
def test_tracing_off_records_nothing(clouds, case):
    profiling.set_tracing(False)
    before = profiling.frames()
    _run(clouds, case)
    after = profiling.frames()
    assert len(after) == len(before)
    assert all(a is b for a, b in zip(after, before))
    # Off, each call is a shared do-nothing context: nothing allocated.
    assert profiling.span("x") is profiling.frame("x") is profiling.host_read(
        "x")
    assert profiling.count("x", 3) is None


@pytest.mark.parametrize("case", CASES)
def test_outputs_bitwise_equal_on_and_off(clouds, case):
    on, _, _, off = _both(clouds, case)
    assert on._fields == off._fields
    for f in on._fields:
        a, b = getattr(on, f), getattr(off, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.parametrize("case", CASES)
def test_span_tree(clouds, case):
    """The root, then the stages in order, children inside their parents,
    one frame id throughout; phases under their stage."""
    _, rec, _, _ = _both(clouds, case)
    spans = rec.spans
    root = spans[0]
    assert root.name == case[0] == rec.name and root.parent == -1
    # The root's own children: the stages, and the voxel size's upload.
    assert [s.name for s in spans if s.parent == 0
            and not s.name.startswith("host_read.")] == STAGES[case]
    for i, s in enumerate(spans):
        assert s.frame == rec.id
        assert 0 < s.t0 <= s.t1
        if i:
            p = spans[s.parent]
            assert s.parent < i
            assert p.t0 <= s.t0 and s.t1 <= p.t1, (p.name, s.name)

    def under(name):
        idx = {i for i, s in enumerate(spans) if s.name == name}
        return {s.name for s in spans if s.parent in idx}

    assert {"ransac.hypotheses", "ransac.inliers"} <= under("ransac")
    assert under("ransac") & {"ransac.score", "ransac.scan"}
    if case[1] in ("bench", "default"):
        assert under("cluster") == {"cluster.structure", "cluster.rounds",
                                    "cluster.epilogue"}
        assert "windows" in under("cluster.structure")
    if case == ("kitti", "bench"):
        assert under("sor") >= {"sor.pass1", "sor.rescue"}
        assert "windows" in under("frontend")
    if case == ("kitti", "default"):
        assert "ransac.scan" in under("ransac")  # under 10K valid points
    # CPU frame: no CUDA events; host ms, a stage's self time within its
    # own.
    assert not any(s.card for s in spans)
    for name in rec.names():
        assert rec.span_ms(name) == pytest.approx(rec.host_ms(name))
        assert -1e-9 <= rec.self_ms(name) <= rec.span_ms(name) + 1e-9
    stages = sum(rec.span_ms(n) for n in set(STAGES[case]))
    assert stages <= rec.span_ms(case[0])
    assert rec.launches == {}  # plain versions on the CPU


@pytest.mark.parametrize("case", CASES)
def test_host_reads_equal_the_host_read_calls(clouds, case):
    _, rec, calls, _ = _both(clouds, case)
    assert rec.count("host_reads") == sum(calls.values()) > 0
    for site, n in calls.items():
        assert len([s for s in rec.spans
                    if s.name == f"host_read.{site}"]) == n
    assert len([s for s in rec.spans if s.name.startswith("host_read.")
                ]) == sum(calls.values())


@pytest.mark.parametrize("case", [("kitti", "bench"), ("aerial", "bench")])
def test_cluster_rounds_counted(clouds, case):
    """Clustering's rounds reach the frame (the plain versions' here); the
    card's round batches and walked pairs are counted on the card."""
    _, rec, _, _ = _both(clouds, case)
    assert rec.count("cluster.rounds") >= 1
    assert rec.count("cluster.round_batches") == 0


def _op_counts(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(e.name for e in prof.events())


@pytest.mark.parametrize("case", [("kitti", "bench"), ("aerial", "bench"),
                                  ("kitti", "default")])
def test_same_torch_operations_on_and_off(clouds, case):
    """A CPU torch.profiler pass over a frame with tracing off and one with
    it on: the same operations, the on pass adding only its own ranges."""
    profiling.set_tracing(False)
    _run(clouds, case)  # warm
    off = _op_counts(lambda: _run(clouds, case))
    profiling.set_tracing(True)
    try:
        on = _op_counts(lambda: _run(clouds, case))
        rec = profiling.last_frame()
    finally:
        profiling.set_tracing(False)
    names = set(rec.names())
    ranges = collections.Counter(s.name for s in rec.spans)
    assert {k: v for k, v in on.items() if k in names} == ranges
    assert {k: v for k, v in on.items() if k not in names} == off
    assert not names & set(off)


def test_nested_frame_is_a_span(tracing):
    """A pipeline called inside an open frame adds its spans to that frame
    (a batch of frames is one record)."""
    with profiling.frame("batch"):
        with profiling.frame("inner"):
            profiling.count("c", 2)
        profiling.count("c")
    rec = profiling.last_frame()
    assert [(s.name, s.parent) for s in rec.spans] == [("batch", -1),
                                                      ("inner", 0)]
    assert rec.count("c") == 3 and rec.count("missing") == 0
    # Outside a frame, spans and counters record nothing.
    assert profiling.span("x") is profiling.host_read("x")
    profiling.count("c")
    assert profiling.last_frame() is rec and rec.count("c") == 3


def test_collectives_counted():
    """`parallel/comm.py` in a world of two gloo CPU ranks: span
    ``comm.<op>`` and counters ``comm.<op>.calls`` / ``comm.<op>.staged``
    (a CPU tensor under gloo is not staged through the host)."""
    for got in run_ranks(_ranks_torch.traced_collectives, 2):
        assert np.array_equal(got["psum"], 2 * np.arange(4.0))
        assert np.array_equal(got["all_gather"], [0.0, 0.0, 1.0, 1.0])
        counts = got["counts"]
        assert counts["comm.psum.calls"] == 2
        assert counts["comm.all_gather.calls"] == 1
        assert "comm.psum.staged" not in counts
        assert got["spans"] == ["mesh", "comm.psum", "comm.psum",
                                "comm.all_gather"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_card_frame_syncs_only_in_host_reads(clouds, case, tracing):
    """One small frame on the card with every synchronisation outside a
    `host_read` raising; then its record: stage CUDA-event ms inside the
    root's, the launches per wrapper, and (where the list rounds run) the
    round batches read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cloud = port.make_cloud_arrays(clouds[case[0]], device="cuda")
    want = _run(clouds, case, cloud=cloud)  # kernels built, caches warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, rec = _traced(clouds, case, cloud=cloud)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for f in out._fields:
        assert torch.equal(getattr(out, f), getattr(want, f)), f
    root = rec.span_ms(case[0])
    assert 0 < sum(rec.span_ms(n) for n in set(STAGES[case])) <= root
    # CUDA events on the root and the stages only; the phases and the host
    # reads keep the host's clock.
    assert {s.name for s in rec.spans if s.card} == {case[0], *STAGES[case]}
    assert all((s.ms is None) != s.card for s in rec.spans)
    assert sum(rec.launches.values()) > 0
    if case[1] != "xla":
        assert rec.count("cluster.round_batches") >= 1
        assert rec.count("cluster.pairs_visited") > 0
