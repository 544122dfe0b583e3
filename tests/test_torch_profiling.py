"""`pointclouds_tpu_torch/utils/profiling.py` on the CPU: the same names and
return types as the JAX package's `utils/profiling.py`. Times here are the
host's and are checked only for their order and sign; the launch floor is
the card's, measured by chip_smoke.py."""

import json

import pytest
import torch

from pointclouds_tpu_torch.utils import profiling


def test_time_fn_min_below_p50():
    x = torch.arange(1000, dtype=torch.float32)
    lo, p50 = profiling.time_fn(lambda a: (a * 2).sum(), x, reps=7, warmup=2)
    assert isinstance(lo, float) and isinstance(p50, float)
    assert 0.0 <= lo <= p50


def test_time_fn_excludes_warmup():
    calls = []

    def fn(a):
        calls.append(1)
        return a

    profiling.time_fn(fn, torch.zeros(1), reps=3, warmup=2)
    assert len(calls) == 5


@pytest.mark.parametrize("x", [
    torch.zeros(3),
    (torch.zeros(2), (torch.ones(1), [torch.zeros(4)])),
    {"a": (1, torch.zeros(2))},
    (None, 3.0),
])
def test_sync_accepts_nested_leaves(x):
    assert profiling.sync(x) is None


def test_trace_writes_chrome_trace(tmp_path):
    d = tmp_path / "trace"
    with profiling.trace(str(d)) as got:
        assert got == str(d)
        (torch.ones(64) + 1).sum()
    files = list(d.iterdir())
    assert [f.name for f in files] == ["trace.json"]
    assert "traceEvents" in json.loads(files[0].read_text())


def test_dispatch_floor_cpu_positive():
    ms = profiling.measure_dispatch_floor(reps=5, device="cpu")
    assert isinstance(ms, float) and ms > 0.0


def test_dispatch_floor_default_needs_card():
    """The default device is the card; without one it raises rather than
    measuring the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda-marked case runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.measure_dispatch_floor()


@pytest.mark.cuda
def test_dispatch_floor_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the launch floor is the card's")
    ms = profiling.measure_dispatch_floor()
    assert 0.0 < ms < 100.0
    lo, p50 = profiling.time_fn(lambda: torch.ones(8, device="cuda") + 1)
    assert 0.0 < lo <= p50
