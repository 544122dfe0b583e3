"""What a run may not do: measure without a card, or load JAX or the JAX
package (whose name begins the port's: names are compared whole, before
the first dot)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def no_card_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    res = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "kitti-hdl64.stream", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=no_card_env(), capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_run_from_benchmark_files_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "kitti-hdl64.stream", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, env=no_card_env(), capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pointclouds_tpu_torch_x", sys)
    assert "pointclouds_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pointclouds_tpu.api", sys)
    assert "pointclouds_tpu.api" in harness.forbidden_modules()


SCRIPT = """
import json, sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from _portbench_tiny import tiny_checkout
from pathlib import Path
from portbench import harness
root = tiny_checkout(Path({tmp!r}))
harness.run("kitti-hdl64.stream", 5, 0.2, False, t_start=time.perf_counter(),
            device="cpu", root=root, bench=root)
print(json.dumps(sorted(sys.modules)))
"""


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    """A whole (CPU, tiny) run in a fresh process: no loaded module has the
    top-level name jax, jaxlib, flax or pointclouds_tpu."""
    code = SCRIPT.format(root=str(ROOT), tests=str(Path(__file__).parent),
                         tmp=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=no_card_env(), capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    tops = {m.split(".", 1)[0] for m in loaded}
    assert "pointclouds_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    """On the card: one cell for two seconds gives a correct result line."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "kitti-hdl64.stream", "--seed", "17", "--seconds", "2", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
