#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `pointclouds_tpu_torch.kitti_obstacle_pipeline` on the card at the
benchmark configuration (a 122K-point Velodyne-style frame, voxel 0.15 m,
ds_cap 98,304, k 20, 500 RANSAC iterations on a 4096-point subsample,
obstacle cap 8192, cluster radius 0.8 m). Phases:

1. probe: the card, torch/CUDA/nvcc versions; build the kernels;
2. per kernel, at the shapes the pipeline gives it (inputs captured from
   the port's own upstream stages): the CUDA kernel against its plain
   torch version on the card, and both timed with CUDA events;
3. end to end on the benchmark's frame (velodyne_scene seed 0) with
   RANSAC seeds 0-4, as bench.py varies them: every kernel launched, no
   overflow flag, sor_certified, >= 3 clusters, cluster sets equal to the
   port's own CPU run of the same frame and seed; then per-stage times and
   the frame p50.

Prints the kernels' JSON line, the card's name and power limit, and as its
last line {"ok": true, "device": {...}}. Any failure raises (exit != 0);
without a CUDA device it exits non-zero before measuring anything. Long
output (build log) goes to chiprun_out/.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
PALLAS = "pointclouds_tpu/spatial/pallas_kernels.py"
KERNELS = {
    # name: (module that calls it, CUDA source, Pallas wrapper line)
    "segmented_scan_sums": ("ops.filters", "segscan.cu", 3370),
    "sweep_select_rows": ("spatial.sweep", "select.cu", 694),
    "rescue_select": ("spatial.sweep", "select.cu", 835),
    "cluster_multisweep": ("spatial.sweep", "cluster.cu", 1253),
}
PARAMS = dict(voxel=0.15, sor_std=2.0, ransac_thresh=0.15, cluster_r=0.8,
              sor_k=20, ransac_iters=500, ds_cap=98_304,
              ransac_subsample=4096, obstacle_cap=8192)
N_POINTS = 122_000
SEEDS = range(5)
FRAMES = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def run_pipeline(pc, data, seed, device=None, cloud=None):
    """One frame at the bench configuration, on ``device`` or on a cloud
    already made there."""
    if cloud is None:
        cloud = pc.make_cloud_arrays(data, device=device)
    return pc.kitti_obstacle_pipeline(
        cloud.xyz, cloud.valid, np.float32(PARAMS["voxel"]),
        np.float32(PARAMS["sor_std"]), np.float32(PARAMS["ransac_thresh"]),
        seed, np.float32(PARAMS["cluster_r"]), sor_k=PARAMS["sor_k"],
        ransac_iters=PARAMS["ransac_iters"], ds_cap=PARAMS["ds_cap"],
        ransac_subsample=PARAMS["ransac_subsample"],
        obstacle_cap=PARAMS["obstacle_cap"],
    )


def cluster_points(pc, out):
    """Cluster sets as sorted point coordinates (geometric equality)."""
    clusters = pc.extract_clusters(out, 10, 20_000)
    cents = out.centroids.cpu().numpy()[out.obstacle_src.cpu().numpy()]
    slots = np.nonzero(out.obstacle_valid.cpu().numpy())[0]
    return [np.sort(cents[slots[c]], axis=0) for c in clusters]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture_inputs(pc, data):
    """Run one frame with the kernel wrappers wrapped where the pipeline
    calls them; keep each kernel's first arguments."""
    import importlib

    captured = {}
    saved = []
    for name, (modname, _, _) in KERNELS.items():
        mod = importlib.import_module(f"pointclouds_tpu_torch.{modname}")
        orig = getattr(mod, name)

        def wrapped(*args, _name=name, _orig=orig, **kwargs):
            if _name not in captured:
                captured[_name] = (
                    tuple(a.clone() if torch.is_tensor(a) else a
                          for a in args), dict(kwargs))
            return _orig(*args, **kwargs)

        saved.append((mod, name, orig))
        setattr(mod, name, wrapped)
    try:
        run_pipeline(pc, data, 0, "cuda")
        torch.cuda.synchronize()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    missing = set(KERNELS) - set(captured)
    if missing:
        raise RuntimeError(f"pipeline never called {sorted(missing)}")
    return captured


def check_kernel(name, args, kwargs, K):
    """The kernel and its plain version on the same card inputs."""
    plain = getattr(K, f"{name}_plain")
    kern = getattr(K, name)
    got = kern(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    if name == "segmented_scan_sums":
        # Bitwise: centroids feed every later discrete decision.
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: not bitwise equal")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        tol = "bitwise"
    elif name == "cluster_multisweep":
        if bool(got[1].any()) or bool(want[1].any()):
            raise AssertionError(f"{name}: did not converge")
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"{name}: labels differ")
        err = float((got[0] - want[0]).abs().max())
        tol = "labels equal"
    else:
        # Exact top-k in the same order: count, kth and the ascending sum
        # are bitwise equal.
        for g, w, what in zip(got[:3], want[:3], ("total", "count", "kth")):
            if not torch.equal(g, w):
                d = float((g - w).abs().max())
                raise AssertionError(f"{name}: {what} differs by {d}")
        if not bool(got[3].all()):
            raise AssertionError(f"{name}: ok not all true")
        err = max(float((g - w).abs().max())
                  for g, w in zip(got[:3], want[:3]))
        tol = "bitwise (total, count, kth)"
    reps_k, reps_p = (20, 3) if name != "cluster_multisweep" else (5, 1)
    ms = cuda_ms(lambda: kern(*args, **kwargs), reps_k)
    plain_ms = cuda_ms(lambda: plain(*args, **kwargs), reps_p)
    return err, tol, ms, plain_ms


def stage_timer(kitti_mod):
    """Wrap the pipeline's stage functions in its module so each records a
    CUDA event pair; returns (restore, read) callables."""
    stages = ["voxel_downsample_sweep_fused", "structure_from_sorted",
              "sweep_sor_two_pass", "sor_keep_mask_thr",
              "ransac_plane_masked", "sweep_cluster_labels"]
    events = {s: [] for s in stages}
    saved = []
    for s in stages:
        orig = getattr(kitti_mod, s)

        def wrapped(*a, _s=s, _orig=orig, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            r = _orig(*a, **k)
            e1.record()
            events[_s].append((e0, e1))
            return r

        saved.append((s, orig))
        setattr(kitti_mod, s, wrapped)

    def restore():
        for s, orig in saved:
            setattr(kitti_mod, s, orig)

    def read():
        torch.cuda.synchronize()
        return {s: float(np.median([a.elapsed_time(b) for a, b in ev]))
                for s, ev in events.items() if ev}

    return restore, read


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pointclouds_tpu_torch as pc
    from pointclouds_tpu_torch.pipelines import kitti as kitti_mod
    from pointclouds_tpu_torch.pipelines.scenes import velodyne_scene
    from pointclouds_tpu_torch.spatial import _build
    from pointclouds_tpu_torch.spatial import kernels as K

    # ── Phase 1: probe + build ──
    card_line = card()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"probe: card={card_line} torch={torch.__version__} "
        f"cuda={torch.version.cuda} nvcc={nvcc[-1]} "
        f"device={torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()}")
    lib = _build.library()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "kernel_build.log").write_text(lib.log)
    log(f"build: {lib.path.name} from {sorted(p.name for p in _build._sources())}"
        f" in {lib.build_seconds:.1f} s (max k {lib.lib.pc_max_k()})")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ── Phase 2: each kernel against its plain version, bench shapes ──
    data = velodyne_scene(seed=0, n_points=N_POINTS)
    captured = capture_inputs(pc, data)
    rows = []
    for name, (_, src, line) in KERNELS.items():
        args, kwargs = captured[name]
        err, tol, ms, plain_ms = check_kernel(name, args, kwargs, K)
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        log(f"kernel {name}: shapes={shapes} agrees ({tol}, max_abs_err="
            f"{err}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"[{card_line}]")
        rows.append(dict(name=name, route="cuda",
                         source=f"pointclouds_tpu_torch/spatial/csrc/{src}",
                         replaces=f"{PALLAS}:{line}", max_abs_err=err,
                         ms=ms, plain_ms=plain_ms))

    # ── Phase 3: end to end ──
    K.reset_launch_counts()
    outs = {}
    for seed in SEEDS:
        outs[seed] = run_pipeline(pc, data, seed, "cuda")
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    log(f"e2e launches over {len(SEEDS)} frames: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    for seed, out in outs.items():
        flags = out.grid_flags.cpu().numpy()
        gpu_sets = cluster_points(pc, out)
        cpu_out = run_pipeline(pc, data, seed, "cpu")
        cpu_sets = cluster_points(pc, cpu_out)
        log(f"e2e seed {seed}: ds={int(out.downsampled_valid.sum())} "
            f"kept={int(out.cleaned_valid.sum())} "
            f"inliers={int(out.inlier_mask.sum())} "
            f"clusters={[len(c) for c in gpu_sets]} "
            f"cpu_clusters={[len(c) for c in cpu_sets]} "
            f"sor_certified={bool(out.sor_certified)} "
            f"grid_flags={flags.tolist()} "
            f"obstacle_overflow={bool(out.obstacle_overflow)}")
        if flags.any() or bool(out.obstacle_overflow):
            raise AssertionError(f"seed {seed}: overflow flags set")
        if not bool(out.sor_certified):
            raise AssertionError(f"seed {seed}: SOR not certified")
        if len(gpu_sets) < 3:
            raise AssertionError(f"seed {seed}: fewer than 3 clusters")
        if not torch.equal(out.centroids.cpu(), cpu_out.centroids):
            raise AssertionError(f"seed {seed}: centroids differ from CPU")
        if len(gpu_sets) != len(cpu_sets) or not all(
                np.array_equal(a, b) for a, b in zip(gpu_sets, cpu_sets)):
            raise AssertionError(f"seed {seed}: clusters differ from CPU")

    times = []
    restore, read = stage_timer(kitti_mod)
    try:
        for f in range(FRAMES):
            cloud = pc.make_cloud_arrays(data, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_pipeline(pc, data, f, cloud=cloud)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        stages = read()
    finally:
        restore()
    log("e2e stage ms (median, CUDA events): " + ", ".join(
        f"{s}={v:.3f}" for s, v in stages.items()) + f" [{card_line}]")
    log(f"e2e frame p50 {float(np.percentile(times, 50)):.3f} ms over "
        f"{FRAMES} frames (min {min(times):.3f}, max {max(times):.3f}) "
        f"[{card_line}]")

    for r in rows:
        r["launches"] = launches[r["name"]]
    log(json.dumps({"kernels": rows}))
    log(card_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
