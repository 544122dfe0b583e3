#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `pointclouds_tpu_torch` on the card through its two pipelines, at
the benchmark's configurations, and through its per-op API:

- KITTI: `kitti_obstacle_pipeline` on a 122K-point Velodyne-style frame,
  voxel 0.15 m, ds_cap 98,304, k 20, 500 RANSAC iterations on a 4096-point
  subsample, obstacle cap 8192, cluster radius 0.8 m;
- aerial: `aerial_pipeline` on `aerial_scene(42)` (~241K points), voxel
  0.5 m, ds_cap 229,376, normals k 15 in a 6-voxel (3.0 m) cell, 300
  RANSAC iterations on a 4096-point subsample, threshold 0.3, obstacle cap
  196,608, cluster radius 2.0 m in bursts of 16 rounds, viewpoint
  (0, 0, 10000).

Phases:

1. probe: the card, torch/CUDA/nvcc versions; build the kernels;
2. per kernel, at the shapes the pipelines give it (inputs captured from
   the port's own upstream stages): the CUDA kernel against its plain
   torch version on the card, and both timed with CUDA events, with the
   work the warp-select kernels see (live blocks, valid queries, rows or
   groups a block walks), the cluster loops' rounds beside the plain
   version's (kernel 4's bound counts the plain version's Jacobi rounds,
   a yardstick that does not move with the kernel's design);
   `sweep_moments` and `rescue_knn_idx` also at
   the normals op's inputs on phase 6's 100K cloud, `brute_knn_idx` also
   at the overflow SOR op's (4,096 live queries) and at the clean 100K
   SOR op's (no live block), `brute_radius_count` also at the noisy ROR
   op's own call (no live block; with its device time and device
   launches a call), `rescue_radius_count_groups` also at the noisy ROR
   op's own call (2 live blocks of 32) and `ransac_score_counts` also at
   the RANSAC op's on the 10K slab (128 rows), each with its device time,
   device launches, registers and shared memory a call at both captures,
   `segmented_scan_sums` also at the 1M voxel
   op's (16 tiles), with its device time and device launches a call at
   both (phase2.json);
3. KITTI end to end with RANSAC seeds 0-4: every KITTI kernel launched, no
   overflow flag, sor_certified, >= 3 clusters, cluster sets equal to the
   port's own CPU run of the same frame and seed; per-stage times and the
   frame p50;
4. aerial end to end with RANSAC seeds 0-4: its kernels launched, no
   overflow, cluster_exact, normals certified on >= 90% of the rows,
   |plane normal z| > 0.95; for seed 0 the clusters (min size 20) equal to
   the port's CPU run; per-stage times, cluster rounds and the frame p50;
5. the pipelines' default kwargs: one KITTI frame with
   ransac_subsample=None (full scoring through `ransac_score_counts`) and
   one aerial frame with ransac_subsample=None and normals_rescue=True
   (`rescue_knn_idx`), each against the port's CPU run;
6. the per-op API (`pointclouds_tpu_torch.api`) at benches/bench_ops.py's
   sizes: voxel and passthrough at 10K, 100K and 1M, SOR (k 10, std 2),
   ROR (r 0.5, min 5) and normals (k 10) at 10K and 100K, on a noisy
   cloud (100K + 1000 outliers in a 20 m box) whose isolated rows reach
   the rescue kernels, SOR on an overflow cloud (outliers in a 40 m box:
   more flagged rows than `fused_rescue_cap`, so the exact engine path
   and `sweep_select` run), RANSAC (0.05, 500 iterations, seed 7) on the
   slab cloud at 10K and 100K. Each op: its kernels launched, the valid
   queries each rescue kernel received, p50 over 5 calls, a torch.profiler
   breakdown; 10K outputs equal to the port's CPU run, 100K outputs held
   against a scipy cKDTree oracle in float64 (exceptions within 1e-5 of
   the SOR threshold or 1e-6 of the radius, tied kth neighbours, nearly
   equal eigenvalues, counted and printed);
7. the per-op API's kNN, clustering, ICP and I/O at bench_ops' sizes:
   `sweep_knn_select` cross-cloud (100K queries against 100K points) and
   `nn_argmin` on a half-shifted lattice against their plain versions;
   `knn` k 10 over all 100K points and for 100K other queries, ICP
   point-to-point and point-to-plane on 10K points shifted 0.05 m (50
   iterations at most), `euclidean_cluster` (min 20, max 100K) on the 100K
   slab at r 0.5 and on the aerial non-ground cloud (aerial_scene(7),
   voxel 0.5, less a RANSAC plane) at r 2.0, 100K PCD/PLY round trips, and
   the host index's per-query times. Gates: kNN against a cKDTree oracle
   (distances, and index sets where the kth is untied), ICP equal to the
   port's CPU run (iterations; rotation and translation within 1e-5),
   clusters equal to the CPU run and to a query_pairs + connected
   components oracle, files written on the card byte-equal to the CPU
   run's (phase7.json in chiprun_out/);
8. the last three kernels and their paths: `segmented_select`,
   `sor_select` and `cluster_propagate` against their plain versions at
   the inputs of the KITTI bench frame's cell-grid SOR backends
   (sor_backend "xla" and "pallas") and of `euclidean_cluster` on a
   uniform cloud of 1.2M points (bucket 2^21, above the reference's
   residency gate, so the hop loop runs) in a 63 m cube at r 0.5, with
   `torch.topk` of the work rows as kernel 18's yardstick (kernel 18 at
   both of its "xla" frame callers, `point_sor_mean_dists` and
   `cell_knn_subset`; kernel 17 with its device time and two byte
   bounds: the bytes any implementation must move, by which its row is
   judged, and every input read once); the bench frame
   through both backends for RANSAC seeds 0-4 (launches, grid flags,
   sor_certified and clusters reported, not gated; seed 0 equal to the
   port's CPU run: centroids, keep mask, plane, clusters; stage times and
   the frame p50), and the large clustering (hops, p50, clusters equal to a
   query_pairs + connected-components oracle; phase8.json);
9. the host C++ (built, serving the host index; index and reader times)
   and the int64-keyed grid at 2^24 points: `knn` and `euclidean_cluster`
   against cKDTree oracles (phase9.json);
10. the cell-grid kNN rungs at 100K uniform points in a 10 m box: `knn` k
   30 on the cloud's own points (`slab_knn`), 1,000 other queries at k 10
   (`point_knn`) and `engine.radius_count` at r 0.5
   (`point_radius_count`): the rungs taken (spied, with the rows each
   pass flags), p50 over 5 calls and device ms, beside the brute force the
   parent commit ran on the same inputs (outputs equal: distances and
   counts bitwise, index sets where the kth is untied; its p50 and device
   ms), and cKDTree oracles (phase10.json);
11. multi-device on the one card: the tiled and sharded KITTI (bench
   frames of seeds 0-1) and aerial (the bench frame, RANSAC seeds 0-1)
   batches at world 1 (NCCL, mesh (1, 1)) and world 2 (two spawned gloo
   ranks on the card, mesh (1, 2); `parallel/comm.py` stages each
   collective through the host, reported): each path's kernels launched,
   batch p50s, ms inside collectives, flags, kept counts; the tiled
   outputs against the unsharded pipeline on the card by the tiled
   tests' rules (and world 2 against world 1), the sharded ones equal to
   the unsharded pipeline; route, voxel and obstacle overflow flags must
   be clean, and at world 2 the halo overflow flag too (phase11.json);
12. the JAX package's last public functions to get a twin: the two-sort
   voxel front end and its sort 3 on the KITTI frame (kernel 1; bitwise
   equal to the CPU run and to the fused front end's rows),
   `sweep_sor_mean_dists` on its centroids at k 20 in the 0.45 m sor cell
   (kernel 9; means bitwise equal to the CPU run where both certify), the
   masked ICP pair on phase 7's 10K clouds (kernel 15; equal to the API's
   ICP within 1e-5), `radius_within_mask` / `radius_indices` on the 100K
   cloud for 8 queries (a cKDTree oracle), the cell-graph radius blocks
   and their propagation on the 100K slab at r 0.5 over the clustering
   rung's grid (labels equal to `cell_graph_labels`' and the oracle's),
   `aabb`, and the launch floor of `utils/profiling.py` in µs
   (phase12.json).

Every path runs with the launch counts set to 0 just before it and read
just after; each of its kernels must have launched. Prints the kernels'
JSON line (launches summed over the paths), the card's name and power
limit, and as its last line {"ok": true, "device": {...}}. Any failure
raises (exit != 0); without a CUDA device it exits non-zero before
measuring anything. Long output (build log, phase 6's numbers) goes to
chiprun_out/.

    python3 chip_smoke.py --ab DIR [DIR ...]

compares this checkout with others (each DIR an unpacked checkout, e.g.
`git archive` of an earlier commit) on the same card instead: it captures
the inputs that the KITTI sweep frame (RANSAC seed 0; with
`cluster_multisweep`), the `knn` op over the 100K cloud's own points and
for 100K other queries (`sweep_knn_select`), `euclidean_cluster` on the
100K slab at r 0.5 (`cluster_multisweep`), the SOR op on the
noisy 100K cloud, the aerial bench frame (seed 0: `sweep_moments` and
`cluster_multisweep_windows`; with normals_rescue for `rescue_knn_idx`),
the 1.2M-point clustering's first hop (`cluster_propagate`), the normals
op on the 100K cloud, the KITTI "xla" frame (`segmented_select` at both
callers), the SOR op on the overflow and the clean 100K clouds
(`brute_knn_idx`), the KITTI "pallas" frame (`sor_select`), the 1M
voxel op (`segmented_scan_sums`), the SOR op on the overflow cloud
again ("sor overflow 100K": `sweep_select`, the SOR engine's fallback),
the fused ROR op on the noisy cloud with a one-row window budget ("ror
full": `brute_radius_count` with every query block live) and the ROR op
on the noisy cloud ("ror noisy 100K": `brute_radius_count` with no live
block; "ror count 100K": `count_within`), and the ICP point-to-point op
at 10K ("icp 10K": `nn_argmin`) and the half-shift lattice ("nn
lattice": `nn_argmin` with tied nearest candidates), the fused ROR op
with the one-row budget again ("ror rescue": `rescue_radius_count_groups`
with 32 live blocks), the noisy ROR op ("ror rescue noisy 100K": the same
with 2 live blocks), the KITTI frame with full scoring ("ransac kitti
full": `ransac_score_counts` at 512 slots and 768 rows) and the RANSAC op
on the 10K slab ("ransac op 10K") give their
kernels, then runs the trees in the order DIR..., this, this, ...DIR (so
that drift on the card shows), each in a fresh process that builds its
own kernels: each kernel against its plain version at the captured
inputs (as phase 2) and timed with CUDA events and torch.profiler (with
its device launches a call, registers and shared memory; the cluster
loops' rounds, host reads and walked pairs), the KITTI frame p50,
device time and stage medians (as phase 3), the noisy and overflow SOR op p50s, the
overflow SOR op's and the noisy ROR op's device time and device launches
a call (and the ROR op's p50), the 10K RANSAC op's p50, device time and
device launches a call, the 10K ICP point-to-point op's p50,
device time and device launches a call, the KITTI
"xla" and "pallas" frame p50s and stage medians (as phase 8) and the
"pallas" frame's device time, the 1M voxel op's p50 and device time, the
aerial frame p50 and
stage medians (as phase 4), the normals and `knn` (same-cloud and
cross-cloud) 100K op p50s, the `knn` calls' device times and the
1.2M `euclidean_cluster` p50, and the device time (torch.profiler) of an
aerial frame and of the 1.2M call. Each
tree's ptxas log and numbers go to chiprun_out/ab.json.

    python3 chip_smoke.py --ab DIR [DIR ...] --captures LABEL [LABEL ...]

does the same for the named captures' kernels only (no frames or ops):
the quick way to set variants of a kernel against each other.
"""

from __future__ import annotations

import argparse
import importlib
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
    "ransac_score_counts": ("ops.segmentation", "ransac.cu", 3169),
    "sweep_moments": ("spatial.sweep", "moments.cu", 2003),
    "rescue_knn_idx": ("spatial.sweep", "knn.cu", 2991),
    "cluster_multisweep_windows": ("spatial.sweep", "cluster.cu", 1574),
    "sweep_select": ("spatial.sweep", "select.cu", 544),
    "count_within": ("spatial.sweep", "radius.cu", 2152),
    "rescue_radius_count_groups": ("spatial.sweep", "radius.cu", 3088),
    "brute_knn_idx": ("ops.fusedops", "brute.cu", 2754),
    "brute_radius_count": ("ops.fusedops", "brute.cu", 2829),
    "sweep_knn_select": ("spatial.sweep", "sweepknn.cu", 2469),
    "nn_argmin": ("ops.registration", "nn.cu", 2612),
    "cluster_propagate": ("spatial.sweep", "propagate.cu", 969),
    "sor_select": ("spatial.cellgrid", "cellsel.cu", 230),
    "segmented_select": ("spatial.cellgrid", "cellsel.cu", 152),
}
# The kernels phase 8 checks (at the cell-grid backends' and the large
# cloud's shapes).
PHASE8_KERNELS = ("cluster_propagate", "sor_select", "segmented_select")
# The kernels phase 2 also checks at the normals 100K op's inputs.
NORMALS_KERNELS = ["sweep_moments", "rescue_knn_idx"]
# Kernel 18's callers in the "xla" KITTI frame (the first is its row in the
# kernels' line; phase 8 and --ab check it at both).
SEG_CALLERS = ("point_sor_mean_dists", "cell_knn_subset")
# Kernels whose outputs are held bitwise against their plain versions (the
# same f32 operations in the same order; counts are exact integer sums;
# labels are integers).
BITWISE = ("segmented_scan_sums", "ransac_score_counts", "sweep_moments",
           "rescue_knn_idx", "count_within", "rescue_radius_count_groups",
           "brute_radius_count", "brute_knn_idx", "sweep_knn_select",
           "nn_argmin", "cluster_propagate", "sor_select")
KITTI = dict(voxel=0.15, sor_std=2.0, ransac_thresh=0.15, cluster_r=0.8,
             sor_k=20, ransac_iters=500, ds_cap=98_304,
             ransac_subsample=4096, obstacle_cap=8192)
KITTI_POINTS = 122_000
AERIAL = dict(ds_cap=229_376, obstacle_cap=196_608, ransac_subsample=4096,
              normals_cell_factor=6, cluster_sweeps=16)
VIEWPOINT = [0.0, 0.0, 10000.0]
# The kernels each path must launch.
PATHS = {
    "kitti": ["segmented_scan_sums", "sweep_select_rows", "rescue_select",
              "cluster_multisweep"],
    "aerial": ["segmented_scan_sums", "sweep_moments",
               "cluster_multisweep_windows"],
    "kitti_default": ["segmented_scan_sums", "sweep_select_rows",
                      "cluster_multisweep", "ransac_score_counts"],
    "aerial_default": ["segmented_scan_sums", "sweep_moments",
                       "rescue_knn_idx", "ransac_score_counts",
                       "cluster_multisweep_windows"],
    # The per-op API (phase 6).
    "voxel": ["segmented_scan_sums"],
    "passthrough": [],
    "sor": ["sweep_select_rows", "rescue_select", "brute_knn_idx"],
    "sor_overflow": ["sweep_select_rows", "rescue_select", "brute_knn_idx",
                     "sweep_select"],
    "ror": ["count_within", "rescue_radius_count_groups",
            "brute_radius_count"],
    "normals": ["sweep_moments", "rescue_knn_idx", "brute_knn_idx"],
    "ransac": ["ransac_score_counts"],
    # The per-op API's kNN, clustering, ICP and I/O (phase 7).
    "knn": ["sweep_knn_select", "rescue_knn_idx", "brute_knn_idx"],
    "knn_cross": ["sweep_knn_select", "rescue_knn_idx"],
    "cluster": ["cluster_multisweep"],
    "icp": ["nn_argmin"],
    "io": [],
    # The KITTI cell-grid backends and the large-cloud hop loop (phase 8).
    "kitti_xla": ["segmented_scan_sums", "segmented_select"],
    "kitti_pallas": ["segmented_scan_sums", "sor_select", "segmented_select"],
    "cluster_large": ["cluster_propagate"],
    # The int64-keyed grid at 2^24 points (phase 9): torch ops, no kernel.
    "knn_huge": [],
    "cluster_huge": [],
    # The two-sort voxel front end and pass 1 of the SOR sweep (phase 12).
    "frontend": ["segmented_scan_sums"],
    "sor_mean": ["sweep_select"],
}
SEEDS = range(5)
KITTI_FRAMES = 20
AERIAL_FRAMES = 10
NORMALS_OK_MIN = 0.90


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def run_kitti(pc, data, seed, device=None, cloud=None, **over):
    """One KITTI frame at the bench configuration (``over`` replaces
    kwargs), on ``device`` or on a cloud already made there."""
    if cloud is None:
        cloud = pc.make_cloud_arrays(data, device=device)
    kw = {**KITTI, **over}
    pos = [np.float32(kw.pop(k)) for k in ("voxel", "sor_std",
                                           "ransac_thresh")]
    return pc.kitti_obstacle_pipeline(cloud.xyz, cloud.valid, *pos, seed,
                                      np.float32(kw.pop("cluster_r")), **kw)


def run_aerial(pc, data, seed, device=None, cloud=None, **over):
    """One aerial frame at bench.py's configuration (``over`` replaces
    kwargs)."""
    if cloud is None:
        cloud = pc.make_cloud_arrays(data, device=device)
    return pc.aerial_pipeline(
        cloud.xyz, cloud.valid, np.float32(0.5), np.float32(3.0),
        np.float32(0.3), seed, np.float32(2.0), VIEWPOINT,
        **{**AERIAL, **over})


def kitti_points(pc, out):
    """KITTI cluster sets (min size 10) as sorted point coordinates, for
    geometric equality; members are ranks among the valid obstacle slots."""
    clusters = pc.extract_clusters(out, 10, 20_000)
    cents = out.centroids.cpu().numpy()[out.obstacle_src.cpu().numpy()]
    slots = np.nonzero(out.obstacle_valid.cpu().numpy())[0]
    return [np.sort(cents[slots[c]], axis=0) for c in clusters]


def aerial_points(aerial_mod, out):
    """Aerial cluster sets (min size 20) as sorted point coordinates;
    members are obstacle slots."""
    clusters = aerial_mod.extract_clusters(out, 20, 10**6)
    cents = out.centroids.cpu().numpy()[out.obstacle_src.cpu().numpy()]
    return [np.sort(cents[c], axis=0) for c in clusters]


def normals_ok_share(out) -> float:
    ds = out.downsampled_valid
    return float((out.normals_ok & ds).sum()) / max(int(ds.sum()), 1)


def same_clusters(a, b) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


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


class Spy:
    """Wraps functions in the modules that call them, for the duration of
    a ``with`` block; each call goes to ``hook(name, orig, args, kwargs)``."""

    def __init__(self, targets, hook):
        self.targets = targets  # [(module, function name)]
        self.hook = hook
        self.saved = []

    def __enter__(self):
        for mod, name in self.targets:
            orig = getattr(mod, name)

            def wrapped(*a, _name=name, _orig=orig, **k):
                return self.hook(_name, _orig, a, k)

            self.saved.append((mod, name, orig))
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


def _called_within(fn_name: str) -> bool:
    """Whether a function named ``fn_name`` is on the Python call stack."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == fn_name:
            return True
        f = f.f_back
    return False


def capture_inputs(run, names, within=None):
    """Run one frame with the named kernel wrappers spied on where the
    pipeline calls them; keep each kernel's first arguments (``within``:
    its first call made inside a function of that name)."""
    captured = {}

    def hook(name, orig, a, k):
        if name not in captured and (within is None
                                     or _called_within(within)):
            captured[name] = (tuple(x.clone() if torch.is_tensor(x) else x
                                    for x in a), dict(k))
        return orig(*a, **k)

    targets = [(importlib.import_module(
        f"pointclouds_tpu_torch.{KERNELS[n][0]}"), n) for n in names]
    with Spy(targets, hook):
        run()
        torch.cuda.synchronize()
    missing = set(names) - set(captured)
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
    if name in BITWISE:
        # Bitwise: the same f32 operations in the same order (counts are
        # exact integer sums).
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got_t, want_t):
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: not bitwise equal")
        finite = [(g[torch.isfinite(g)] - w[torch.isfinite(w)]).abs()
                  for g, w in zip(got_t, want_t)]
        err = max(float(f.max()) if f.numel() else 0.0 for f in finite)
        tol = "bitwise"
    elif name in ("cluster_multisweep", "cluster_multisweep_windows"):
        if bool(got[1].any()) or bool(want[1].any()):
            raise AssertionError(f"{name}: did not converge")
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"{name}: labels differ")
        err = float((got[0] - want[0]).abs().max())
        tol = f"labels equal, {got[2]} rounds (plain {want[2]})"
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
    loop = name.startswith("cluster")
    ms = cuda_ms(lambda: kern(*args, **kwargs), 5 if loop else 20)
    plain_ms = cuda_ms(lambda: plain(*args, **kwargs), 1 if loop else 3)
    return err, tol, ms, plain_ms


def select_work(name, args, kwargs) -> str:
    """What the warp-select kernels see at these inputs: live query blocks,
    valid queries, and the rows (SOR pass 1, moments) or active row groups
    (the rescues) each live block walks."""
    if name == "sweep_select_rows":
        pts, rl, cap = args[0], args[1], kwargs["cap"]
        live = rl[:, cap] != 0
        rows = rl[live, cap + 1].clamp(max=cap).float()
        valid = int((pts[:rl.shape[0], 3] > 0.5).sum())
        return (f"{int(live.sum())} of {rl.shape[0]} blocks live, {valid} "
                f"valid queries, rows per live block max "
                f"{int(rows.max()) if rows.numel() else 0} mean "
                f"{float(rows.mean()) if rows.numel() else 0.0:.2f}")
    if name == "sweep_moments":
        pts, starts = args
        nb = starts.shape[0]
        qv = pts[:nb, 3] > 0.5
        live = (starts[:, 27] != 0) & qv.any(dim=1)
        rows = (starts[:, 18:27] - starts[:, 9:18]).clamp(min=0).sum(1)
        rows = rows[live].float()
        return (f"{int(live.sum())} of {nb} blocks live, "
                f"{int(qv[live].sum())} valid queries, window rows per live "
                f"block max {int(rows.max()) if rows.numel() else 0} mean "
                f"{float(rows.mean()) if rows.numel() else 0.0:.2f} (total "
                f"{int(rows.sum())})")
    if name == "cluster_propagate":
        return propagate_work(*args[:3])
    if name in ("cluster_multisweep", "cluster_multisweep_windows"):
        rec = traced_call(name, args, kwargs)
        return "" if rec is None else (
            f"one call: {rec.count('cluster.rounds')} rounds, "
            f"{rec.count('cluster.round_batches')} host reads, "
            f"{rec.count('cluster.pairs_visited')} pairs walked (frontier "
            f"and row prune)")
    if name in ("rescue_select", "rescue_knn_idx",
                "rescue_radius_count_groups"):
        q, active = args[1], args[2]
        valid = q[:, 3] >= RESCUE_LIVE[name]
        live = valid.any(dim=1)
        groups = active[live, 0].float()
        mx, med = ((int(groups.max()), float(groups.median()))
                   if groups.numel() else (0, 0.0))
        return (f"{int(live.sum())} of {q.shape[0]} query blocks live, "
                f"{int(valid.sum())} valid queries, active groups "
                f"per live block max {mx} median {med:g} (total "
                f"{int(groups.sum())})")
    if name == "ransac_score_counts":
        hyp, pts = args
        real = int((hyp[4] >= 0).sum())
        valid = int((pts[:, 3] > 0.5).sum())
        walked = hyp.shape[1] * pts.shape[0] * 128
        return (f"{real} of {hyp.shape[1]} hypotheses, {valid} valid of "
                f"{pts.shape[0] * 128} points: {walked} pairs walked, "
                f"{real * valid} counted")
    return ""


def traced_call(name, args, kwargs):
    """The frame record of one traced call of kernel wrapper ``name`` (None
    in a tree without the port's tracing)."""
    prof = importlib.import_module("pointclouds_tpu_torch.utils.profiling")
    if not hasattr(prof, "set_tracing"):
        return None
    kmod = importlib.import_module("pointclouds_tpu_torch.spatial.kernels")
    prof.set_tracing(True)
    try:
        with prof.frame(name, args[0].device):
            getattr(kmod, name)(*args, **kwargs)
    finally:
        prof.set_tracing(False)
    return prof.last_frame()


def propagate_work(pts, labels, starts) -> str:
    """What kernel 16 sees: the running blocks, their window rows
    [start, start + length), and of those the rows whose smallest valid
    label lies below the largest valid label of the block's queries -- at
    most these are walked (the row prune skips the others; a warp's own
    largest label only falls as it walks)."""
    nr, nb = pts.shape[0], starts.shape[0]
    run = (starts[:, 27] != 0) & (starts[:, 28] != 0)
    ln = starts[:, 18:27].long()
    wr = max(int(ln.max()) if nb else 0, 1)
    r = torch.arange(wr, device=starts.device)
    keep = (r < ln[..., None]) & run[:, None, None]
    rows = (starts[:, :9, None].long() + r).clamp(max=nr - 1)
    valid = pts[:, 3] > 0.5
    lab = labels.reshape(nr, 128)
    big = torch.iinfo(torch.int32).max
    rowmin = torch.where(valid, lab, big).amin(1)
    qmax = torch.where(valid[:nb], lab[:nb], -big).amax(1)
    walked = keep & (rowmin[rows] < qmax[:, None, None])
    return (f"{int(run.sum())} of {nb} blocks run, {int(keep.sum())} window "
            f"rows, at most {int(walked.sum())} walked after the row prune "
            f"({128 * 128 * int(walked.sum())} pairs)")


def kernel_row(name, args, kwargs, K, card_line, library=None, label=""):
    """Check one kernel against its plain version, time both and bound it;
    ``library``: one PyTorch call computing the same function, timed as a
    yardstick; ``label``: where the inputs come from, for a kernel checked
    at more than one capture. Returns the kernel's entry of the JSON
    line."""
    _, src, line = KERNELS[name]
    err, tol, ms, plain_ms = check_kernel(name, args, kwargs, K)
    out = getattr(K, name)(*args, **kwargs)
    nbytes, ops = work(name, args, kwargs, out)
    bms, by = bound_ms(nbytes, ops)
    extra = {}
    if name == "sor_select":
        # Also "every input read once", the bound before the compaction.
        extra["bound_read_once_ms"] = bound_ms(_nbytes(*args, *out), ops)[0]
        log(f"kernel sor_select: bound {bms:.5f} ms moving the "
            f"{nbytes} B any implementation must; every input read once "
            f"{extra['bound_read_once_ms']:.5f} ms [{card_line}]")
    lib_ms = None if library is None else cuda_ms(library, 20)
    shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
    live = {n: int((args[0 if n.startswith("brute") else 1][:, 3, :]
                    >= RESCUE_LIVE[n]).sum())
            for n in (name,) if n in RESCUE_LIVE}
    seen = select_work(name, args, kwargs)
    log(f"kernel {name}{f' ({label})' if label else ''}: shapes={shapes} "
        f"{live}{f' ({seen})' if seen else ''}"
        f" agrees ({tol}, "
        f"max_abs_err={err}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bms:.5f} ms ({by}: {nbytes} B, {ops} ops), library "
        f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} [{card_line}]")
    return dict(name=name, route="cuda",
                source=f"pointclouds_tpu_torch/spatial/csrc/{src}",
                replaces=f"{PALLAS}:{line}", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, **extra)


def path_launches(K, name, run):
    """Run ``run`` with the launch counts set to 0 just before and read just
    after; every kernel of the path must have launched."""
    K.reset_launch_counts()
    result = run()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    log(f"{name} launches: {launches}")
    for kname in PATHS[name]:
        if launches[kname] <= 0:
            raise AssertionError(f"{kname} never launched on the {name} path")
    return result, launches


def timed_frames(run, frames, card_line, what):
    """Frame p50 (host clock ending in a synchronize, tracing off), then
    each stage's median over as many traced frames (CUDA-event ms of the
    program's stage spans; none in a tree without the port's tracing);
    logs both and returns (stages, p50)."""
    times = []
    for f in range(frames):
        t0 = time.perf_counter()
        run(f)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    st = {}
    prof = importlib.import_module("pointclouds_tpu_torch.utils.profiling")
    if hasattr(prof, "set_tracing"):
        recs = []
        prof.set_tracing(True)
        try:
            for f in range(frames):
                run(f)
                recs.append(prof.last_frame())
        finally:
            prof.set_tracing(False)
        stages = dict.fromkeys(s.name for s in recs[0].spans[1:] if s.card)
        st = {s: float(np.median([r.span_ms(s) for r in recs]))
              for s in stages}
    log(f"{what} stage ms (median, CUDA events): " + ", ".join(
        f"{s}={v:.3f}" for s, v in st.items()) + f" [{card_line}]")
    p50 = float(np.percentile(times, 50))
    log(f"{what} frame p50 {p50:.3f} ms over {frames} frames (min "
        f"{min(times):.3f}, max {max(times):.3f}) [{card_line}]")
    return st, p50


# ── Bounds: the least time the card could take for a kernel's work ─────────

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM f32, outside the tensor cores
# Operations per query-candidate pair: d2 (3 subtractions, one multiply,
# two fmas at 2 each) and the compare.
PAIR_OPS = 9


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def _window_rows(starts) -> int:
    """Candidate rows the live blocks walk over their nine windows."""
    rows = (starts[:, 18:27] - starts[:, 9:18]).clamp(min=0).sum(1)
    return int((rows * (starts[:, 27] != 0)).sum())


def _group_rows(q, active, gr, live_w) -> int:
    live = q[:, 3, :].amax(dim=1) >= live_w
    return int((active[:, 0].long() * gr * live).sum())


def work(name, args, kwargs, out):
    """(bytes moved, operations) of one call on these inputs: every input
    read once and every output written once; the pairs this run's data
    makes the function evaluate (windows, row lists and active groups as
    they are), PAIR_OPS each."""
    outs = out if isinstance(out, tuple) else (out,)
    nbytes = _nbytes(*args, *outs)
    pair = 128 * 128
    if name == "segmented_scan_sums":
        return nbytes, 4 * args[0].numel()  # one add per element, 4 sums
    if name == "sweep_select_rows":
        rl, cap = args[1], kwargs["cap"]
        rows = (rl[:, cap + 1].clamp(max=cap) * (rl[:, cap] != 0)).sum()
        return nbytes, PAIR_OPS * pair * int(rows)
    if name in ("rescue_select", "rescue_knn_idx"):
        return nbytes, PAIR_OPS * pair * _group_rows(
            args[1], args[2], kwargs.get("gr", 8), 0.5)
    if name == "rescue_radius_count_groups":
        return nbytes, PAIR_OPS * pair * _group_rows(
            args[1], args[2], kwargs.get("gr", 8), 0.0)
    if name == "cluster_multisweep":
        # Every listed row a round, for the plain version's Jacobi rounds:
        # the kernel's own rounds fold the jumps into the next round, and a
        # yardstick must not move with its design.
        rl, cap = args[1], kwargs["cap"]
        rows = (rl[:, cap + 1].clamp(max=cap) * (rl[:, cap] != 0)).sum()
        rounds = importlib.import_module(
            "pointclouds_tpu_torch.spatial.kernels").cluster_multisweep_plain(
                *args, **kwargs)[2]
        return nbytes, PAIR_OPS * pair * int(rows) * rounds
    if name == "cluster_multisweep_windows":
        return nbytes, PAIR_OPS * pair * _window_rows(args[1]) * out[2]
    if name in ("sweep_moments", "sweep_select", "count_within"):
        return nbytes, PAIR_OPS * pair * _window_rows(args[1])
    if name == "ransac_score_counts":
        hyp, pts = args
        real = int((hyp[4] >= 0).sum())
        # |fma(z, nz, fma(x, nx, y*ny)) + d| <= t: 2 fmas, a multiply, an
        # add and the compare.
        return nbytes, 7 * real * int((pts[:, 3] > 0.5).sum())
    if name == "sweep_knn_select":
        return nbytes, PAIR_OPS * pair * _window_rows(args[1])
    if name == "brute_knn_idx":
        # Each valid query against every candidate row.
        q, cand = args
        valid = int((q[:, 3, :] > 0.5).sum())
        return nbytes, PAIR_OPS * 128 * valid * cand.shape[0]
    if name in ("brute_radius_count", "nn_argmin"):
        q, cand = args
        live_w = 0.0 if name == "brute_radius_count" else 0.5
        live = int((q[:, 3, :].amax(dim=1) >= live_w).sum())
        return nbytes, PAIR_OPS * pair * live * cand.shape[0]
    if name == "cluster_propagate":
        # Rows [start, start + length) of the blocks that run (a valid
        # query and active); the hop reads no skip.
        starts = args[2]
        run = (starts[:, 27] != 0) & (starts[:, 28] != 0)
        rows = int((starts[:, 18:27].sum(1) * run).sum())
        return nbytes, PAIR_OPS * pair * rows
    if name == "sor_select":
        # Valid queries x valid candidates of each cell (empty cells none);
        # the bytes any implementation must move (`sor_must_move`).
        q, qm, cand, cv = args
        pairs = int((qm.sum(1) * cv.sum(1)).sum())
        return sor_must_move(q, qm, cand, cv, outs), PAIR_OPS * pairs
    if name == "segmented_select":
        return nbytes, args[0].numel()  # one compare per element
    raise KeyError(name)


def _sectors(mask, offsets, width) -> int:
    """32-byte sectors holding the ``width`` bytes at each byte offset where
    ``mask`` is set (the tensors start on 512-byte boundaries)."""
    first = offsets[mask] // 32
    last = (offsets[mask] + width - 1) // 32
    return int(torch.unique(torch.cat([first, last])).numel()) * 32


def sor_must_move(q, qm, cand, cv, outs) -> int:
    """Kernel 17's bytes that any implementation must move: the qm and cv
    masks whole, the 32-byte sectors of q [C, 3, M] and cand [C, CAND, 3]
    that hold a valid query's or a valid candidate's coordinates, and the
    outputs. Its "every input read once" count also reads the masked
    slots' coordinates, which the kernel never loads."""
    c, _, m = q.shape
    ncand = cand.shape[1]
    dev = q.device
    qoff = ((torch.arange(c, device=dev)[:, None, None] * 3
             + torch.arange(3, device=dev)[None, :, None]) * m
            + torch.arange(m, device=dev)[None, None, :]) * 4
    coff = (torch.arange(c, device=dev)[:, None] * ncand
            + torch.arange(ncand, device=dev)[None, :]) * 12
    return (_nbytes(qm, cv, *outs)
            + _sectors(qm[:, None, :].expand(c, 3, m), qoff, 4)
            + _sectors(cv, coff, 12))


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ── The per-op API (phase 6) ────────────────────────────────────────────────


def bench_cloud(n, seed=0, box=10.0):
    """benches/bench_ops.py's uniform cloud."""
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3)) * box).astype(np.float32)


def noisy_cloud(box, n_out=1000):
    """The 100K bench cloud plus ``n_out`` outliers in a ``box`` m cube
    centred on it."""
    rng = np.random.default_rng(1)
    out = (rng.random((n_out, 3)) * box + (5.0 - box / 2)).astype(np.float32)
    return np.vstack([bench_cloud(100_000), out])


def slab_cloud(n=100_000, seed=3):
    """bench_ops' RANSAC cloud: 80% in a 20 x 20 x 0.05 m slab, 20% in a
    20 m box."""
    rng = np.random.default_rng(seed)
    ns = n * 4 // 5
    return np.vstack([
        (rng.random((ns, 3)) * [20, 20, 0.05]).astype(np.float32),
        (rng.random((n - ns, 3)) * 20).astype(np.float32)])


def ransac_op(api, cloud):
    """bench_ops' RANSAC op: threshold 0.05, 500 iterations, seed 7."""
    return api.ransac_plane_seeded(cloud, 0.05, 500, 7)


CARD = "cuda"  # where `PointCloud.from_numpy` must put a cloud by default
NOISY_BOX = 20.0  # outliers here stay within SOR's rescue reach
OVERFLOW_BOX = 40.0  # here they widen the cell estimate 4x: overflow
OPS6 = [
    # (name, path, cloud, call)
    ("voxel_downsample 0.5 10K", "voxel", "u10k",
     lambda api, c: api.voxel_downsample(c, 0.5)),
    ("passthrough x[2,8] 10K", "passthrough", "u10k",
     lambda api, c: api.passthrough_filter(c, "x", 2.0, 8.0)),
    ("voxel_downsample 0.5 100K", "voxel", "u100k",
     lambda api, c: api.voxel_downsample(c, 0.5)),
    ("voxel_downsample 0.5 1M", "voxel", "u1m",
     lambda api, c: api.voxel_downsample(c, 0.5)),
    ("passthrough x[2,8] 100K", "passthrough", "u100k",
     lambda api, c: api.passthrough_filter(c, "x", 2.0, 8.0)),
    ("passthrough x[2,8] 1M", "passthrough", "u1m",
     lambda api, c: api.passthrough_filter(c, "x", 2.0, 8.0)),
    ("sor k10 std2 10K", "sor", "u10k",
     lambda api, c: api.statistical_outlier_removal(c, 10, 2.0)),
    ("sor k10 std2 100K", "sor", "u100k",
     lambda api, c: api.statistical_outlier_removal(c, 10, 2.0)),
    ("sor k10 std2 noisy", "sor", "noisy",
     lambda api, c: api.statistical_outlier_removal(c, 10, 2.0)),
    ("sor k10 std2 overflow", "sor_overflow", "overflow",
     lambda api, c: api.statistical_outlier_removal(c, 10, 2.0)),
    ("ror r0.5 min5 10K", "ror", "u10k",
     lambda api, c: api.radius_outlier_removal(c, 0.5, 5)),
    ("ror r0.5 min5 100K", "ror", "u100k",
     lambda api, c: api.radius_outlier_removal(c, 0.5, 5)),
    ("ror r0.5 min5 noisy", "ror", "noisy",
     lambda api, c: api.radius_outlier_removal(c, 0.5, 5)),
    ("normals k10 10K", "normals", "u10k",
     lambda api, c: api.estimate_normals(c, 10)),
    ("normals k10 100K", "normals", "u100k",
     lambda api, c: api.estimate_normals(c, 10)),
    ("normals k10 noisy", "normals", "noisy",
     lambda api, c: api.estimate_normals(c, 10)),
    ("ransac_plane_seeded 0.05 x500 slab 10K", "ransac", "slab10k",
     ransac_op),
    ("ransac_plane_seeded 0.05 x500 slab 100K", "ransac", "slab100k",
     ransac_op),
]
# Rescue kernels: the query channel's w that marks a valid query.
RESCUE_LIVE = {"rescue_select": 0.5, "rescue_knn_idx": 0.5,
               "brute_knn_idx": 0.5, "rescue_radius_count_groups": 0.0,
               "brute_radius_count": 0.0}


def phase6_clouds():
    return {
        "u10k": bench_cloud(10_000), "u100k": bench_cloud(100_000),
        "u1m": bench_cloud(1_000_000), "noisy": noisy_cloud(NOISY_BOX),
        "overflow": noisy_cloud(OVERFLOW_BOX), "slab10k": slab_cloud(10_000),
        "slab100k": slab_cloud(),
    }


def output_arrays(out):
    """An op's result as numpy arrays: points (and normals), or the plane
    and its inliers."""
    if hasattr(out, "inliers"):
        return [np.asarray(out.normal + [out.d]), np.asarray(out.inliers)]
    got = [out.to_numpy()]
    if out._has_normals:
        got.append(out._normals_numpy())
    return got


def rescue_queries(names):
    """Spy on the rescue kernels where their callers call them; count the
    valid queries each receives."""
    seen = {n: 0 for n in names}

    def hook(name, orig, a, k):
        q = a[0] if name.startswith("brute") else a[1]
        seen[name] += int((q[:, 3, :] >= RESCUE_LIVE[name]).sum())
        return orig(*a, **k)

    targets = [(importlib.import_module(
        f"pointclouds_tpu_torch.{KERNELS[n][0]}"), n) for n in names]
    return Spy(targets, hook), seen


def p50_ms(fn, reps=5):
    """Host clock around each call, ending in a synchronize; p50."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(times, 50)), times


def profile_op(fn, reps=5):
    """torch.profiler over ``reps`` calls: (device busy share of the wall
    window, device kernels per call, top kernels by device time), or None
    when the profiler saw no device kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return None
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return (busy / wall_us, len(kern) / reps,
            [(n[:60], round(t / reps / 1e3, 4)) for n, t in top])


def device_ms(fn, reps=20, per_call=None):
    """Device time of the kernels one call of ``fn`` launches, from
    torch.profiler over ``reps`` calls: a small kernel's CUDA-event time
    (`cuda_ms`) is its wrapper's host time when that is the longer. The
    profiler now and then drops device events from a window; a window
    with none, or (given ``per_call``, the device kernels one call
    launches) with another count than reps * per_call, is taken again,
    and after three None is returned (not measured), never a part."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if us and (per_call is None or len(us) == reps * per_call):
            return sum(us) / reps / 1e3
    return None


def ms_text(ms, digits=4) -> str:
    """A device time for the log: "not measured" where it is None."""
    return "not measured" if ms is None else f"{ms:.{digits}f}"


def device_kernels(fn) -> list:
    """Names of the device kernels one call of ``fn`` launches
    (torch.profiler, after a warm-up call; the most any of three windows
    saw, as the profiler now and then drops events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        names = max(names, seen, key=len)
    return names


def kernel_resources(fn) -> dict:
    """Registers a thread and shared memory a block (static and dynamic,
    bytes) of each device kernel one call of ``fn`` launches, as
    torch.profiler's trace records them (None where it does not)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / "resources_trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    path.unlink()
    return {e.get("name", "")[:48]: (e.get("args", {}).get("registers per thread"),
                                     e.get("args", {}).get("shared memory"))
            for e in events if e.get("cat") == "kernel"}


def kernel_device(name, args, kwargs, K, card_line, label) -> dict:
    """A kernel's device time, device launches and resources a call at a
    capture (a small kernel's CUDA-event time is its wrapper's host time)."""
    fn = lambda: getattr(K, name)(*args, **kwargs)  # noqa: E731
    names = device_kernels(fn)
    # Every wrapper launches: a profile with no kernel in it measured
    # nothing.
    res = dict(device_ms=device_ms(fn, per_call=len(names)) if names
               else None, device_launches=len(names),
               device_kernels=sorted(set(names)),
               resources=kernel_resources(fn))
    log(f"kernel {name} ({label}): device "
        f"{ms_text(res['device_ms'])} ms a call (torch.profiler), "
        f"{res['device_launches']} device launches a call "
        f"{res['device_kernels']}; (registers a thread, shared memory "
        f"bytes) {res['resources']} [{card_line}]")
    return res


def row_index(pts, out_pts):
    """Rows of ``pts`` that ``out_pts`` holds (the kept rows, in order)."""
    at = {r.tobytes(): i for i, r in enumerate(pts)}
    return np.array([at[r.tobytes()] for r in out_pts], np.int64)


def oracle_sor(pts, kept, k=10, std=2.0):
    from scipy.spatial import cKDTree

    d, _ = cKDTree(pts.astype(np.float64)).query(pts.astype(np.float64),
                                                  k + 1)
    mean = d[:, 1:].mean(axis=1)
    thr = mean.mean() + std * mean.std()
    want = mean <= thr
    got = np.zeros(len(pts), bool)
    got[kept] = True
    near = np.abs(mean - thr) <= 1e-5 * thr
    return int((got != want)[~near].sum()), int(near.sum())


def oracle_ror(pts, kept, r=0.5, min_n=5):
    from scipy.spatial import cKDTree

    tree = cKDTree(pts.astype(np.float64))
    p64 = pts.astype(np.float64)
    cnt = tree.query_ball_point(p64, r, return_length=True)
    lo = tree.query_ball_point(p64, r * (1 - 1e-6), return_length=True)
    hi = tree.query_ball_point(p64, r * (1 + 1e-6), return_length=True)
    want = cnt >= min_n
    got = np.zeros(len(pts), bool)
    got[kept] = True
    near = (lo < min_n) & (hi >= min_n)
    return int((got != want)[~near].sum()), int(near.sum())


def oracle_normals(pts, nrm, k=10):
    """Rows whose normal is off the f64 PCA of the oracle's k nearest by
    more than |cos| 0.9999, and the exceptions: rows whose kth neighbour
    is tied within 1e-6, or whose two smallest eigenvalues are within 5%
    of the largest (there the reference's f32 Cardano solve, whose arccos
    near +-1 loses half the digits, moves the normal by up to ~sqrt(eps)
    over that gap: ~0.03 rad at a 2% gap)."""
    from scipy.spatial import cKDTree

    p64 = pts.astype(np.float64)
    d, idx = cKDTree(p64).query(p64, k + 1)
    nb = p64[idx[:, :k]]
    cen = nb - nb.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", cen, cen)
    w, v = np.linalg.eigh(cov)
    cos = np.abs(np.einsum("ni,ni->n", v[:, :, 0], nrm.astype(np.float64)))
    near = ((d[:, k] - d[:, k - 1]) <= 1e-6 * d[:, k]) | (
        (w[:, 1] - w[:, 0]) <= 0.05 * w[:, 2])
    return int(((cos < 0.9999) & ~near).sum()), int(near.sum()), float(
        np.min(cos[~near]))


def phase6(card_line, K, add):
    """The per-op API on the card: each op's kernels launched, p50 over 5
    calls, profiler breakdown; 10K outputs equal to the CPU run, 100K
    outputs held against a cKDTree oracle."""
    from pointclouds_tpu_torch import api
    from pointclouds_tpu_torch.ops import fusedops

    clouds = phase6_clouds()
    gpu = {n: api.PointCloud.from_numpy(a) for n, a in clouds.items()}
    if gpu["u10k"].device.type != CARD:
        raise AssertionError("PointCloud.from_numpy did not default to the "
                             "card")
    log(f"phase 6: fused_rescue_cap {fusedops.fused_rescue_cap(131_072)} at "
        f"131,072 rows; noisy = 100K + 1000 outliers in a {NOISY_BOX:g} m "
        f"box, overflow = 100K + 1000 in a {OVERFLOW_BOX:g} m box")
    record = {}
    outs = {}
    for name, path, cname, call in OPS6:
        c = gpu[cname]
        spy, seen = rescue_queries(list(RESCUE_LIVE))
        info = {}

        def spy_fused(fname, orig, a, k, info=info):
            out = orig(*a, **k)
            info[fname] = out[1].tolist()
            return out

        with spy, Spy([(fusedops, f) for f in ("sor_fused", "ror_fused")],
                      spy_fused):
            out, launches = path_launches(K, path, lambda: call(api, c))
        add(launches)
        outs[name] = out
        if path == "sor_overflow" and info["sor_fused"][1] != 0:
            raise AssertionError("the overflow cloud did not overflow")
        if path == "sor" and info["sor_fused"][1] != 1:
            raise AssertionError(f"{name}: unexpected rescue-cap overflow")
        ms, times = p50_ms(lambda: call(api, c))
        prof = profile_op(lambda: call(api, c))
        queries = {n: v for n, v in seen.items() if launches[n]}
        log(f"op {name}: p50 {ms:.3f} ms over 5 calls ({', '.join(f'{t:.3f}' for t in times)}) "
            f"launches {sum(launches.values())} "
            f"{ {n: v for n, v in launches.items() if v} } "
            f"rescue valid queries {queries} fused info {info} "
            f"[{card_line}]")
        if prof is None:
            log(f"  profiler: no device events ({name})")
        else:
            log(f"  profiler: device busy {prof[0]:.3f} of the window, "
                f"{prof[1]:.0f} device kernels per call, top {prof[2]}")
        record[name] = dict(p50_ms=ms, times_ms=times,
                            launches=launches, rescue_queries=queries,
                            info=info, profile=prof)

    # 10K: bitwise equal to the port's CPU run.
    for name, path, cname, call in OPS6:
        if not cname.endswith("10k"):
            continue
        cpu = call(api, api.PointCloud.from_numpy(clouds[cname],
                                                  device="cpu"))
        for g, w in zip(output_arrays(outs[name]), output_arrays(cpu)):
            if g.shape != w.shape or not np.array_equal(g, w):
                raise AssertionError(f"{name}: card and CPU runs differ")
        log(f"10K {name}: equal to the CPU run "
            f"({', '.join(str(a.shape) for a in output_arrays(cpu))})")

    # 100K: against the cKDTree oracle in float64.
    checks = {}
    for name, cname, fn in (
            ("sor k10 std2 100K", "u100k", oracle_sor),
            ("sor k10 std2 overflow", "overflow", oracle_sor),
            ("ror r0.5 min5 100K", "u100k", oracle_ror),
            ("ror r0.5 min5 noisy", "noisy", oracle_ror)):
        pts = clouds[cname]
        bad, exc = fn(pts, row_index(pts, outs[name].to_numpy()))
        checks[name] = dict(wrong=bad, exceptions=exc)
        log(f"oracle {name}: {bad} rows differ, {exc} exceptions "
            "(within 1e-5 of the threshold / 1e-6 of the radius)")
        if bad:
            raise AssertionError(f"{name}: differs from the oracle")
    for name, cname in (("normals k10 100K", "u100k"),
                        ("normals k10 noisy", "noisy")):
        bad, exc, worst = oracle_normals(clouds[cname],
                                         outs[name]._normals_numpy())
        checks[name] = dict(wrong=bad, exceptions=exc, min_cos=worst)
        log(f"oracle {name}: {bad} rows below |cos| 0.9999, {exc} "
            f"exceptions (kth tie / eigenvalue gap), min |cos| {worst:.7f}")
        if bad:
            raise AssertionError(f"{name}: differs from the oracle")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "phase6.json").write_text(json.dumps(
        dict(card=card_line, ops=record, oracle=checks), indent=1,
        default=str))


# ── kNN, clustering, ICP and I/O (phase 7) ──────────────────────────────────

ICP_POINTS = 10_000
ICP_SHIFT = np.float32(0.05)
CLUSTER_SIZES = (20, 100_000)  # min and max cluster size
IO_DIR = ROOT / "build" / "chip_smoke_io"


NN_LATTICE = "half-shift lattice 22^3"


def nn_lattice():
    """Kernel 15's inputs on a 22^3 lattice, the queries shifted half a
    step along every axis: each has 8 nearest candidates at equal d2, in
    rows that different CTAs walk."""
    from pointclouds_tpu_torch.ops.registration import _to_planar

    g = np.arange(22, dtype=np.float32)
    lat = torch.from_numpy(np.stack(np.meshgrid(g, g, g, indexing="ij"),
                                    -1).reshape(-1, 3)).cuda()
    ones = torch.ones(lat.shape[0], dtype=torch.bool, device="cuda")
    return (_to_planar(lat + 0.5, ones), _to_planar(lat, ones)), {}


def icp_clouds(api, device=None):
    """bench_ops' ICP pair: 10K uniform points (seed 1) and the same points
    shifted 0.05 m along every axis."""
    src = bench_cloud(ICP_POINTS, seed=1)
    return (api.PointCloud.from_numpy(src, device=device),
            api.PointCloud.from_numpy(src + ICP_SHIFT, device=device))


def aerial_non_ground(api):
    """bench_ops' aerial clustering cloud, on the card: aerial_scene(7)
    voxelised at 0.5 m, less the inliers of a RANSAC plane (0.3 m, 300
    iterations, seed 11)."""
    from pointclouds_tpu_torch.pipelines.scenes import aerial_scene

    ds = api.voxel_downsample(api.PointCloud.from_numpy(aerial_scene(7)), 0.5)
    return ds.select_inverse(api.ransac_plane_seeded(ds, 0.3, 300, 11).inliers)


def round_trip(api, cloud, fmt):
    """Write ``cloud`` in ``fmt`` ("pcd", "pcd_binary", "ply", "ply_binary")
    and read it back."""
    path = IO_DIR / f"round_trip.{fmt.split('_')[0]}"
    getattr(api, f"write_{fmt}")(str(path), cloud)
    return getattr(api, f"read_{fmt.split('_')[0]}")(str(path))


def oracle_knn(pts, queries, idx, dist, k, tree=None):
    """Against the float64 cKDTree (``tree``, or one built on ``pts``):
    (rows whose distances are off by more than rtol 1e-6, rows whose index
    set differs where the kth neighbour is untied, rows with a tie within
    1e-6 at the kth)."""
    from scipy.spatial import cKDTree

    if tree is None:
        tree = cKDTree(pts.astype(np.float64))
    d, i = tree.query(queries.astype(np.float64), k + 1, workers=-1)
    tied = (d[:, k] - d[:, k - 1]) <= 1e-6 * d[:, k]
    bad_d = ~np.isclose(dist, d[:, :k], rtol=1e-6, atol=0).all(axis=1)
    bad_i = (np.sort(idx, axis=1) != np.sort(i[:, :k], axis=1)).any(axis=1)
    return int(bad_d.sum()), int((bad_i & ~tied).sum()), int(tied.sum())


def canonical_clusters(labels, lo, hi):
    """Component lists of ``labels`` with size in [lo, hi], canonically
    ordered (size descending, then first member; members ascending)."""
    order = np.argsort(labels, kind="stable")
    sl = labels[order]
    starts = np.nonzero(np.r_[True, sl[1:] != sl[:-1]])[0]
    ends = np.r_[starts[1:], len(sl)]
    out = [order[a:b].tolist() for a, b in zip(starts, ends)
           if lo <= b - a <= hi]
    out.sort(key=lambda c: (-len(c), c))
    return out


def oracle_clusters(pts, r):
    """(clusters of the float64 query_pairs graph's connected components,
    pairs within 1e-6 of the radius)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    p64 = pts.astype(np.float64)
    pairs = cKDTree(p64).query_pairs(r * (1 + 1e-6), output_type="ndarray")
    dist = np.linalg.norm(p64[pairs[:, 0]] - p64[pairs[:, 1]], axis=1)
    near = int((dist > r * (1 - 1e-6)).sum())
    pairs = pairs[dist <= r]
    n = len(pts)
    graph = coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])),
                       shape=(n, n))
    _, labels = connected_components(graph, directed=False)
    return canonical_clusters(labels, *CLUSTER_SIZES), near


def icp_close(a, b, atol=1e-5) -> bool:
    return (a.num_iterations == b.num_iterations
            and a.converged == b.converged
            and np.abs(np.subtract(a.rotation, b.rotation)).max() <= atol
            and np.abs(np.subtract(a.translation, b.translation)).max()
            <= atol)


def phase7_kernels(card_line, K, api, knn_cloud, queries):
    """Kernel 10 cross-cloud (100K queries against 100K points) and kernel
    15 on a half-shifted lattice (every query has tied nearest candidates),
    each against its plain version, with its times and bound."""
    cross = capture_inputs(lambda: api.knn(knn_cloud, queries, 10),
                           ["sweep_knn_select"])["sweep_knn_select"]
    out = {}
    for label, name, (args, kwargs) in (
            ("cross-cloud 100K x 100K", "sweep_knn_select", cross),
            (NN_LATTICE, "nn_argmin", nn_lattice())):
        err, tol, ms, plain_ms = check_kernel(name, args, kwargs, K)
        nbytes, ops = work(name, args, kwargs,
                           getattr(K, name)(*args, **kwargs))
        bms, by = bound_ms(nbytes, ops)
        log(f"kernel {name} ({label}): shapes="
            f"{[tuple(a.shape) for a in args if torch.is_tensor(a)]} "
            f"agrees ({tol}, max_abs_err={err}) kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bms:.5f} ms ({by}: {nbytes} B, "
            f"{ops} ops) [{card_line}]")
        out[f"{name} {label}"] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms, bound_ms=bms,
                                      bound_by=by)
    return out


def host_queries(card_line, api, use_native=True):
    """The host index's single-point queries on 100K points in a 100 m box:
    build time and per-query microseconds (one query at the box centre
    repeated, the reference's method; 2000 random queries), and 50 queries
    held against the float64 cKDTree. ``use_native=False``: the numpy
    index, for comparison (the C++ index serves where it is built)."""
    from scipy.spatial import cKDTree

    from pointclouds_tpu_torch import native

    pts = bench_cloud(100_000, box=100.0)
    c = api.PointCloud.from_numpy(pts)
    stub = [] if use_native else [(native, "create_index")]
    with Spy(stub, lambda name, orig, a, k: None):
        t0 = time.perf_counter()
        c._index()
        build_ms = (time.perf_counter() - t0) * 1e3
    kind = type(c._index()._native).__name__ if use_native else "numpy"
    if use_native and c._index()._native is None:
        raise AssertionError("the 100K host index is not the C++ index")
    centre = np.full(3, 50.0, np.float32)
    qs = (np.random.default_rng(9).random((2000, 3)) * 100).astype(np.float32)
    res = dict(index=kind, build_ms=build_ms)
    for name, fn, q in (
            ("knn_indices k10 centre", lambda q: api.knn_indices(c, q, 10),
             [centre] * 5000),
            ("radius_search r0.1 centre",
             lambda q: api.radius_search(c, q, 0.1), [centre] * 5000),
            ("knn_indices k10 random", lambda q: api.knn_indices(c, q, 10),
             qs),
            ("radius_search r2.0 random",
             lambda q: api.radius_search(c, q, 2.0), qs)):
        t0 = time.perf_counter()
        for qq in q:
            fn(qq)
        res[name] = (time.perf_counter() - t0) * 1e6 / len(q)
    tree = cKDTree(pts.astype(np.float64))
    for qq in qs[:50]:
        q64 = qq.astype(np.float64)
        if sorted(api.knn_indices(c, qq, 10)) != sorted(
                tree.query(q64, 10)[1].tolist()):
            raise AssertionError("knn_indices differs from the oracle")
        if api.radius_search(c, qq, 2.0) != sorted(
                tree.query_ball_point(q64, 2.0)):
            raise AssertionError("radius_search differs from the oracle")
    log(f"host index 100K in a 100 m box ({kind}): build {build_ms:.3f} "
        f"ms; per query (us): " + ", ".join(
            f"{k} {v:.3f}" for k, v in res.items()
            if k not in ("build_ms", "index"))
        + f"; 50 queries equal to the cKDTree oracle [{card_line}]")
    return res


def phase7(card_line, K, add):
    """kNN, clustering, ICP and I/O on the card: kernel checks, each op's
    kernels launched, p50 over 5 calls and the profiler's breakdown, and
    the gates (kNN against a cKDTree oracle, ICP and clusters against the
    port's CPU run, clusters against a query_pairs + connected-components
    oracle, files byte-equal to the CPU run's)."""
    from pointclouds_tpu_torch import api

    u100k, q100k = bench_cloud(100_000), bench_cloud(100_000, seed=1)
    knn_cloud = api.PointCloud.from_numpy(u100k)
    record = dict(card=card_line,
                  kernels=phase7_kernels(card_line, K, api, knn_cloud, q100k))
    icp_src, icp_tgt = icp_clouds(api)
    icp_tgt_n = api.estimate_normals(icp_tgt, 10)
    slab = slab_cloud()
    slab_c = api.PointCloud.from_numpy(slab)
    ng_c = aerial_non_ground(api)
    ng = ng_c.to_numpy()
    IO_DIR.mkdir(parents=True, exist_ok=True)
    ops7 = [
        ("knn k10 all 100K", "knn", lambda: api.knn(knn_cloud, u100k, 10)),
        ("knn k10 cross 100K", "knn_cross",
         lambda: api.knn(knn_cloud, q100k, 10)),
        ("icp_point_to_point 10K x50", "icp",
         lambda: api.icp_point_to_point(icp_src, icp_tgt, max_iterations=50)),
        ("icp_point_to_plane 10K x50", "icp",
         lambda: api.icp_point_to_plane(icp_src, icp_tgt_n,
                                        max_iterations=50)),
        ("euclidean_cluster slab 100K r0.5", "cluster",
         lambda: api.euclidean_cluster(slab_c, 0.5, *CLUSTER_SIZES)),
        (f"euclidean_cluster aerial non-ground {len(ng)} r2.0", "cluster",
         lambda: api.euclidean_cluster(ng_c, 2.0, *CLUSTER_SIZES)),
    ] + [(f"{fmt} round trip 100K", "io",
          lambda fmt=fmt: round_trip(api, knn_cloud, fmt))
         for fmt in ("pcd", "pcd_binary", "ply", "ply_binary")]
    outs, ops = {}, {}
    for name, path, call in ops7:
        out, launches = path_launches(K, path, call)
        add(launches)
        outs[name] = out
        ms, times = p50_ms(call)
        prof = None if path == "io" else profile_op(call)
        log(f"op {name}: p50 {ms:.3f} ms over 5 calls "
            f"({', '.join(f'{t:.3f}' for t in times)}) launches per call "
            f"{ {n: v for n, v in launches.items() if v} } [{card_line}]")
        if prof is not None:
            log(f"  profiler: device busy {prof[0]:.3f} of the window, "
                f"{prof[1]:.0f} device kernels per call, top {prof[2]}")
        ops[name] = dict(p50_ms=ms, times_ms=times, launches=launches,
                         profile=prof)
    record["ops"] = ops

    gates = {}
    for name, queries in (("knn k10 all 100K", u100k),
                          ("knn k10 cross 100K", q100k)):
        idx, dist = outs[name]
        bad_d, bad_i, tied = oracle_knn(u100k, queries, idx, dist, 10)
        gates[name] = dict(distances_off=bad_d, sets_differ=bad_i,
                           tied=tied)
        log(f"oracle {name}: {bad_d} rows' distances off by > rtol 1e-6, "
            f"{bad_i} index sets differ ({tied} rows tied at the kth)")
        if bad_d or bad_i:
            raise AssertionError(f"{name}: differs from the cKDTree oracle")

    cpu_src, cpu_tgt = icp_clouds(api, "cpu")
    for name, cpu in (
            ("icp_point_to_point 10K x50",
             lambda: api.icp_point_to_point(cpu_src, cpu_tgt,
                                            max_iterations=50)),
            ("icp_point_to_plane 10K x50",
             lambda: api.icp_point_to_plane(
                 cpu_src, api.estimate_normals(cpu_tgt, 10),
                 max_iterations=50))):
        got, want = outs[name], cpu()
        gates[name] = dict(card=repr(got), cpu=repr(want),
                           translation=got.translation)
        log(f"{name}: card {got} translation {got.translation}; CPU {want}")
        if not (icp_close(got, want) and got.converged):
            raise AssertionError(f"{name}: differs from the CPU run")

    for name, pts, r in (("euclidean_cluster slab 100K r0.5", slab, 0.5),
                         (f"euclidean_cluster aerial non-ground {len(ng)} "
                          "r2.0", ng, 2.0)):
        got = outs[name]
        cpu = api.euclidean_cluster(api.PointCloud.from_numpy(
            pts, device="cpu"), r, *CLUSTER_SIZES)
        want, near = oracle_clusters(pts, r)
        gates[name] = dict(clusters=len(got), sizes=[len(c) for c in got[:8]],
                           cpu_equal=got == cpu, oracle_equal=got == want,
                           pairs_near_radius=near)
        log(f"{name}: {len(got)} clusters (largest {[len(c) for c in got[:8]]}"
            f"), equal to the CPU run: {got == cpu}, to the oracle: "
            f"{got == want} ({near} pairs within 1e-6 of the radius)")
        if got != cpu or (got != want and near == 0):
            raise AssertionError(f"{name}: differs from the CPU run or oracle")

    cpu_cloud = api.PointCloud.from_numpy(u100k, device="cpu")
    n10 = bench_cloud(10_000)
    with_normals = [api.estimate_normals(api.PointCloud.from_numpy(
        n10, device=d), 10) for d in (None, "cpu")]
    for fmt in ("pcd", "pcd_binary", "ply", "ply_binary"):
        files = []
        for d, c in (("card", knn_cloud), ("cpu", cpu_cloud)):
            path = IO_DIR / f"{d}.{fmt}"
            getattr(api, f"write_{fmt}")(str(path), c)
            files.append(path.read_bytes())
        if fmt.startswith("ply"):  # with the normals each device computed
            for d, c in zip(("card", "cpu"), with_normals):
                path = IO_DIR / f"{d}_normals.{fmt}"
                getattr(api, f"write_{fmt}")(str(path), c)
                files.append(path.read_bytes())
        same = files[0] == files[1] and files[2:3] == files[3:4]
        gates[f"{fmt} files"] = dict(byte_equal=same,
                                     bytes=[len(f) for f in files])
        log(f"{fmt}: files written on the card byte-equal to the CPU run's: "
            f"{same} ({[len(f) for f in files]} bytes)")
        if not same:
            raise AssertionError(f"{fmt}: card and CPU files differ")
    for path in IO_DIR.iterdir():
        path.unlink()
    IO_DIR.rmdir()
    record["gates"] = gates
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "phase7.json").write_text(json.dumps(record, indent=1,
                                                    default=str))


# ── The cell-grid KITTI backends and the large-cloud hop loop (phase 8) ─────

CELLGRID_BACKENDS = ("xla", "pallas")
# A uniform cloud of 1.2M points (bucket 2^21, above the reference's
# residency gate of 2^20 rows; 9,375 full blocks of 128) in a 63 m cube:
# 126^3 sort cells of ~0.5 m, within the sweep's 2^21-cell table. At r 0.5
# a point has 2.5 neighbours on average (below 3D continuum percolation,
# ~2.7), so the cloud falls into many finite components.
LARGE_POINTS = 1_200_000
LARGE_BOX = 63.0
LARGE_R = 0.5


def large_points():
    """Phase 8's uniform 1.2M-point cloud in a 63 m cube."""
    return (np.random.default_rng(8).random((LARGE_POINTS, 3))
            * LARGE_BOX).astype(np.float32)


def large_cloud(api):
    return api.PointCloud.from_numpy(large_points())



def brute_captures(overflow, clean):
    """Kernel 13's other SOR ops, as (label, cloud): the overflow cloud
    (its most live queries) and the clean 100K cloud (no live block)."""
    return (("sor overflow", overflow), ("sor clean 100K", clean))


def seg_capture(pc, kdata, fn):
    """Kernel 18's inputs in the "xla" KITTI frame (seed 0) at caller
    ``fn``."""
    return capture_inputs(
        lambda: run_kitti(pc, kdata, 0, "cuda", sor_backend="xla"),
        ["segmented_select"], within=fn)


def seg_captures(pc, kdata):
    """Kernel 18's inputs in the "xla" KITTI frame (seed 0), per caller."""
    return {f"kitti xla {fn}": seg_capture(pc, kdata, fn)
            for fn in SEG_CALLERS}


def seg_topk(args, kwargs):
    """Kernel 18's yardstick: ``torch.topk`` of its rows."""
    return lambda: torch.topk(args[0], kwargs["k"], dim=1, largest=False)


def phase8_kernels(card_line, K, pc, kdata, api, large):
    """Kernels 16-18 against their plain versions, at the inputs the
    KITTI cell-grid backends and the large-cloud clustering give them;
    kernel 18's yardstick is ``torch.topk`` of its rows. Returns the
    kernels' rows and kernel 18's row at its second caller."""
    seg = seg_captures(pc, kdata)
    first, second = seg
    captured = dict(seg[first])
    for run, names in (
            (lambda: run_kitti(pc, kdata, 0, "cuda", sor_backend="pallas"),
             ["sor_select"]),
            (lambda: api.euclidean_cluster(large, LARGE_R, *CLUSTER_SIZES),
             ["cluster_propagate"])):
        captured.update(capture_inputs(run, names))
    rows = []
    for name in PHASE8_KERNELS:
        args, kwargs = captured[name]
        is_seg = name == "segmented_select"
        rows.append(kernel_row(name, args, kwargs, K, card_line,
                               seg_topk(args, kwargs) if is_seg else None,
                               first if is_seg else ""))
        if name == "sor_select":
            call = lambda: K.sor_select(*args, **kwargs)  # noqa: E731
            rows[-1]["device_ms"] = device_ms(call)
            log(f"kernel sor_select: device {ms_text(rows[-1]['device_ms'])} ms "
                f"a call (torch.profiler), {select_cells(*args)}; (registers "
                f"a thread, shared memory bytes) {kernel_resources(call)} "
                f"[{card_line}]")
    args, kwargs = seg[second]["segmented_select"]
    extra = kernel_row("segmented_select", args, kwargs, K, card_line,
                       seg_topk(args, kwargs), second)
    return rows, extra


def select_cells(q, qm, cand, cv) -> str:
    """What kernel 17 sees: cells with a valid query, valid queries and
    valid candidate slots a cell."""
    live = qm.any(1)
    nv = cv.sum(1)[live].float()
    if not nv.numel():
        return "no live cell"
    return (f"{int(live.sum())} of {qm.shape[0]} cells live, "
            f"{int(qm.sum())} valid queries (max {int(qm.sum(1).max())} a "
            f"cell), valid slots a live cell mean {float(nv.mean()):.2f} max "
            f"{int(nv.max())} of {cv.shape[1]}")


def kitti_summary(pc, out) -> dict:
    return dict(ds=int(out.downsampled_valid.sum()),
                kept=int(out.cleaned_valid.sum()),
                inliers=int(out.inlier_mask.sum()),
                clusters=[len(c) for c in kitti_points(pc, out)],
                sor_certified=bool(out.sor_certified),
                grid_flags=out.grid_flags.cpu().tolist(),
                obstacle_overflow=bool(out.obstacle_overflow))


def phase8(card_line, K, pc, kdata, add):
    """The KITTI bench frame through the cell-grid backends (seeds 0-4:
    launches, flags, certificate and clusters reported; seed 0 equal to the
    port's CPU run), then `euclidean_cluster` on the large cloud through
    the hop loop (hops, launches, p50; clusters equal to a query_pairs +
    connected-components oracle). Returns kernels 16-18's rows."""
    from pointclouds_tpu_torch import api

    large_pts = large_points()
    large = api.PointCloud.from_numpy(large_pts)
    rows, seg_extra = phase8_kernels(card_line, K, pc, kdata, api, large)
    record = dict(card=card_line, kitti={}, segmented_select_extra=seg_extra)
    kcloud = pc.make_cloud_arrays(kdata, device="cuda")
    for backend in CELLGRID_BACKENDS:
        outs, launches = path_launches(K, f"kitti_{backend}", lambda: {
            seed: run_kitti(pc, kdata, seed, cloud=kcloud,
                            sor_backend=backend) for seed in SEEDS})
        add(launches)
        per_seed = {seed: kitti_summary(pc, out) for seed, out in outs.items()}
        for seed, s in per_seed.items():
            log(f"kitti {backend} seed {seed}: {s}")
        cpu = run_kitti(pc, kdata, 0, "cpu", sor_backend=backend)
        got = outs[0]
        same = dict(
            centroids=torch.equal(got.centroids.cpu().view(torch.int32),
                                  cpu.centroids.view(torch.int32)),
            keep=torch.equal(got.cleaned_valid.cpu(), cpu.cleaned_valid),
            plane=torch.equal(got.plane_normal.cpu(), cpu.plane_normal),
            clusters=same_clusters(kitti_points(pc, got),
                                   kitti_points(pc, cpu)))
        log(f"kitti {backend} seed 0 equal to the CPU run: {same}")
        if not all(same.values()):
            raise AssertionError(f"kitti {backend}: differs from the CPU run")
        timed_frames(lambda f: run_kitti(pc, kdata, f % len(SEEDS),
                                         cloud=kcloud, sor_backend=backend),
                     len(SEEDS), card_line, f"kitti {backend}")
        record["kitti"][backend] = dict(seeds=per_seed, launches=launches,
                                        cpu_equal=same)

    call = lambda: api.euclidean_cluster(large, LARGE_R,  # noqa: E731
                                         *CLUSTER_SIZES)
    got, launches = path_launches(K, "cluster_large", call)
    add(launches)
    ms, times = p50_ms(call)
    want, near = oracle_clusters(large_pts, LARGE_R)
    hops = launches["cluster_propagate"]
    log(f"euclidean_cluster uniform {LARGE_POINTS} in a {LARGE_BOX} m cube "
        f"r{LARGE_R}: {len(got)} clusters (largest "
        f"{[len(c) for c in got[:8]]}), {hops} hops, p50 {ms:.3f} ms over 5 "
        f"calls ({', '.join(f'{t:.3f}' for t in times)}), equal to the "
        f"oracle: {got == want} ({near} pairs within 1e-6 of the radius) "
        f"[{card_line}]")
    if got != want and near == 0:
        raise AssertionError("large euclidean_cluster differs from the oracle")
    record["cluster_large"] = dict(clusters=len(got), hops=hops, p50_ms=ms,
                                   times_ms=times, oracle_equal=got == want,
                                   pairs_near_radius=near)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "phase8.json").write_text(json.dumps(record, indent=1,
                                                    default=str))
    return rows


# ── The int64-keyed grid at 2^24 points and the host C++ (phase 9) ──────────

HUGE_POINTS = 1 << 24
HUGE_BOX = 256.0  # 1 point a cubic metre
HUGE_QUERIES = 65_536
HUGE_K = 10
HUGE_R = 0.7  # ~1.44 neighbours a point: below percolation, small components
HUGE_SIZES = (1, 10**9)


def huge_cloud():
    """(points f32[2^24, 3] uniform in a 256 m cube, 65,536 queries in it)."""
    rng = np.random.default_rng(24)
    pts = (rng.random((HUGE_POINTS, 3)) * HUGE_BOX).astype(np.float32)
    return pts, (rng.random((HUGE_QUERIES, 3)) * HUGE_BOX).astype(np.float32)


def huge_cluster_oracle(tree, pts, r):
    """(component labels, pairs whose float64 and f32 judgments differ):
    the components of the pairs the reference's f32 rule accepts (the
    pinned d2 fma(dz, dz, fma(dy, dy, dx*dx)) <= f32(r^2)), found among the
    float64 cKDTree's query_pairs at r(1 + 1e-6)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from pointclouds_tpu_torch.spatial.knn import _d2_sum

    pairs = tree.query_pairs(r * (1 + 1e-6), output_type="ndarray")
    p = torch.from_numpy(pts)
    a, b = torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1])
    keep = (_d2_sum(p[a], p[b]) <= torch.tensor(np.float32(r * r))).numpy()
    d64 = np.linalg.norm(pts[pairs[:, 0]].astype(np.float64)
                         - pts[pairs[:, 1]].astype(np.float64), axis=1)
    differ = int((keep != (d64 <= r)).sum())
    pairs = pairs[keep]
    n = len(pts)
    graph = coo_matrix((np.ones(len(pairs), np.int8),
                        (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    return connected_components(graph, directed=False)[1], differ


def is_canonical_partition(clusters, labels) -> bool:
    """Whether ``clusters`` (lists over every row) are exactly the
    components of ``labels``, canonically ordered: size descending, then
    first member; members ascending."""
    import itertools

    n = len(labels)
    sizes = np.fromiter(map(len, clusters), np.int64, len(clusters))
    if sizes.sum() != n or len(clusters) != np.unique(labels).size:
        return False
    members = np.fromiter(itertools.chain.from_iterable(clusters), np.int64,
                          n)
    if np.bincount(members, minlength=n).max() != 1:
        return False
    same = np.repeat(np.arange(len(sizes)), sizes)
    same = same[1:] == same[:-1]
    lab = labels[members]
    firsts = members[np.r_[0, np.cumsum(sizes)[:-1]]]
    return bool((lab[1:] == lab[:-1])[same].all()
                and (members[1:] > members[:-1])[same].all()
                and ((sizes[1:] < sizes[:-1])
                     | ((sizes[1:] == sizes[:-1])
                        & (firsts[1:] > firsts[:-1]))).all())


def counted(targets, spent=None):
    """A Spy counting the calls of each target (as (module, name)); with
    ``spent`` (a dict), also each one's host-clock ms, ending in a
    synchronize."""
    calls = {name: 0 for _, name in targets}

    def hook(name, orig, a, k):
        calls[name] += 1
        if spent is None:
            return orig(*a, **k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        spent[name] = spent.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    return Spy(targets, hook), calls


def huge_phase(card_line, K, add, api):
    """`knn` (65,536 queries, k 10) and `euclidean_cluster` (r 0.7, min 1,
    max 10^9) on 2^24 uniform points in a 256 m cube: both through the
    int64-keyed grid (spied), against float64 cKDTree oracles built once;
    p50s, device ms and the clustering's peak device memory."""
    from scipy.spatial import cKDTree

    from pointclouds_tpu_torch.ops import segmentation
    from pointclouds_tpu_torch.spatial import engine

    t0 = time.perf_counter()
    pts, queries = huge_cloud()
    torch.cuda.empty_cache()
    cloud = api.PointCloud.from_numpy(pts, device="cuda")
    log(f"phase 9: {HUGE_POINTS} points in a {HUGE_BOX:g} m cube, capacity "
        f"{cloud._arrs.capacity}, on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    rec = dict(card=card_line)

    knn_call = lambda: api.knn(cloud, queries, HUGE_K)  # noqa: E731
    spy, calls = counted([(engine, "_knn_int64"), (engine, "bruteforce_knn")])
    with spy:
        (idx, dist), launches = path_launches(K, "knn_huge", knn_call)
    add(launches)
    if calls["_knn_int64"] != 1 or calls["bruteforce_knn"]:
        raise AssertionError(f"knn 2^24 did not take the int64 grid: {calls}")
    ms, times = p50_ms(knn_call, reps=3)
    dev = device_ms(knn_call, reps=2)
    t0 = time.perf_counter()
    tree = cKDTree(pts.astype(np.float64))
    tree_s = time.perf_counter() - t0
    bad_d, bad_i, tied = oracle_knn(pts, queries, idx, dist, HUGE_K, tree)
    finite = bool(np.isfinite(dist).all()) and idx.shape == (HUGE_QUERIES,
                                                            HUGE_K)
    log(f"knn 2^24 k{HUGE_K} x {HUGE_QUERIES} queries: _knn_int64 calls "
        f"{calls['_knn_int64']}, p50 {ms:.3f} ms over 3 calls "
        f"({', '.join(f'{t:.3f}' for t in times)}), device "
        f"{ms_text(dev, 3)} ms a call (torch.profiler); cKDTree oracle (built "
        f"in {tree_s:.1f} s): {bad_d} rows' distances off by > rtol 1e-6, "
        f"{bad_i} index sets differ ({tied} tied at the kth); finite "
        f"{finite} [{card_line}]")
    if bad_d or bad_i or not finite:
        raise AssertionError("knn 2^24 differs from the cKDTree oracle")
    rec["knn"] = dict(p50_ms=ms, times_ms=times, device_ms=dev,
                      int64_calls=calls["_knn_int64"], distances_off=bad_d,
                      sets_differ=bad_i, tied=tied)

    cluster_call = lambda: api.euclidean_cluster(  # noqa: E731
        cloud, HUGE_R, *HUGE_SIZES)
    spent = {}
    spy, calls = counted([(engine, "radius_neighbors"),
                          (segmentation, "propagate_labels"),
                          (segmentation, "bruteforce_cluster_labels"),
                          (engine, "sweep_cluster_labels"),
                          (engine, "_cell_graph_rung"),
                          (api._engine, "cluster_labels"),
                          (api._native, "cluster_epilogue"),
                          (api, "_cluster_lists")], spent)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with spy:
        clusters, launches = path_launches(K, "cluster_huge", cluster_call)
    first_ms = (time.perf_counter() - t0) * 1e3
    add(launches)
    peak = torch.cuda.max_memory_allocated()
    if (calls["radius_neighbors"] != 1 or calls["propagate_labels"] != 1
            or calls["bruteforce_cluster_labels"]
            or calls["sweep_cluster_labels"] or calls["_cell_graph_rung"]):
        raise AssertionError(f"euclidean_cluster 2^24 rungs: {calls}")
    log("euclidean_cluster 2^24, the spied call's host ms (each ending in a "
        "synchronize): " + ", ".join(f"{k} {v:.3f}" for k, v in spent.items())
        + f" of {first_ms:.3f}")
    times = [first_ms]
    for _ in range(2):
        t0 = time.perf_counter()
        cluster_call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    dev = device_ms(cluster_call, reps=1)
    t0 = time.perf_counter()
    labels, differ = huge_cluster_oracle(tree, pts, HUGE_R)
    oracle_s = time.perf_counter() - t0
    equal = is_canonical_partition(clusters, labels)
    sizes = [len(c) for c in clusters[:8]]
    log(f"euclidean_cluster 2^24 r{HUGE_R}: rungs {calls}, {len(clusters)} "
        f"clusters (largest {sizes}), p50 {np.median(times):.3f} ms over 3 "
        f"calls ({', '.join(f'{t:.3f}' for t in times)}; the first spied), "
        f"device {ms_text(dev, 3)} ms a call, peak device memory "
        f"{peak / 2**30:.2f} GiB; equal to the query_pairs + connected "
        f"components oracle in canonical order: {equal} ({differ} pairs "
        f"judged otherwise in float64; oracle {oracle_s:.1f} s) "
        f"[{card_line}]")
    if not equal:
        raise AssertionError("euclidean_cluster 2^24 differs from the oracle")
    rec["cluster"] = dict(rungs=calls, spent_ms=spent,
                          clusters=len(clusters), largest=sizes,
                          p50_ms=float(np.median(times)), times_ms=times,
                          device_ms=dev, peak_bytes=peak,
                          f64_differ=differ)
    del cloud, clusters, tree
    torch.cuda.empty_cache()
    return rec


def host_io(card_line, api):
    """100K PCD ASCII / binary and LAS files: each written, read back
    (C++ bodies) and written again byte-equal; the reads' p50 against the
    numpy readers' on the same files."""
    from pointclouds_tpu_torch import native
    from pointclouds_tpu_torch.io import las

    pts = bench_cloud(100_000)
    IO_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    for fmt in ("pcd", "pcd_binary", "las"):
        a, b = IO_DIR / f"a.{fmt}", IO_DIR / f"b.{fmt}"
        if fmt == "las":
            las.write_las(str(a), pts)
            read = lambda: api.read_las(str(a))  # noqa: E731
            las.write_las(str(b), read().to_numpy())
        else:
            getattr(api, f"write_{fmt}")(str(a), api.PointCloud.from_numpy(
                pts, device="cpu"))
            read = lambda: api.read_pcd(str(a))  # noqa: E731
            getattr(api, f"write_{fmt}")(str(b), read())
        same = a.read_bytes() == b.read_bytes()
        ms, _ = p50_ms(read, reps=3)
        with Spy([(native, f) for f in ("parse_ascii_xyz", "gather_xyz_f32",
                                        "decode_las")],
                 lambda name, orig, a, k: None):  # the numpy readers
            plain_ms, _ = p50_ms(read, reps=3)
        log(f"{fmt} 100K read: p50 {ms:.3f} ms (C++), {plain_ms:.3f} ms "
            f"(numpy); written again byte-equal: {same} ({len(a.read_bytes())}"
            f" bytes) [{card_line}]")
        if not same:
            raise AssertionError(f"{fmt}: round trip not byte-equal")
        out[fmt] = dict(read_ms=ms, numpy_read_ms=plain_ms, byte_equal=same)
    for path in IO_DIR.iterdir():
        path.unlink()
    IO_DIR.rmdir()
    return out


def slab_epilogue(card_line):
    """`native.cluster_epilogue` on the 100K slab clustering's labels (r
    0.5) against the numpy epilogue: equal, with both times."""
    from pointclouds_tpu_torch import native
    from pointclouds_tpu_torch.core.cloud import make_cloud_arrays
    from pointclouds_tpu_torch.spatial import engine

    arrs = make_cloud_arrays(slab_cloud(), device="cuda")
    labels = engine.cluster_labels(arrs.xyz, arrs.valid, 0.5,
                                   n_valid=100_000)[:100_000]
    native.cluster_epilogue(labels, *CLUSTER_SIZES)  # loads the library
    t0 = time.perf_counter()
    order, starts = native.cluster_epilogue(labels, *CLUSTER_SIZES)
    got = [order[a:b].tolist() for a, b in zip(starts[:-1], starts[1:])]
    c_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = canonical_clusters(labels, *CLUSTER_SIZES)
    np_ms = (time.perf_counter() - t0) * 1e3
    log(f"cluster_epilogue on the slab's labels: {len(got)} clusters, equal "
        f"to the numpy epilogue: {got == want}; {c_ms:.3f} ms (C++), "
        f"{np_ms:.3f} ms (numpy) [{card_line}]")
    if got != want:
        raise AssertionError("cluster_epilogue differs from numpy")
    return dict(clusters=len(got), ms=c_ms, numpy_ms=np_ms)


def phase9(card_line, K, add):
    """The int64-keyed grid at 2^24 points and the host C++: the C++ must
    be built (`native.available()`) and serve the host index."""
    from pointclouds_tpu_torch import api, native

    if not native.available():
        raise AssertionError("the host C++ did not build (no compiler)")
    record = dict(card=card_line, index_kind=native.index_kind())
    log(f"phase 9: host C++ built, index served by {native.index_kind()}")
    record["host_index"] = host_queries(card_line, api)
    record["host_index_numpy"] = host_queries(card_line, api,
                                              use_native=False)
    record["io"] = host_io(card_line, api)
    record["epilogue"] = slab_epilogue(card_line)
    record["huge"] = huge_phase(card_line, K, add, api)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "phase9.json").write_text(json.dumps(record, indent=1,
                                                    default=str))


# ── The cell-grid kNN rungs and engine.radius_count (phase 10) ──────────────

RUNG_QUERIES = 1000
RUNG_RADIUS = 0.5
GIVE_UP_CAP = 4  # the fused sweep's rescue cap where it must give up
GIVE_UP_FAR = 5000  # far queries: the cross sweep gives up above 4,096
RUNG_NAMES = ("build_cellgrid", "point_knn", "slab_knn", "point_radius_count",
              "bruteforce_knn", "bruteforce_radius_count",
              "_knn_sweep_same_cloud", "_knn_sweep_cross")


def rung_spy(engine):
    """A Spy recording the rungs `engine.knn` and `engine.radius_count`
    take, in order: each grid built (capacity, cell cap, overflow), each
    grid kNN pass with its flagged rows, each brute force with its valid
    queries, each sweep and grid count."""
    taken = []

    def hook(name, orig, a, k):
        out = orig(*a, **k)
        if name == "build_cellgrid":
            taken.append(("grid", k["m_per_cell"], k["cell_cap"],
                          bool(out.overflow)))
        elif name in ("point_knn", "slab_knn"):
            taken.append((name, int((~out[3]).sum())))
        elif name.startswith("bruteforce"):
            taken.append((name, int(a[3].sum())))
        else:
            taken.append((name,))
        return out

    return Spy([(engine, n) for n in RUNG_NAMES], hook), taken


def rung_text(taken) -> str:
    """The rungs, the grids folded into the pass that follows them."""
    out = []
    for t in taken:
        if t[0] == "grid":
            out.append(f"grid(m {t[1]}, cap {t[2]}{', overflow' if t[3] else ''})")
        elif len(t) == 2:
            out.append(f"{t[0]}[{'flagged' if 'knn' in t[0] and 'brute' not in t[0] else 'queries'} {t[1]}]")
        else:
            out.append(t[0])
    return " -> ".join(out)


def oracle_counts(tree, queries, counts, r):
    """Rows whose count lies outside the float64 cKDTree's counts at r(1 -
    1e-6) and r(1 + 1e-6) (the f32 and float64 judgments may differ only
    for pairs that near the radius); the rows with such a pair."""
    q = queries.astype(np.float64)
    lo = tree.query_ball_point(q, r * (1 - 1e-6), return_length=True,
                               workers=-1)
    hi = tree.query_ball_point(q, r * (1 + 1e-6), return_length=True,
                               workers=-1)
    return int(((counts < lo) | (counts > hi)).sum()), int((lo != hi).sum())


def parent_sweep_knn(pxyz, pvalid, qxyz, qvalid, k: int):
    """The parent commit's `engine.knn` where a sweep gives up (k <= 24,
    more than `BRUTE_THRESHOLD` points): same cloud, on `knn_fused`'s
    rescue-cap overflow, the two-pass sweep again and the brute force of
    every row it left flagged; across clouds, the cross sweep and the brute
    force of every flagged query, however many."""
    from pointclouds_tpu_torch.ops.fusedops import fused_rescue_cap, knn_fused
    from pointclouds_tpu_torch.spatial import engine
    from pointclouds_tpu_torch.spatial.sweep import sweep_knn_two_pass

    n = pxyz.shape[0]
    wr = engine._sweep_wr(n)
    if qxyz is pxyz:
        cap = fused_rescue_cap(n)
        d, i, nv, exact = knn_fused(pxyz, pvalid, k=k, wr=wr, cap=cap)
        if bool(exact):
            return d, i, nv
        cell = engine.estimate_cell_size(pxyz, pvalid, k)
        d, i, nv, ok = sweep_knn_two_pass(pxyz, pvalid, np.float32(cell), k=k,
                                          fix_cap=cap, wr=wr)
    else:
        cell = engine.estimate_cell_size(pxyz, pvalid, k)
        d, i, nv, ok = engine.sweep_knn_cross_two_pass(
            pxyz, pvalid, qxyz, qvalid, np.float32(cell), k=k, wr=wr,
            fix_cap=fused_rescue_cap(max(n, qxyz.shape[0])))
    rows = engine._residual(qxyz, qvalid, ok).nonzero(as_tuple=True)[0]
    if rows.numel() == 0:
        return d, i, nv
    sub, sv, sq = engine._subset(rows, qxyz, qvalid)
    return engine._patch_rows((d, i, nv), sub, sv,
                              engine.bruteforce_knn(pxyz, pvalid, sq, sv, k))


def give_up_queries():
    """`RUNG_QUERIES` queries in the cloud's box beside `GIVE_UP_FAR`
    queries 20-60 m from it: more than max(Q / 4, 4096) rows the cross
    sweep cannot certify."""
    far = bench_cloud(GIVE_UP_FAR, seed=6, box=40.0) + np.float32(20.0)
    return np.vstack([bench_cloud(RUNG_QUERIES, seed=7), far])


def phase10(card_line):
    """The cell-grid rungs at 100K uniform points in a 10 m box: `knn` k 30
    on the cloud's own points (the parent commit's brute force, now
    `slab_knn`), 1,000 other queries at k 10 (`point_knn`),
    `engine.radius_count` at r 0.5, and the two sweeps giving up at k 10
    (the same-cloud one with its rescue cap cut to `GIVE_UP_CAP` rows,
    the cross one with `GIVE_UP_FAR` far queries): rungs (spied), p50
    over 5 calls and device ms, beside the parent commit's path on the
    same inputs (the brute force, p50 over 3 calls and device ms, or, where
    a sweep gives up, `parent_sweep_knn`), outputs equal to the brute
    force (one call of it where it is not the parent's path; for the
    counts, of `bruteforce_radius_count`), and against cKDTree oracles."""
    from scipy.spatial import cKDTree

    from pointclouds_tpu_torch import api
    from pointclouds_tpu_torch.ops import fusedops
    from pointclouds_tpu_torch.spatial import engine

    pts = bench_cloud(100_000)
    cloud = api.PointCloud.from_numpy(pts)
    arrs = cloud._arrs
    queries = bench_cloud(RUNG_QUERIES, seed=5)
    far = give_up_queries()
    tree = cKDTree(pts.astype(np.float64))

    def via(knn_fn, call):
        # ``call`` with `engine.knn` replaced by ``knn_fn``.
        def run():
            with Spy([(api._engine, "knn")],
                     lambda name, orig, a, k: knn_fn(*a, **k)):
                return call()
        return run

    def capped(call):
        # ``call`` with the fused sweep's rescue cap cut: it gives up.
        def run():
            with Spy([(fusedops, "fused_rescue_cap")],
                     lambda name, orig, a, k: GIVE_UP_CAP):
                return call()
        return run

    def radius():
        return engine.radius_count(arrs.xyz, arrs.valid, arrs.xyz,
                                   arrs.valid, RUNG_RADIUS)

    def radius_brute():
        return engine.bruteforce_radius_count(arrs.xyz, arrs.valid, arrs.xyz,
                                              arrs.valid, RUNG_RADIUS)

    same_k10 = capped(lambda: api.knn(cloud, pts, 10))

    def cross_far():
        return api.knn(cloud, far, 10)

    # (name, k, queries, call, the parent's path or None for the brute
    # force, the rungs that must lead)
    cases = [
        ("knn k30 same 100K", 30, pts, lambda: api.knn(cloud, pts, 30), None,
         ("slab_knn",)),
        (f"knn k10 cross {RUNG_QUERIES}", 10, queries,
         lambda: api.knn(cloud, queries, 10), None, ("point_knn",)),
        (f"radius_count r{RUNG_RADIUS} 100K", None, pts, radius, None,
         ("point_radius_count",)),
        (f"knn k10 same 100K, rescue cap {GIVE_UP_CAP}", 10, pts, same_k10,
         via(parent_sweep_knn, same_k10),
         ("_knn_sweep_same_cloud", "slab_knn")),
        (f"knn k10 cross {len(far)}, {GIVE_UP_FAR} far", 10, far, cross_far,
         via(parent_sweep_knn, cross_far), ("_knn_sweep_cross", "point_knn")),
    ]
    record = dict(card=card_line)
    for name, k, q, call, parent, lead in cases:
        spy, taken = rung_spy(engine)
        with spy:
            out = call()
            torch.cuda.synchronize()
        plain = radius_brute if k is None else via(engine.bruteforce_knn,
                                                   call)
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        btimes = [(time.perf_counter() - t0) * 1e3]
        ms, times = p50_ms(call)
        dev = device_ms(call, reps=3)
        bdev = None
        if k is not None and parent is None:  # the parent's path: 3 more
            btimes = p50_ms(plain, reps=3)[1]
            bdev = device_ms(plain, reps=1)
        bms = float(np.percentile(btimes, 50))
        extra = {}
        if parent is not None:
            pms, ptimes = p50_ms(parent, reps=3)
            extra = dict(parent_p50_ms=pms, parent_times_ms=ptimes,
                         parent_device_ms=device_ms(parent, reps=1))
        if k is None:
            got_c, want_c = out.cpu().numpy(), want.cpu().numpy()
            equal = bool((got_c == want_c).all())
            bad, near = oracle_counts(tree, q, got_c[:len(q)], RUNG_RADIUS)
            gate = dict(brute_equal=equal, oracle_rows_off=bad,
                        rows_near_radius=near, mean_count=float(got_c.mean()))
            ok = equal and bad == 0
        else:
            idx, dist = out
            widx, wdist = want
            d_equal = bool(np.array_equal(dist, wdist))
            sets = int((np.sort(idx, 1) != np.sort(widx, 1)).any(1).sum())
            bad_d, bad_i, tied = oracle_knn(pts, q, idx, dist, k, tree)
            gate = dict(brute_distances_equal=d_equal,
                        brute_index_sets_differ=sets, oracle_distances_off=bad_d,
                        oracle_sets_differ=bad_i, tied=tied)
            ok = d_equal and sets <= tied and not bad_d and not bad_i
        names = tuple(t[0] for t in taken if t[0] != "grid")
        gate["rungs_lead"] = names[:len(lead)] == lead
        ok = ok and gate["rungs_lead"]
        if parent is not None:
            what = (f"the parent's path (sweep, then the brute force of the "
                    f"flagged rows) p50 {extra['parent_p50_ms']:.3f} ms, "
                    f"device {ms_text(extra['parent_device_ms'], 3)} ms; "
                    f"brute force (one call, for the equality)")
        elif k is not None:
            what = "brute force (the parent's path) p50"
        else:
            what = "brute force (one call, for the equality)"
        log(f"phase 10 {name}: rungs {rung_text(taken)}; p50 {ms:.3f} ms over "
            f"5 calls ({', '.join(f'{t:.3f}' for t in times)}), device "
            f"{ms_text(dev, 3)} ms; {what} {bms:.3f} ms, device "
            f"{ms_text(bdev, 3)} ms; gates {gate} [{card_line}]")
        record[name] = dict(rungs=taken, p50_ms=ms, times_ms=times,
                            device_ms=dev, brute_p50_ms=bms,
                            brute_times_ms=btimes, brute_device_ms=bdev,
                            **extra, **gate)
        if not ok:
            raise AssertionError(f"phase 10 {name}: {gate}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "phase10.json").write_text(json.dumps(record, indent=1,
                                                     default=str))


# ── Multi-device on the one card (phase 11) ─────────────────────────────────

MESH_SEEDS = (0, 1)
MESH_REPS = 3
# The tiled and sharded pipelines at the bench frames' configurations (the
# sharded entries take the reference's fixed kwargs, so their RANSAC scores
# every hypothesis in full).
TILED_KITTI = dict(sor_k=20, ransac_iters=500, ransac_subsample=4096,
                   obstacle_cap=8192)
SHARDED_KITTI = dict(sor_k=20, ransac_iters=500, obstacle_cap=8192)
TILED_AERIAL = dict(ransac_iters=300, ransac_subsample=4096,
                    obstacle_cap=196_608)
SHARDED_AERIAL = dict(ransac_iters=300, obstacle_cap=196_608)
MESH_PATHS = {
    "tiled kitti": ["segmented_scan_sums", "sweep_select_rows",
                    "rescue_select", "cluster_multisweep"],
    "tiled aerial": ["segmented_scan_sums", "sweep_moments",
                     "cluster_multisweep_windows"],
    "sharded kitti": ["segmented_scan_sums", "sweep_select_rows",
                      "rescue_select", "cluster_multisweep"],
    "sharded aerial": ["segmented_scan_sums", "sweep_moments",
                       "cluster_multisweep_windows"],
}


def mesh_batches():
    """Host batches: the KITTI bench frames velodyne_scene(s, 122,000) for
    s in 0-1, and the aerial bench frame aerial_scene(42) twice."""
    from pointclouds_tpu_torch.core.cloud import make_cloud_arrays
    from pointclouds_tpu_torch.pipelines.scenes import (
        aerial_scene,
        velodyne_scene,
    )

    def stack(clouds):
        arrs = [make_cloud_arrays(c, device="cpu") for c in clouds]
        return (torch.stack([a.xyz for a in arrs]).numpy(),
                torch.stack([a.valid for a in arrs]).numpy())

    return dict(kitti=stack([velodyne_scene(s, KITTI_POINTS)
                             for s in MESH_SEEDS]),
                aerial=stack([aerial_scene(42, 1.0)] * len(MESH_SEEDS)))


def mesh_paths(mesh, batches):
    """The tiled and sharded KITTI and aerial batches on ``mesh`` (inputs on
    the card): per path, its outputs (numpy), launches (counts zeroed just
    before the first call, read just after), the collectives' calls,
    host-staged calls and CUDA-event ms in that call (traced: its
    ``comm.<op>`` spans and counters), and the batch's p50 over
    `MESH_REPS` more calls, untraced."""
    import torch.distributed as dist

    from pointclouds_tpu_torch.parallel import sharding, tiles
    from pointclouds_tpu_torch.utils import profiling
    from pointclouds_tpu_torch.spatial import kernels as K

    seeds = np.asarray(MESH_SEEDS)
    kx, kv = (torch.from_numpy(a).cuda() for a in batches["kitti"])
    ax, av = (torch.from_numpy(a).cuda() for a in batches["aerial"])
    kargs = (np.float32(0.15), np.float32(2.0), np.float32(0.15), seeds,
             np.float32(0.8))
    paths = {
        "tiled kitti": lambda: tiles.tiled_kitti_pipeline(
            mesh, kx.shape[1], **TILED_KITTI)(kx, kv, *kargs),
        "tiled aerial": lambda: tiles.tiled_aerial_pipeline(
            mesh, ax.shape[1], **TILED_AERIAL)(
            ax, av, np.float32(0.5), np.float32(0.3), seeds, np.float32(2.0),
            VIEWPOINT),
        "sharded kitti": lambda: sharding.sharded_kitti_pipeline(
            mesh, **SHARDED_KITTI)(kx, kv, *kargs),
        "sharded aerial": lambda: sharding.sharded_aerial_pipeline(
            mesh, **SHARDED_AERIAL)(
            ax, av, np.float32(0.5), np.float32(3.0), np.float32(0.3), seeds,
            np.float32(2.0), VIEWPOINT),
    }
    res = {}
    t0 = time.perf_counter()
    for name, run in paths.items():
        K.reset_launch_counts()
        profiling.set_tracing(True)
        try:
            with profiling.frame(name, kx.device):
                out = run()
        finally:
            profiling.set_tracing(False)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        rec = profiling.last_frame()
        stats = {n[5:]: dict(calls=rec.count(f"{n}.calls"),
                             staged=rec.count(f"{n}.staged"),
                             ms=rec.span_ms(n))
                 for n in rec.names() if n.startswith("comm.")}
        ms, times = p50_ms(run, reps=MESH_REPS)
        log(f"phase 11 rank {dist.get_rank()} of {dist.get_world_size()}: "
            f"{name} done ({time.perf_counter() - t0:.1f} s)")
        res[name] = dict(out={f: getattr(out, f).cpu().numpy()
                              for f in out._fields},
                         launches=launches, comm=stats, p50_ms=ms,
                         times_ms=times)
    return res


def phase11_rank(rank, world, batches):
    """One rank of phase 11's world 2 (gloo, both ranks on the card)."""
    from pointclouds_tpu_torch.parallel import sharding

    torch.cuda.set_device(0)
    return mesh_paths(sharding.mesh_of(1, world), batches)


def frame_view(kind, out, b=None):
    """One frame of a tiled (``b`` its index) or unsharded output as the
    tiled tests compare it: valid centroids, kept count, plane, clusters as
    sets of coordinates, and (aerial) the normals of the valid rows."""
    from pointclouds_tpu_torch.parallel._compare import clusters_as_sets

    if b is None:  # an unsharded pipeline output
        o = {f: getattr(out, f).cpu().numpy() for f in out._fields}
        ds = o["downsampled_valid"]
        obs = (o["centroids"][o["obstacle_src"]], o["obstacle_valid"],
               o["labels"])
        kept = int(o["cleaned_valid"].sum()) if kind == "kitti" else None
    else:
        o = {f: v[b] for f, v in out.items()}
        ds = o["downsampled_valid"]
        obs = (o["obstacle_xyz"], o["obstacle_valid"], o["labels"])
        kept = int(o["cleaned_count"]) if kind == "kitti" else None
    normals = ((o["normals"][ds], o["normals_ok"][ds]) if kind == "aerial"
               else None)
    return dict(cents=o["centroids"][ds], kept=kept, plane=o["plane_normal"],
                clusters=clusters_as_sets(*obs, 10 if kind == "kitti" else 20),
                normals=normals)


def tiles_rules(kind, got, want) -> dict:
    """`tests/test_tiles.py`'s (KITTI) or `tests/test_tiles_aerial.py`'s
    rules between two frame views, from `parallel/_compare.py`, which the
    port's tiled tests share."""
    from pointclouds_tpu_torch.parallel import _compare as cmp

    res = dict(centroids=cmp.centroid_sets_close(got["cents"], want["cents"]),
               plane=cmp.plane_close(got["plane"], want["plane"]),
               clusters=got["clusters"] == want["clusters"],
               n_clusters=len(got["clusters"]))
    if kind == "kitti":
        res["kept"] = (got["kept"], want["kept"])
        res["kept_ok"] = cmp.kept_close(got["kept"], want["kept"])
    else:
        res["normals"] = cmp.normals_match(got["cents"], *got["normals"],
                                           want["cents"], *want["normals"])
    res["ok"] = all(v for k, v in res.items()
                    if k in ("centroids", "plane", "clusters", "kept_ok",
                             "normals"))
    return res


def mesh_refs(batches):
    """The unsharded pipelines on the card for each frame of the batches,
    at the tiled paths' configurations and the sharded paths'. The tiled
    aerial path's reference takes the plain voxel front end, as
    `tests/test_tiles_aerial.py`'s does: its rows, and so RANSAC's sample
    order, are canonical, as the tiled tail's `position_rows` make them
    (the fused front end emits sweep order and draws other hypotheses)."""
    import pointclouds_tpu_torch as pc

    refs = {}
    for i, s in enumerate(MESH_SEEDS):
        kx, kv = (torch.from_numpy(a[i]).cuda() for a in batches["kitti"])
        ax, av = (torch.from_numpy(a[i]).cuda() for a in batches["aerial"])
        kpos = (np.float32(0.15), np.float32(2.0), np.float32(0.15), s,
                np.float32(0.8))
        refs[("tiled kitti", i)] = pc.kitti_obstacle_pipeline(
            kx, kv, *kpos, **TILED_KITTI)
        refs[("sharded kitti", i)] = pc.kitti_obstacle_pipeline(
            kx, kv, *kpos, **SHARDED_KITTI)
        apos = (np.float32(0.5), np.float32(3.0), np.float32(0.3), s,
                np.float32(2.0), VIEWPOINT)
        refs[("tiled aerial", i)] = pc.aerial_pipeline(ax, av, *apos,
                                                       **TILED_AERIAL)
        refs[("sharded aerial", i)] = pc.aerial_pipeline(
            ax, av, *apos, backend="sweep", **SHARDED_AERIAL)
    return refs


def mesh_report(card_line, wname, points, res, refs, w1=None) -> tuple:
    """Log and check one world's paths: kernels launched, the tiled
    outputs against the unsharded pipeline by the tiled tests' rules (and,
    given ``w1``, against world 1's), the sharded outputs equal to the
    unsharded pipeline, the route, voxel and obstacle overflow flags clean,
    and the halo overflow flag too where the mesh's points axis is above 1
    (at one tile the port mirrors the reference's flag, which may be set
    spuriously there: no halo is exchanged). Returns (record, failures)."""
    record, failures = {}, []
    for path, r in res.items():
        kind = path.split()[1]
        missing = [k for k in MESH_PATHS[path] if r["launches"][k] <= 0]
        if missing:
            failures.append(f"{wname} {path}: {missing} never launched")
        out = r["out"]
        checks = []
        for i in range(len(MESH_SEEDS)):
            ref = refs[(path, i)]
            if path.startswith("sharded"):
                equal = all(np.array_equal(out[f][i],
                                           getattr(ref, f).cpu().numpy())
                            for f in ref._fields)
                checks.append(dict(equal_to_unsharded=equal, ok=equal))
                continue
            c = tiles_rules(kind, frame_view(kind, out, i),
                            frame_view(kind, ref))
            if w1 is not None:
                c["vs_world_1"] = tiles_rules(
                    kind, frame_view(kind, out, i),
                    frame_view(kind, w1[path]["out"], i))
                c["ok"] = c["ok"] and c["vs_world_1"]["ok"]
            checks.append(c)
        flags = out["flags"].tolist() if "flags" in out else None
        staged = {c: st["staged"] for c, st in r["comm"].items()
                  if st["staged"]}
        comm_ms = sum(st["ms"] for st in r["comm"].values())
        kept = out["cleaned_count"].tolist() if "cleaned_count" in out else None
        cert = (out["sor_certified"].tolist() if "sor_certified" in out
                else None)
        log(f"phase 11 {wname} {path}: batch of {len(MESH_SEEDS)} p50 "
            f"{r['p50_ms']:.3f} ms ({r['p50_ms'] / len(MESH_SEEDS):.3f} a "
            f"frame; {', '.join(f'{t:.3f}' for t in r['times_ms'])}); "
            f"collectives {comm_ms:.3f} ms in the first call ("
            + ", ".join(f"{c} {st['calls']}x {st['ms']:.3f}"
                        for c, st in r["comm"].items())
            + f"), host-staged {staged or 'none'}; flags (route, ds, halo, "
            f"obstacle) {flags}; cleaned_count {kept} sor_certified {cert}; "
            f"launches { {k: v for k, v in r['launches'].items() if v} }; "
            f"checks {checks} [{card_line}]")
        if not all(c["ok"] for c in checks):
            failures.append(f"{wname} {path}: {checks}")
        gated = [0, 1, 2, 3] if points > 1 else [0, 1, 3]
        if flags is not None and np.asarray(flags)[:, gated].any():
            failures.append(f"{wname} {path}: overflow flags {flags}")
        record[path] = dict(p50_ms=r["p50_ms"], times_ms=r["times_ms"],
                            launches=r["launches"], comm=r["comm"],
                            flags=flags, checks=checks, staged=staged,
                            cleaned_count=kept, sor_certified=cert)
    return record, failures


def phase11(card_line, add):
    """Multi-device on the one card: the tiled and sharded KITTI and aerial
    bench batches at world 1 (NCCL, mesh (1, 1), in this process) and
    world 2 (two spawned gloo ranks on the card, mesh (1, 2), the
    collectives staged through the host), each path's kernels launched,
    the tiled outputs held against the unsharded pipeline on the card by
    the tiled tests' rules and world 2 against world 1, the sharded ones
    equal to the unsharded pipeline, the overflow flags clean: the halo
    flag is left out only at world 1, a single tile, where the port mirrors
    the reference's spurious flag (phase11.json)."""
    import datetime

    import torch.distributed as dist

    from pointclouds_tpu_torch.parallel import launch, sharding

    t_start = time.perf_counter()
    batches = mesh_batches()
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{launch.free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=300))
    try:
        w1 = mesh_paths(sharding.mesh_of(1, 1), batches)
    finally:
        dist.destroy_process_group()
    refs = mesh_refs(batches)
    log(f"phase 11 world 1 and the unsharded runs: "
        f"{time.perf_counter() - t_start:.1f} s")
    record = dict(card=card_line)
    record["world 1"], failures = mesh_report(
        card_line, "world 1 nccl (1, 1)", 1, w1, refs)
    t2 = time.perf_counter()
    w2 = launch.run_ranks(phase11_rank, 2, batches, timeout=600.0,
                          threads=4)
    log(f"phase 11 world 2: {time.perf_counter() - t2:.1f} s")
    for path in MESH_PATHS:  # every rank returns the whole output
        for f, v in w2[0][path]["out"].items():
            if not np.array_equal(v, w2[1][path]["out"][f]):
                failures.append(f"world 2 {path}: ranks differ in {f}")
    record["world 2"], fails = mesh_report(
        card_line, "world 2 gloo (1, 2)", 2, w2[0], refs, w1)
    failures += fails
    for res in (w1, *w2):
        for r in res.values():
            add(r["launches"])
    log(f"phase 11 wall {time.perf_counter() - t_start:.1f} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "phase11.json").write_text(json.dumps(record, indent=1,
                                                     default=str))
    if failures:
        raise AssertionError("phase 11: " + "; ".join(failures))


# ── The last twins of the JAX package's public functions (phase 12) ──────

PHASE12_FACTOR = 3  # the KITTI sor cell: 3 voxels
PHASE12_K = KITTI["sor_k"]
RADIUS_R = 0.5
RADIUS_QUERIES = 8


def same_bits(a, b) -> bool:
    """Equal shapes, dtypes and bits (float32 compared as int32: -0.0 and
    NaN payloads count)."""
    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def frontend_rows(kdata, device):
    """`voxel_downsample_sweep_frontend` on the KITTI frame, then sort 3
    (`sweep_sort_compacted`) of its first ds_cap rows."""
    from pointclouds_tpu_torch.core.cloud import make_cloud_arrays
    from pointclouds_tpu_torch.ops import filters

    c = make_cloud_arrays(kdata, device=device)
    fe = filters.voxel_downsample_sweep_frontend(
        c.xyz, c.valid, np.float32(KITTI["voxel"]), factor=PHASE12_FACTOR)
    cap = KITTI["ds_cap"]
    rows = filters.sweep_sort_compacted(
        *(fe[k][:cap] for k in ("cxm", "cym", "czm", "canon", "out_valid")),
        fe["ext_v"], fe["extent"], factor=PHASE12_FACTOR)
    return c, fe, rows


def phase12_frontend(kdata, K, add, gates):
    """The two-sort front end (kernel 1) on the KITTI bench frame: equal
    to the CPU run key by key and to the fused front end's rows. Returns
    the sweep-order rows for the SOR pass."""
    from pointclouds_tpu_torch.ops import filters

    (c, fe, rows), launches = path_launches(
        K, "frontend", lambda: frontend_rows(kdata, "cuda"))
    add(launches)
    _, fe_cpu, rows_cpu = frontend_rows(kdata, "cpu")
    fused = filters.voxel_downsample_sweep_fused(
        c.xyz, c.valid, np.float32(KITTI["voxel"]), factor=PHASE12_FACTOR,
        ds_cap=KITTI["ds_cap"])
    nvox = int(fe["out_valid"].sum())
    cpu_equal = (all(same_bits(fe[k], fe_cpu[k]) for k in fe)
                 and all(same_bits(a, b) for a, b in zip(rows, rows_cpu)))
    fused_equal = all(same_bits(a, fused[k]) for a, k in zip(
        rows, ("centroids", "out_valid", "slin", "canon")))
    ms, _ = p50_ms(lambda: frontend_rows(kdata, "cuda"))
    gates["frontend"] = dict(voxels=nvox, cpu_equal=cpu_equal,
                             fused_equal=fused_equal, p50_ms=ms,
                             table_overflow=bool(fe["table_overflow"]),
                             ds_overflow=bool(fused["ds_overflow"]))
    log(f"phase 12 front end + sort 3 (KITTI frame, {nvox} voxels): bitwise "
        f"equal to the CPU run {cpu_equal}, to the fused front end's rows "
        f"{fused_equal}; p50 {ms:.3f} ms [{gates['card']}]")
    if not (cpu_equal and fused_equal) or nvox > KITTI["ds_cap"]:
        raise AssertionError("phase 12 front end differs or overflows")
    return rows


def phase12_sor(rows, K, add, gates):
    """`sweep_sor_mean_dists` (kernel 9) on the frame's centroids at k 20,
    at the KITTI pipeline's sor cell (3 voxels, 0.45 m; without the
    pipeline's per-query coverage, so fewer rows certify) and the default
    window budget: means bitwise equal to the CPU run wherever both
    certify."""
    from pointclouds_tpu_torch.spatial import sweep

    cen, val = rows[0], rows[1]
    cell = np.float32(KITTI["voxel"] * PHASE12_FACTOR)
    wr = 4
    call = lambda: sweep.sweep_sor_mean_dists(cen, val, cell, k=PHASE12_K,
                                              wr=wr)
    (mean, ok, cert), launches = path_launches(K, "sor_mean", call)
    add(launches)
    cmean, cok, ccert = sweep.sweep_sor_mean_dists(cen.cpu(), val.cpu(), cell,
                                                   k=PHASE12_K, wr=wr)
    mean, ok = mean.cpu(), ok.cpu()
    both = ok & cok
    equal = same_bits(mean[both], cmean[both])
    nval = int(val.sum())
    share = int(ok.sum()) / max(nval, 1)
    ms, _ = p50_ms(call)
    gates["sweep_sor_mean_dists"] = dict(
        rows=nval, cell=float(cell), wr=wr, certified_share=share,
        certified=bool(cert),
        cpu_certified=bool(ccert), ok_equal=torch.equal(ok, cok),
        means_bitwise=equal, p50_ms=ms)
    log(f"phase 12 sweep_sor_mean_dists k {PHASE12_K} cell {cell} wr {wr} on "
        f"{nval} centroids: certified share {share:.6f} (CPU "
        f"{int(cok.sum()) / max(nval, 1):.6f}), means bitwise equal where "
        f"both certify {equal}; p50 {ms:.3f} ms [{gates['card']}]")
    if not equal or int(both.sum()) == 0:
        raise AssertionError("phase 12 sweep_sor_mean_dists differs")


def masked_result(api, got):
    """The masked ICP 6-tuple as the API's IcpResult."""
    rot, trans, fit, rmse, conv, iters = (v.cpu() for v in got)
    return api.IcpResult(converged=bool(conv), fitness=float(fit),
                         rmse=float(rmse), num_iterations=int(iters),
                         translation=trans.tolist(), rotation=rot.tolist())


def phase12_icp(K, add, gates):
    """The masked ICP pair (kernel 15) on phase 7's 10K clouds, untrimmed:
    equal to the API's ICP on the card (iterations and convergence equal,
    rotation and translation within 1e-5, fitness and rmse within rtol
    1e-5)."""
    from pointclouds_tpu_torch import api
    from pointclouds_tpu_torch.ops import registration
    from pointclouds_tpu_torch.utils import profiling

    src, tgt = icp_clouds(api)
    tgt_n = api.estimate_normals(tgt, 10)
    s, t, tn = src._arrs, tgt._arrs, tgt_n._arrs
    scal = (50, np.float32(1e-5), np.float32(np.inf))
    calls = {
        "point_to_point": (
            lambda: registration.icp_point_to_point_masked(
                s.xyz, s.valid, t.xyz, t.valid, *scal),
            lambda: api.icp_point_to_point(src, tgt, max_iterations=50)),
        "point_to_plane": (
            lambda: registration.icp_point_to_plane_masked(
                s.xyz, s.valid, tn.xyz, tn.valid, tn.normals, *scal),
            lambda: api.icp_point_to_plane(src, tgt_n, max_iterations=50)),
    }
    for name, (masked, api_call) in calls.items():
        got, launches = path_launches(K, "icp", masked)
        add(launches)
        res, m = api_call(), masked_result(api, got)
        close = bool(icp_close(m, res)
                     and np.isclose(m.fitness, res.fitness, rtol=1e-5)
                     and np.isclose(m.rmse, res.rmse, rtol=1e-5, atol=1e-6))
        lo, p50 = profiling.time_fn(masked, reps=3)
        api_lo, api_p50 = profiling.time_fn(api_call, reps=3)
        gates[f"icp_{name}_masked"] = dict(
            masked=repr(m), translation=m.translation, api=repr(res),
            equal_to_api=close, rows=int(s.xyz.shape[0]),
            min_ms=lo, p50_ms=p50, api_min_ms=api_lo, api_p50_ms=api_p50)
        log(f"phase 12 icp_{name}_masked ({s.xyz.shape[0]} rows, untrimmed): "
            f"{m} translation {m.translation}; equal to the API's {res}: "
            f"{close}; "
            f"time_fn min/p50 {lo:.3f}/{p50:.3f} ms (API, trimmed: "
            f"{api_lo:.3f}/{api_p50:.3f} ms) [{gates['card']}]")
        if not (close and m.converged):
            raise AssertionError(f"phase 12 icp_{name}_masked differs")


def phase12_radius(gates):
    """`radius_within_mask` and `radius_indices` on phase 6's 100K cloud for
    a handful of queries against a float64 cKDTree query_ball_point; rows
    within 1e-6 of the radius are ties, counted and let differ."""
    from scipy.spatial import cKDTree

    from pointclouds_tpu_torch.core.cloud import make_cloud_arrays
    from pointclouds_tpu_torch.spatial import engine, knn

    pts = bench_cloud(100_000)
    c = make_cloud_arrays(pts, device="cuda")
    rng = np.random.default_rng(12)
    queries = np.vstack([pts[:RADIUS_QUERIES // 2],
                         rng.random((RADIUS_QUERIES - RADIUS_QUERIES // 2,
                                     3)) * 10]).astype(np.float32)
    tree = cKDTree(pts.astype(np.float64))
    p64 = pts.astype(np.float64)
    bad = ties = found = 0
    for q in queries:
        idx = engine.radius_indices(c.xyz, c.valid, q, RADIUS_R)
        mask = knn.radius_within_mask(
            c.xyz, c.valid, torch.from_numpy(q).cuda(),
            np.float32(RADIUS_R)).cpu().numpy()
        want = np.sort(tree.query_ball_point(q.astype(np.float64),
                                             RADIUS_R * (1 + 1e-6)))
        d = np.linalg.norm(p64[want] - q.astype(np.float64), axis=1)
        near = np.abs(d - RADIUS_R) <= 1e-6 * RADIUS_R
        ties += int(near.sum())
        sure = set(want[~near].tolist())
        got = set(idx.tolist())
        bad += len(sure - got) + len(got - set(want.tolist()))
        bad += int(not np.array_equal(np.nonzero(mask)[0], idx))
        found += len(idx)
    ms, _ = p50_ms(lambda: engine.radius_indices(c.xyz, c.valid, queries[0],
                                                 RADIUS_R))
    gates["radius"] = dict(queries=RADIUS_QUERIES, found=found,
                           differ=bad, ties=ties, p50_ms=ms)
    log(f"phase 12 radius_indices / radius_within_mask r {RADIUS_R} on 100K "
        f"points, {RADIUS_QUERIES} queries: {found} rows found, {bad} "
        f"differ from the cKDTree oracle ({ties} rows within 1e-6 of the "
        f"radius); p50 {ms:.3f} ms a query [{gates['card']}]")
    if bad:
        raise AssertionError("phase 12 radius search differs from the oracle")


def phase12_cell_graph(gates):
    """`cell_radius_neighbor_blocks` + `cell_propagate_labels` on the 100K
    slab at r 0.5 over the clustering rung's grid (cell r/2 less the f32
    margin, ring 2, the first M of engine.M_LADDER that holds): labels
    equal to `cell_graph_labels`' and clusters to the query_pairs +
    connected-components oracle."""
    from pointclouds_tpu_torch.core.cloud import make_cloud_arrays
    from pointclouds_tpu_torch.spatial import cellgrid, engine

    slab = slab_cloud()
    c = make_cloud_arrays(slab, device="cuda")
    r = np.float32(LARGE_R)
    ext = engine._extent(c.xyz, c.valid)
    cell = float(r) * 0.5 * (1.0 - 1e-5) - ext[2] * 3e-7
    cap = engine._cell_cap(c.xyz.shape[0])
    for m in engine.M_LADDER:
        grid = cellgrid.build_cellgrid(c.xyz, c.valid, cell, m_per_cell=m,
                                       cell_cap=cap, ring=2)
        if not bool(grid.overflow):
            break
    if bool(grid.overflow) or bool(grid.table_overflow):
        raise AssertionError("phase 12: the slab's cell grid overflows")

    def run():
        nb, within = cellgrid.cell_radius_neighbor_blocks(grid, r)
        return cellgrid.cell_propagate_labels(grid, nb, within)

    labels = run()
    torch.cuda.synchronize()
    ms, _ = p50_ms(run, reps=3)
    want = cellgrid.cell_graph_labels(
        grid, cellgrid.cell_graph_adjacency(grid, r))
    same = torch.equal(labels, want)
    got = canonical_clusters(labels[:len(slab)].cpu().numpy(), *CLUSTER_SIZES)
    oracle, near = oracle_clusters(slab, float(r))
    gates["cell_graph"] = dict(m_per_cell=m, cells=int(grid.num_cells),
                               cell_cap=cap, clusters=len(got),
                               equal_to_cell_graph_labels=same,
                               oracle_equal=got == oracle,
                               pairs_near_radius=near, p50_ms=ms)
    log(f"phase 12 cell_radius_neighbor_blocks + cell_propagate_labels "
        f"(slab 100K, r {r}, M {m}, {int(grid.num_cells)} cells): "
        f"{len(got)} clusters, labels equal to cell_graph_labels' {same}, "
        f"to the oracle {got == oracle} ({near} pairs within 1e-6 of the "
        f"radius); p50 {ms:.3f} ms [{gates['card']}]")
    if not same or (got != oracle and near == 0):
        raise AssertionError("phase 12 cell-graph labels differ")


def phase12_aabb(gates):
    """`aabb` on phase 6's 100K cloud with non-finite and invalid rows, and
    on an all-invalid cloud: equal to numpy's masked min and max."""
    from pointclouds_tpu_torch.core.cloud import aabb

    pts = bench_cloud(100_000)
    pts[::97] = np.nan
    valid = np.ones(len(pts), bool)
    valid[::13] = False
    use = valid & np.isfinite(pts).all(axis=1)
    x, v = torch.from_numpy(pts).cuda(), torch.from_numpy(valid).cuda()
    mn, mx, empty = (t.cpu().numpy() for t in aabb(x, v))
    ok = (np.array_equal(mn, pts[use].min(axis=0))
          and np.array_equal(mx, pts[use].max(axis=0)) and not empty)
    _, _, none = aabb(x, torch.zeros_like(v))
    ok = ok and bool(none)
    gates["aabb"] = dict(min=mn.tolist(), max=mx.tolist(), equal=ok)
    log(f"phase 12 aabb: min {mn.tolist()} max {mx.tolist()}, equal to "
        f"numpy's and empty when all invalid: {ok}")
    if not ok:
        raise AssertionError("phase 12 aabb differs")


def phase12(card_line, K, add, kdata):
    """The JAX package's last public functions on the card: the two-sort
    voxel front end (kernel 1), `sweep_sor_mean_dists` (kernel 9), the
    masked ICP pair (kernel 15), the single-query radius search, the
    cell-graph radius blocks with their propagation, `aabb`, and the
    timing helpers of `utils/profiling.py` (the launch floor)
    (phase12.json)."""
    from pointclouds_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    gates = dict(card=card_line)
    rows = phase12_frontend(kdata, K, add, gates)
    phase12_sor(rows, K, add, gates)
    phase12_icp(K, add, gates)
    phase12_radius(gates)
    phase12_cell_graph(gates)
    phase12_aabb(gates)
    floor = profiling.measure_dispatch_floor()
    floors = [profiling.measure_dispatch_floor(reps=50) for _ in range(3)]
    x = torch.ones(8, device="cuda")
    lo, p50 = profiling.time_fn(lambda: x + 1, reps=50, warmup=5)
    gates["launch_floor"] = dict(
        measure_dispatch_floor_ms=floor, floors_50_reps_ms=floors,
        time_fn_add_min_ms=lo, time_fn_add_p50_ms=p50)
    log(f"phase 12 launch floor (measure_dispatch_floor: a + 1 on 8 floats "
        f"and a synchronize, median of 10): {floor * 1e3:.2f} us; three more "
        f"medians of 50: {[round(f * 1e3, 2) for f in floors]} us; time_fn "
        f"min/p50 {lo * 1e3:.2f}/{p50 * 1e3:.2f} us [{card_line}]")
    gates["wall_s"] = time.perf_counter() - t0
    log(f"phase 12 wall {gates['wall_s']:.1f} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "phase12.json").write_text(json.dumps(gates, indent=1,
                                                     default=str))


# ── A/B: this checkout's kernels and frame against other checkouts' ──────

AB_INPUTS = ROOT / "build" / "chip_smoke_ab" / "inputs.pt"


def ab_capture(path: Path, only=None) -> None:
    """Capture the A/B inputs (``only``: just these labels) into ``path``."""
    import pointclouds_tpu_torch as pc
    from pointclouds_tpu_torch import api
    from pointclouds_tpu_torch.ops import fusedops
    from pointclouds_tpu_torch.pipelines.scenes import (
        aerial_scene,
        velodyne_scene,
    )

    kdata = velodyne_scene(seed=0, n_points=KITTI_POINTS)
    adata = aerial_scene(seed=42, scale=1.0)
    noisy = api.PointCloud.from_numpy(noisy_cloud(NOISY_BOX))
    overflow = api.PointCloud.from_numpy(noisy_cloud(OVERFLOW_BOX))
    u100k = api.PointCloud.from_numpy(bench_cloud(100_000))
    slab = api.PointCloud.from_numpy(slab_cloud())
    slab10k = api.PointCloud.from_numpy(slab_cloud(10_000))
    r32 = torch.tensor(np.float32(0.5), device="cuda")
    sets = {
        "kitti": lambda: capture_inputs(
            lambda: run_kitti(pc, kdata, 0, "cuda"), PATHS["kitti"]),
        "knn 100K": lambda: capture_inputs(
            lambda: api.knn(u100k, bench_cloud(100_000), 10),
            ["sweep_knn_select"]),
        "knn cross 100K": lambda: capture_inputs(
            lambda: api.knn(u100k, bench_cloud(100_000, seed=1), 10),
            ["sweep_knn_select"]),
        "slab cluster": lambda: capture_inputs(
            lambda: api.euclidean_cluster(slab, 0.5, *CLUSTER_SIZES),
            ["cluster_multisweep"]),
        "sor noisy 100K": lambda: capture_inputs(
            lambda: api.statistical_outlier_removal(noisy, 10, 2.0),
            PATHS["sor"]),
        "aerial": lambda: capture_inputs(
            lambda: run_aerial(pc, adata, 0, "cuda"),
            ["sweep_moments", "cluster_multisweep_windows"]),
        "1.2M first hop": lambda: capture_inputs(
            lambda: api.euclidean_cluster(large_cloud(api), LARGE_R,
                                          *CLUSTER_SIZES),
            ["cluster_propagate"]),
        "aerial rescue": lambda: capture_inputs(
            lambda: run_aerial(pc, adata, 0, "cuda", ransac_subsample=None,
                               normals_rescue=True), ["rescue_knn_idx"]),
        "normals 100K": lambda: capture_inputs(
            lambda: api.estimate_normals(u100k, 10), NORMALS_KERNELS),
        **{f"kitti xla {fn}": (lambda fn=fn: seg_capture(pc, kdata, fn))
           for fn in SEG_CALLERS},
        **{label: (lambda c=c: capture_inputs(
            lambda: api.statistical_outlier_removal(c, 10, 2.0),
            ["brute_knn_idx"]))
           for label, c in brute_captures(overflow, u100k)},
        "kitti pallas": lambda: capture_inputs(
            lambda: run_kitti(pc, kdata, 0, "cuda", sor_backend="pallas"),
            ["sor_select"]),
        "voxel 1M": lambda: capture_inputs(
            lambda: api.voxel_downsample(
                api.PointCloud.from_numpy(bench_cloud(1_000_000)), 0.5),
            ["segmented_scan_sums"]),
        # Kernel 9 at the SOR engine's fallback; kernel 14 with every query
        # block live (the fused ROR op on a one-row window budget) and at
        # the real noisy ROR op's call, which has no live block.
        "sor overflow 100K": lambda: capture_inputs(
            lambda: api.statistical_outlier_removal(overflow, 10, 2.0),
            ["sweep_select"]),
        "ror full": lambda: capture_inputs(
            lambda: fusedops.ror_fused(noisy._arrs, r32, 5, wr=1, cap=4096),
            ["brute_radius_count"]),
        "ror noisy 100K": lambda: capture_inputs(
            lambda: api.radius_outlier_removal(noisy, 0.5, 5),
            ["brute_radius_count"]),
        # Kernel 15 at the ICP op's call and on the half-shift lattice
        # (tied nearest candidates); kernel 11 at the noisy ROR op's.
        "icp 10K": lambda: capture_inputs(
            lambda: api.icp_point_to_point(*icp_clouds(api),
                                           max_iterations=50),
            ["nn_argmin"]),
        "nn lattice": lambda: {"nn_argmin": nn_lattice()},
        "ror count 100K": lambda: capture_inputs(
            lambda: api.radius_outlier_removal(noisy, 0.5, 5),
            ["count_within"]),
        # Kernel 12 at the fused ROR op with a one-row window budget (32
        # live blocks) and at the noisy ROR op's own call (2 live);
        # kernel 5 at the KITTI frame's full scoring and the RANSAC op at
        # 10K.
        "ror rescue": lambda: capture_inputs(
            lambda: fusedops.ror_fused(noisy._arrs, r32, 5, wr=1, cap=4096),
            ["rescue_radius_count_groups"]),
        "ror rescue noisy 100K": lambda: capture_inputs(
            lambda: api.radius_outlier_removal(noisy, 0.5, 5),
            ["rescue_radius_count_groups"]),
        "ransac kitti full": lambda: capture_inputs(
            lambda: run_kitti(pc, kdata, 0, "cuda", ransac_subsample=None),
            ["ransac_score_counts"]),
        "ransac op 10K": lambda: capture_inputs(
            lambda: ransac_op(api, slab10k), ["ransac_score_counts"]),
    }
    unknown = set(only or ()) - set(sets)
    if unknown:
        raise ValueError(f"no A/B capture named {sorted(unknown)}")
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({label: run() for label, run in sets.items()
                if only is None or label in only}, path)


def ab_child(tree: Path, inputs: Path, kernels_only=False) -> dict:
    """One checkout's numbers, in a process whose package is ``tree``'s
    (``kernels_only``: the kernels at the captured inputs, no frames or
    ops)."""
    sys.path.insert(0, str(tree))
    import pointclouds_tpu_torch as pc
    from pointclouds_tpu_torch import api
    from pointclouds_tpu_torch.pipelines.scenes import (
        aerial_scene,
        velodyne_scene,
    )
    from pointclouds_tpu_torch.spatial import _build
    from pointclouds_tpu_torch.spatial import kernels as K

    if not Path(K.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"{K.__file__} is not from {tree}")
    card_line = card()
    lib = _build.library()
    res = dict(tree=str(tree), build_s=lib.build_seconds, ptxas=[
        line.strip() for line in lib.log.splitlines()
        if any(w in line for w in ("entry function", "registers", "spill"))],
        kernels={})
    res["device_ms"] = {}
    res["device_launches"] = {}
    res["resources"] = {}
    res["rounds"] = {}
    for label, captured in torch.load(inputs, weights_only=False).items():
        for name, (args, kwargs) in captured.items():
            key = f"{name} {label}"
            res["kernels"][key] = check_kernel(name, args, kwargs, K)[2]
            call = lambda: getattr(K, name)(*args, **kwargs)  # noqa: E731
            n = res["device_launches"][key] = len(device_kernels(call))
            res["device_ms"][key] = device_ms(call, 5, n) if n else None
            res["resources"][key] = kernel_resources(call)
            if name.startswith("cluster_multisweep"):
                res["rounds"][key] = (f"{call()[2]} rounds; "
                                      f"{select_work(name, args, kwargs)}")
    if kernels_only:
        return res
    kdata = velodyne_scene(seed=0, n_points=KITTI_POINTS)
    kcloud = pc.make_cloud_arrays(kdata, device="cuda")
    run_kitti(pc, kdata, 0, cloud=kcloud)
    res["stages"], res["frame_p50_ms"] = timed_frames(
        lambda f: run_kitti(pc, kdata, f, cloud=kcloud), KITTI_FRAMES,
        card_line, "kitti")
    res["kitti_device_ms"] = device_ms(
        lambda: run_kitti(pc, kdata, 0, cloud=kcloud), 3)
    noisy = api.PointCloud.from_numpy(noisy_cloud(NOISY_BOX))
    res["sor_op_p50_ms"] = p50_ms(
        lambda: api.statistical_outlier_removal(noisy, 10, 2.0))[0]
    overflow = api.PointCloud.from_numpy(noisy_cloud(OVERFLOW_BOX))
    sor_over = lambda: api.statistical_outlier_removal(  # noqa: E731
        overflow, 10, 2.0)
    res["sor_overflow_op_p50_ms"] = p50_ms(sor_over)[0]
    res["sor_overflow_device_ms"] = device_ms(sor_over, 3)
    res["sor_overflow_device_launches"] = len(device_kernels(sor_over))
    ror = lambda: api.radius_outlier_removal(noisy, 0.5, 5)  # noqa: E731
    res["ror_op_p50_ms"] = p50_ms(ror)[0]
    res["ror_device_ms"] = device_ms(ror, 5)
    res["ror_device_launches"] = len(device_kernels(ror))
    slab10k = api.PointCloud.from_numpy(slab_cloud(10_000))
    ransac = lambda: ransac_op(api, slab10k)  # noqa: E731
    res["ransac_op_p50_ms"] = p50_ms(ransac)[0]
    res["ransac_device_ms"] = device_ms(ransac, 5)
    res["ransac_device_launches"] = len(device_kernels(ransac))
    icp_src, icp_tgt = icp_clouds(api)
    icp = lambda: api.icp_point_to_point(  # noqa: E731
        icp_src, icp_tgt, max_iterations=50)
    res["icp_op_p50_ms"] = p50_ms(icp)[0]
    res["icp_device_ms"] = device_ms(icp, 5)
    res["icp_device_launches"] = len(device_kernels(icp))
    run_kitti(pc, kdata, 0, cloud=kcloud, sor_backend="xla")
    res["xla_stages"], res["xla_p50_ms"] = timed_frames(
        lambda f: run_kitti(pc, kdata, f % len(SEEDS), cloud=kcloud,
                            sor_backend="xla"), len(SEEDS), card_line,
        "kitti xla")
    pallas = lambda f: run_kitti(pc, kdata, f % len(SEEDS),  # noqa: E731
                                 cloud=kcloud, sor_backend="pallas")
    pallas(0)
    res["pallas_stages"], res["pallas_p50_ms"] = timed_frames(
        pallas, len(SEEDS), card_line, "kitti pallas")
    res["pallas_device_ms"] = device_ms(lambda: pallas(0), 3)
    u1m = api.PointCloud.from_numpy(bench_cloud(1_000_000))
    vox = lambda: api.voxel_downsample(u1m, 0.5)  # noqa: E731
    res["voxel_1m_p50_ms"] = p50_ms(vox)[0]
    res["voxel_1m_device_ms"] = device_ms(vox, 5)
    adata = aerial_scene(seed=42, scale=1.0)
    acloud = pc.make_cloud_arrays(adata, device="cuda")
    run_aerial(pc, adata, 0, cloud=acloud)
    res["aerial_stages"], res["aerial_p50_ms"] = timed_frames(
        lambda f: run_aerial(pc, adata, f, cloud=acloud), AERIAL_FRAMES,
        card_line, "aerial")
    res["aerial_device_ms"] = device_ms(
        lambda: run_aerial(pc, adata, 0, cloud=acloud), 3)
    u100k = bench_cloud(100_000)
    cloud = api.PointCloud.from_numpy(u100k)
    res["normals_op_p50_ms"] = p50_ms(
        lambda: api.estimate_normals(cloud, 10))[0]
    q100k = bench_cloud(100_000, seed=1)
    res["knn_op_p50_ms"] = p50_ms(lambda: api.knn(cloud, u100k, 10))[0]
    res["knn_cross_op_p50_ms"] = p50_ms(lambda: api.knn(cloud, q100k, 10))[0]
    res["knn_device_ms"] = device_ms(lambda: api.knn(cloud, u100k, 10), 3)
    res["knn_cross_device_ms"] = device_ms(
        lambda: api.knn(cloud, q100k, 10), 3)
    large = large_cloud(api)
    call = lambda: api.euclidean_cluster(large, LARGE_R,  # noqa: E731
                                         *CLUSTER_SIZES)
    res["cluster_large_p50_ms"] = p50_ms(call)[0]
    res["cluster_large_device_ms"] = device_ms(call, 3)
    return res


def ab_frames_text(r) -> str:
    """The frame and op numbers of one A/B child's run, for the log."""
    return (
        f"stages (KITTI): sor {ms_text(r['stages'].get('sor'), 3)} ms, "
        f"cluster {ms_text(r['stages'].get('cluster'), 3)} ms, "
        f"KITTI frame p50 {r['frame_p50_ms']:.3f} ms (device "
        f"{ms_text(r.get('kitti_device_ms'), 3)}), SOR noisy 100K op "
        f"p50 {r['sor_op_p50_ms']:.3f} ms, SOR overflow op p50 "
        f"{r['sor_overflow_op_p50_ms']:.3f} ms (device "
        f"{ms_text(r['sor_overflow_device_ms'], 3)}, "
        f"{r['sor_overflow_device_launches']} device launches), ROR noisy "
        f"100K op p50 {r['ror_op_p50_ms']:.3f} ms (device "
        f"{ms_text(r['ror_device_ms'], 3)}, {r['ror_device_launches']} "
        f"device launches), RANSAC 10K op p50 {r['ransac_op_p50_ms']:.3f} "
        f"ms (device {ms_text(r['ransac_device_ms'], 3)}, "
        f"{r['ransac_device_launches']} device launches), ICP "
        f"point-to-point 10K op p50 "
        f"{r['icp_op_p50_ms']:.3f} ms (device "
        f"{ms_text(r['icp_device_ms'], 3)}, {r['icp_device_launches']} "
        f"device launches), sor (xla) "
        f"{ms_text(r['xla_stages'].get('sor'), 3)} ms, "
        f"KITTI xla frame p50 {r['xla_p50_ms']:.3f} ms, sor (pallas) "
        f"{ms_text(r['pallas_stages'].get('sor'), 3)} ms, KITTI "
        f"pallas frame p50 {r['pallas_p50_ms']:.3f} ms (device "
        f"{ms_text(r['pallas_device_ms'], 3)}), voxel 1M op p50 "
        f"{r['voxel_1m_p50_ms']:.3f} ms (device "
        f"{ms_text(r['voxel_1m_device_ms'], 3)}), frontend (KITTI) "
        f"{ms_text(r['stages'].get('frontend'), 3)} ms, normals (aerial) "
        f"{ms_text(r['aerial_stages'].get('normals'), 3)} ms, cluster "
        f"(aerial) {ms_text(r['aerial_stages'].get('cluster'), 3)} ms, "
        f"aerial frame p50 {r['aerial_p50_ms']:.3f} ms (device "
        f"{ms_text(r['aerial_device_ms'], 3)}), normals 100K op "
        f"p50 {r['normals_op_p50_ms']:.3f} ms, knn 100K op p50 "
        f"{r['knn_op_p50_ms']:.3f} ms (device "
        f"{ms_text(r.get('knn_device_ms'), 3)}), knn cross 100K op p50 "
        f"{r['knn_cross_op_p50_ms']:.3f} ms (device "
        f"{ms_text(r.get('knn_cross_device_ms'), 3)}), "
        f"euclidean_cluster 1.2M p50 "
        f"{r['cluster_large_p50_ms']:.3f} ms (device "
        f"{ms_text(r['cluster_large_device_ms'], 3)}); ")


def ab_main(others, only=None) -> int:
    """Run the trees in turns on this card; ``only``: just these captures'
    kernels, no frames or ops."""
    card_line = card()
    ab_capture(AB_INPUTS, only)
    others = [d.resolve() for d in others]
    runs = []
    for tree in [*others, ROOT, ROOT, *reversed(others)]:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--ab-child",
             str(tree), str(AB_INPUTS), *(["--kernels-only"] if only else [])],
            capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"A/B run of {tree} failed")
        r = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(r)
        log(f"ab {tree}: build {r['build_s']:.1f} s; " + ", ".join(
            f"{k} {v:.4f}" for k, v in r["kernels"].items()) + " ms; "
            + ("" if only else ab_frames_text(r)) + "device ms a call "
            + ", ".join(f"{k} {ms_text(v)}" for k, v in r["device_ms"].items())
            + "; device launches a call " + ", ".join(
                f"{k} {v}" for k, v in r["device_launches"].items()
                if k.startswith(("segmented_scan", "sweep_knn",
                                 "cluster_multisweep ", "sweep_select ",
                                 "brute_radius_count", "nn_argmin",
                                 "count_within", "rescue_radius_count",
                                 "ransac_score_counts")))
            + "".join(f"; {k}: {v}" for k, v in r["rounds"].items()) +
            f" [{card_line}]")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "ab.json").write_text(json.dumps(
        dict(card=card_line, runs=runs), indent=1))
    log(card_line)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke test of the port on "
                                 "one NVIDIA GPU.")
    ap.add_argument("--ab", nargs="+", type=Path, metavar="DIR",
                    help="compare with these unpacked checkouts instead")
    ap.add_argument("--captures", nargs="+", metavar="LABEL",
                    help="with --ab: only these captures' kernels, no "
                    "frames or ops")
    ap.add_argument("--ab-child", nargs=2, type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--kernels-only", action="store_true",
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if a.ab_child:
        print(json.dumps(ab_child(*a.ab_child, a.kernels_only)))
        return 0
    if a.ab:
        return ab_main(a.ab, a.captures)
    t_start = time.perf_counter()
    import pointclouds_tpu_torch as pc
    from pointclouds_tpu_torch.pipelines import aerial as aerial_mod
    from pointclouds_tpu_torch.pipelines.scenes import (
        aerial_scene,
        velodyne_scene,
    )
    from pointclouds_tpu_torch.spatial import _build
    from pointclouds_tpu_torch.spatial import kernels as K
    from pointclouds_tpu_torch.spatial import sweep as sweep_mod

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

    kdata = velodyne_scene(seed=0, n_points=KITTI_POINTS)
    adata = aerial_scene(seed=42, scale=1.0)
    from pointclouds_tpu_torch import api
    from pointclouds_tpu_torch.ops import fusedops

    noisy = api.PointCloud.from_numpy(noisy_cloud(NOISY_BOX))
    overflow = api.PointCloud.from_numpy(noisy_cloud(OVERFLOW_BOX))
    r32 = torch.tensor(np.float32(0.5), device="cuda")
    u100k = bench_cloud(100_000)
    knn_cloud = api.PointCloud.from_numpy(u100k)
    icp_src, icp_tgt = icp_clouds(api)

    # ── Phase 2: each kernel against its plain version, pipeline shapes ──
    captured = {}
    for run, names in (
            (lambda: run_kitti(pc, kdata, 0, "cuda"), PATHS["kitti"]),
            (lambda: run_aerial(pc, adata, 0, "cuda"),
             ["sweep_moments", "cluster_multisweep_windows"]),
            (lambda: run_kitti(pc, kdata, 0, "cuda", ransac_subsample=None),
             ["ransac_score_counts"]),
            (lambda: run_aerial(pc, adata, 0, "cuda", ransac_subsample=None,
                                normals_rescue=True), ["rescue_knn_idx"]),
            # The per-op API, on the noisy cloud (phase 6's shapes).
            (lambda: api.statistical_outlier_removal(overflow, 10, 2.0),
             ["sweep_select"]),
            (lambda: api.statistical_outlier_removal(noisy, 10, 2.0),
             ["brute_knn_idx"]),
            (lambda: api.radius_outlier_removal(noisy, 0.5, 5),
             ["count_within"]),
            # ROR's rescues see real queries only where windows overflow:
            # its fused op with a one-row window budget fills both.
            (lambda: fusedops.ror_fused(noisy._arrs, r32, 5, wr=1,
                                        cap=4096),
             ["rescue_radius_count_groups", "brute_radius_count"]),
            # The kNN and ICP ops (phase 7's shapes): the same-cloud kNN of
            # the 100K cloud (`sweep_knn_two_pass`), ICP at 10K points.
            (lambda: api.knn(knn_cloud, u100k, 10), ["sweep_knn_select"]),
            (lambda: api.icp_point_to_point(icp_src, icp_tgt,
                                            max_iterations=50),
             ["nn_argmin"])):
        captured.update(capture_inputs(run, names))
    rows = [kernel_row(name, *captured[name], K, card_line)
            for name in KERNELS if name not in PHASE8_KERNELS]
    # Kernels 6 and 7 at the normals op's inputs too (phase 6's 100K
    # cloud), beside the aerial frames' captures above.
    normals = capture_inputs(lambda: api.estimate_normals(knn_cloud, 10),
                             NORMALS_KERNELS)
    # Kernel 13 also at the overflow SOR op (its most live queries) and at
    # the clean 100K SOR op (no live block), beside the noisy op above.
    brute = {label: capture_inputs(
        lambda c=c: api.statistical_outlier_removal(c, 10, 2.0),
        ["brute_knn_idx"])["brute_knn_idx"]
        for label, c in brute_captures(overflow, knn_cloud)}
    brute_rows = []
    for label, (args, kwargs) in brute.items():
        row = kernel_row("brute_knn_idx", args, kwargs, K, card_line,
                         label=label)
        row["device_ms"] = device_ms(lambda: K.brute_knn_idx(*args, **kwargs))
        log(f"kernel brute_knn_idx ({label}): device {ms_text(row['device_ms'])} "
            f"ms a call (torch.profiler) [{card_line}]")
        brute_rows.append(row)
    # Kernel 14 also at the noisy ROR op's own call, which has no live
    # query block (the full capture above has 32): one launch of CTAs
    # that exit at once.
    args, kwargs = capture_inputs(
        lambda: api.radius_outlier_removal(noisy, 0.5, 5),
        ["brute_radius_count"])["brute_radius_count"]
    ror_empty = kernel_row("brute_radius_count", args, kwargs, K, card_line,
                           label="ror noisy 100K")
    ror_empty.update(kernel_device("brute_radius_count", args, kwargs, K,
                                   card_line, "ror noisy 100K"))
    # Kernels 1 (KITTI), 11 (the noisy ROR op) and 15 (ICP 10K, and the
    # half-shift lattice of phase 7): their device time and device
    # launches a call.
    for name, label in (("segmented_scan_sums", "kitti"),
                        ("count_within", "ror count 100K"),
                        ("nn_argmin", "icp 10K"),
                        ("rescue_radius_count_groups", "ror rescue"),
                        ("ransac_score_counts", "ransac kitti full")):
        next(r for r in rows if r["name"] == name).update(
            kernel_device(name, *captured[name], K, card_line, label))
    nn_lattice_device = kernel_device("nn_argmin", *nn_lattice(), K,
                                      card_line, NN_LATTICE)
    # Kernel 12 also at the noisy ROR op's own call (2 live blocks), and
    # kernel 5 at the RANSAC op on the 10K slab (128 rows).
    slab10k = api.PointCloud.from_numpy(slab_cloud(10_000))
    extra = {}
    for name, label, run in (
            ("rescue_radius_count_groups", "ror rescue noisy 100K",
             lambda: api.radius_outlier_removal(noisy, 0.5, 5)),
            ("ransac_score_counts", "ransac op 10K",
             lambda: ransac_op(api, slab10k))):
        args, kwargs = capture_inputs(run, [name])[name]
        extra[f"{name} {label}"] = dict(
            kernel_row(name, args, kwargs, K, card_line, label=label),
            **kernel_device(name, args, kwargs, K, card_line, label))
    # Kernel 1 also at the 1M voxel op (16 tiles), beside the KITTI frame
    # (2 tiles).
    u1m = api.PointCloud.from_numpy(bench_cloud(1_000_000))
    args, kwargs = capture_inputs(lambda: api.voxel_downsample(u1m, 0.5),
                                  ["segmented_scan_sums"])[
        "segmented_scan_sums"]
    scan_1m = dict(kernel_row("segmented_scan_sums", args, kwargs, K,
                              card_line, label="voxel 1M"),
                   **kernel_device("segmented_scan_sums", args, kwargs, K,
                                   card_line, "voxel 1M"))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "phase2.json").write_text(json.dumps(dict(
        card=card_line, kernels=rows, normals_100k=[
            dict(kernel_row(name, *normals[name], K, card_line,
                            label="normals 100K"),
                 work=select_work(name, *normals[name]))
            for name in NORMALS_KERNELS], brute_knn_idx=brute_rows,
        brute_radius_count_empty=ror_empty,
        segmented_scan_sums_1m=scan_1m,
        nn_argmin_lattice=nn_lattice_device, **extra), indent=1))
    launches_total = {name: 0 for name in KERNELS}

    def add(launches):
        for name, v in launches.items():
            launches_total[name] += v

    # ── Phase 3: KITTI end to end ──
    outs, launches = path_launches(K, "kitti", lambda: {
        seed: run_kitti(pc, kdata, seed, "cuda") for seed in SEEDS})
    add(launches)
    for seed, out in outs.items():
        flags = out.grid_flags.cpu().numpy()
        gpu_sets = kitti_points(pc, out)
        cpu_out = run_kitti(pc, kdata, seed, "cpu")
        cpu_sets = kitti_points(pc, cpu_out)
        log(f"kitti seed {seed}: ds={int(out.downsampled_valid.sum())} "
            f"kept={int(out.cleaned_valid.sum())} "
            f"inliers={int(out.inlier_mask.sum())} "
            f"clusters={[len(c) for c in gpu_sets]} "
            f"cpu_clusters={[len(c) for c in cpu_sets]} "
            f"sor_certified={bool(out.sor_certified)} "
            f"grid_flags={flags.tolist()} "
            f"obstacle_overflow={bool(out.obstacle_overflow)}")
        if flags.any() or bool(out.obstacle_overflow):
            raise AssertionError(f"kitti seed {seed}: overflow flags set")
        if not bool(out.sor_certified):
            raise AssertionError(f"kitti seed {seed}: SOR not certified")
        if len(gpu_sets) < 3:
            raise AssertionError(f"kitti seed {seed}: fewer than 3 clusters")
        if not torch.equal(out.centroids.cpu(), cpu_out.centroids):
            raise AssertionError(f"kitti seed {seed}: centroids differ")
        if not same_clusters(gpu_sets, cpu_sets):
            raise AssertionError(f"kitti seed {seed}: clusters differ")
    kcloud = pc.make_cloud_arrays(kdata, device="cuda")
    timed_frames(lambda f: run_kitti(pc, kdata, f, cloud=kcloud),
                 KITTI_FRAMES, card_line, "kitti")

    # ── Phase 4: aerial end to end ──
    rounds = []

    def count_rounds(name, orig, a, k):
        r = orig(*a, **k)
        rounds.append(r[2])
        return r

    with Spy([(sweep_mod, "cluster_multisweep_windows")], count_rounds):
        aouts, launches = path_launches(K, "aerial", lambda: {
            seed: run_aerial(pc, adata, seed, "cuda") for seed in SEEDS})
    add(launches)
    log(f"aerial cluster rounds per burst, seeds {list(SEEDS)}: {rounds} "
        f"(bursts of at most {AERIAL['cluster_sweeps']})")
    for seed, out in aouts.items():
        nok = normals_ok_share(out)
        nz = abs(float(out.plane_normal[2]))
        sizes = [len(c) for c in aerial_points(aerial_mod, out)]
        log(f"aerial seed {seed}: ds={int(out.downsampled_valid.sum())} "
            f"obstacles={int(out.obstacle_valid.sum())} "
            f"normals_ok={nok:.4f} plane_nz={nz:.6f} "
            f"clusters={len(sizes)} largest={sizes[:8]} "
            f"cluster_exact={bool(out.cluster_exact)} "
            f"ds_overflow={bool(out.ds_overflow)} "
            f"obstacle_overflow={bool(out.obstacle_overflow)}")
        if bool(out.ds_overflow) or bool(out.obstacle_overflow):
            raise AssertionError(f"aerial seed {seed}: overflow")
        if not bool(out.cluster_exact):
            raise AssertionError(f"aerial seed {seed}: clusters not exact")
        if nok < NORMALS_OK_MIN:
            raise AssertionError(f"aerial seed {seed}: normals_ok {nok}")
        if nz <= 0.95:
            raise AssertionError(f"aerial seed {seed}: plane normal z {nz}")
    a_gpu = aouts[0]
    a_cpu = run_aerial(pc, adata, 0, "cpu")
    gpu_sets = aerial_points(aerial_mod, a_gpu)
    cpu_sets = aerial_points(aerial_mod, a_cpu)
    log(f"aerial seed 0 vs CPU: clusters {len(gpu_sets)} / {len(cpu_sets)}")
    if not torch.equal(a_gpu.centroids.cpu(), a_cpu.centroids):
        raise AssertionError("aerial seed 0: centroids differ from CPU")
    if not same_clusters(gpu_sets, cpu_sets):
        raise AssertionError("aerial seed 0: clusters differ from CPU")
    acloud = pc.make_cloud_arrays(adata, device="cuda")
    timed_frames(lambda f: run_aerial(pc, adata, f, cloud=acloud),
                 AERIAL_FRAMES, card_line, "aerial")

    # ── Phase 5: the pipelines' default kwargs ──
    kd, launches = path_launches(K, "kitti_default", lambda: run_kitti(
        pc, kdata, 0, "cuda", ransac_subsample=None))
    add(launches)
    kd_cpu = run_kitti(pc, kdata, 0, "cpu", ransac_subsample=None)
    kd_sets, kd_cpu_sets = kitti_points(pc, kd), kitti_points(pc, kd_cpu)
    log(f"kitti default kwargs: inliers={int(kd.inlier_mask.sum())} "
        f"cpu_inliers={int(kd_cpu.inlier_mask.sum())} "
        f"clusters={[len(c) for c in kd_sets]} "
        f"plane={kd.plane_normal.cpu().tolist()}")
    if not torch.allclose(kd.plane_normal.cpu(), kd_cpu.plane_normal,
                          atol=1e-6):
        raise AssertionError("kitti default: plane differs from CPU")
    if len(kd_sets) < 3 or not same_clusters(kd_sets, kd_cpu_sets):
        raise AssertionError("kitti default: clusters differ from CPU")

    over = dict(ransac_subsample=None, normals_rescue=True)
    ad, launches = path_launches(K, "aerial_default", lambda: run_aerial(
        pc, adata, 0, "cuda", **over))
    add(launches)
    ad_cpu = run_aerial(pc, adata, 0, "cpu", **over)
    nok_rescue, nok_bench = normals_ok_share(ad), normals_ok_share(a_gpu)
    ad_sets = aerial_points(aerial_mod, ad)
    ad_cpu_sets = aerial_points(aerial_mod, ad_cpu)
    log(f"aerial default kwargs + rescue: normals_ok={nok_rescue:.4f} "
        f"(bench run {nok_bench:.4f}, CPU run "
        f"{normals_ok_share(ad_cpu):.4f}) "
        f"plane={ad.plane_normal.cpu().tolist()} clusters={len(ad_sets)} "
        f"cluster_exact={bool(ad.cluster_exact)}")
    if nok_rescue <= nok_bench:
        raise AssertionError("aerial rescue did not raise normals_ok")
    if not torch.equal(ad.normals_ok.cpu(), ad_cpu.normals_ok):
        raise AssertionError("aerial default: normals_ok differs from CPU")
    if not torch.allclose(ad.plane_normal.cpu(), ad_cpu.plane_normal,
                          atol=1e-6):
        raise AssertionError("aerial default: plane differs from CPU")
    if not bool(ad.cluster_exact) or not same_clusters(ad_sets, ad_cpu_sets):
        raise AssertionError("aerial default: clusters differ from CPU")

    # ── Phase 6: the per-op API ──
    phase6(card_line, K, add)

    # ── Phase 7: kNN, clustering, ICP and I/O ──
    phase7(card_line, K, add)

    # ── Phase 8: the cell-grid KITTI backends, the large-cloud hop loop ──
    rows += phase8(card_line, K, pc, kdata, add)

    # ── Phase 9: the int64-keyed grid at 2^24 points, the host C++ ──
    phase9(card_line, K, add)

    # ── Phase 10: the cell-grid kNN rungs and engine.radius_count ──
    phase10(card_line)

    # ── Phase 11: multi-device on the one card ──
    phase11(card_line, add)

    # ── Phase 12: the last twins of the JAX package's public functions ──
    phase12(card_line, K, add, kdata)

    for r in rows:
        r["launches"] = launches_total[r["name"]]
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} never launched")
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(card_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
