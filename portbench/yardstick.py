"""The yardstick of the kernels: the least time the card could take for a
kernel call's work, against the published peaks of one NVIDIA H100 SXM.

Frozen copy of `chip_smoke.py`'s `work()` and `bound_ms()`: bytes are every
input read once and every output written once, operations are the pairs
this call's data makes the kernel evaluate, `PAIR_OPS` each. One change:
the two labelling kernels count one pass over their pairs, not the plain
version's rounds, so the bound reads no code of the program and does not
move with how many rounds a design takes. `work()` takes a kernel
wrapper's name, its positional and keyword arguments and its result, as
`pointclouds_tpu_torch.spatial.kernels` defines them.
"""

from __future__ import annotations

import torch

# The module that defines the kernel wrappers `work` knows.
KERNEL_MODULE = "pointclouds_tpu_torch.spatial.kernels"
KERNELS = ("segmented_scan_sums", "sweep_select_rows", "rescue_select",
           "cluster_multisweep", "ransac_score_counts", "sweep_moments",
           "rescue_knn_idx", "cluster_multisweep_windows", "sweep_select",
           "count_within", "rescue_radius_count_groups", "brute_knn_idx",
           "brute_radius_count", "sweep_knn_select", "nn_argmin",
           "cluster_propagate", "sor_select", "segmented_select")
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
        # One pass over the listed pairs: the least any exact labelling
        # must evaluate, whatever number of rounds a design takes.
        rl, cap = args[1], kwargs["cap"]
        rows = (rl[:, cap + 1].clamp(max=cap) * (rl[:, cap] != 0)).sum()
        return nbytes, PAIR_OPS * pair * int(rows)
    if name == "cluster_multisweep_windows":
        return nbytes, PAIR_OPS * pair * _window_rows(args[1])
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
