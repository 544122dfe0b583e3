"""The port's segmented scan (plain version of the CUDA kernel) and the
fused voxel front end, bitwise against the JAX package: the Pallas kernel
in interpret mode and its XLA mirror."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.ops.filters import (
    voxel_downsample_sweep_fused as jax_voxel_fused,
)
from pointclouds_tpu.spatial.pallas_kernels import (
    segmented_scan_sums as jax_segscan,
    segmented_scan_sums_xla as jax_segscan_xla,
)
from pointclouds_tpu_torch.ops.filters import voxel_downsample_sweep_fused
from pointclouds_tpu_torch.spatial import kernels
from pointclouds_tpu_torch.spatial.kernels import segmented_scan_sums


def _segments(n, seed):
    rng = np.random.default_rng(seed)
    first = (rng.random(n) < 0.3).astype(np.float32)
    first[0] = 1.0
    x, y, z = (rng.normal(size=n).astype(np.float32) * 20 for _ in range(3))
    # -0.0 values: x + 0.0 turns them into +0.0, which the tree must keep.
    x[rng.random(n) < 0.05] = -0.0
    c = (rng.random(n) < 0.9).astype(np.float32)
    return first, x, y, z, c


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("n", [128, 640, 2 * 512 * 128 + 384])
def test_segscan_plain_bitwise_vs_pallas_and_mirror(n):
    args = _segments(n, n)
    kernels.reset_launch_counts()
    got = segmented_scan_sums(*(torch.from_numpy(a) for a in args))
    assert kernels.LAUNCHES["segmented_scan_sums"] == 0  # CPU: plain
    want_k = jax_segscan(*(jnp.asarray(a) for a in args), interpret=True)
    want_x = jax_segscan_xla(*(jnp.asarray(a) for a in args))
    for g, wk, wx in zip(got, want_k, want_x):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(wk))
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(wx))


SEG_CASES = {
    # n, starts: one tile of 79 rows (not a power of two); a padded tail;
    # one segment over three tiles; a start at every element; -0.0 in
    # every channel, and a long run of it before the first start.
    "rows79": (10_112, "random"),
    "padded": (10_000, "random"),
    "span3": (3 * 512 * 128, "one"),
    "every": (5_000, "every"),
    "negzero": (28 * 128, "negzero"),
}


def _case(name):
    n, starts = SEG_CASES[name]
    first, x, y, z, c = _segments(n, n)
    if starts == "one":
        first[1:] = 0.0
    if starts == "every":
        first[:] = 1.0
    if starts == "negzero":
        # x is -0.0 over the tile's first 3000 elements, with no start
        # among them: the masked `x + 0.0` adds turn it to +0.0.
        first[:3000] = 0.0
        x[:3000] = -0.0
        for a in (y, z):
            a[np.random.default_rng(n).random(n) < 0.5] = -0.0
    return first, x, y, z, c


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_segscan_plain_bitwise_cases(case):
    """The plain version bitwise against the Pallas kernel (interpret mode)
    and its XLA mirror."""
    args = _case(case)
    got = kernels.segmented_scan_sums_plain(
        *(torch.from_numpy(a) for a in args))
    want_k = jax_segscan(*(jnp.asarray(a) for a in args), interpret=True)
    want_x = jax_segscan_xla(*(jnp.asarray(a) for a in args))
    for g, wk, wx in zip(got, want_k, want_x):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(wk))
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(wx))


def _steps(sm, shift, take):
    """One Hillis-Steele step along the last axis of sm [5, ..., W]:
    element e adds element e - shift where ``take`` (else 0.0) unless its
    flag (channel 0) marks a start; the flag takes the max."""
    zero = torch.zeros_like(sm[..., :shift])
    sh = torch.where(take, torch.cat([zero, sm[..., :-shift]], -1), 0.0)
    start = sm[0] > 0.5
    vals = torch.where(start, sm[1:], sm[1:] + sh[1:])
    return torch.cat([torch.maximum(sm[0], sh[0])[None], vals])


def _three_pass(first, x, y, z, c, *, log_span, chunk, residues):
    """The CUDA kernel's schedule (csrc/segscan.cu) in torch: pass A, the
    steps of shift < 2^L on chunks plus their in-tile halo; pass B, the
    later steps on runs of residues mod 2^L; pass C, the tile carry where
    it applies. Returns the four sums."""
    n = first.shape[0]
    t, tl = kernels._segscan_layout(n)
    total = t * tl
    ch = torch.stack([torch.nn.functional.pad(a, (0, total - n))
                      for a in (first, x, y, z, c)])
    span = 1 << log_span
    scratch = torch.zeros((5, total))
    out = torch.zeros((4, total))

    def finish(v, gidx, tile):
        scratch[0, gidx] = v[0]
        start = v[0] > 0.5
        if tile == 0:
            out[:, gidx] = torch.where(start, v[1:],
                                       v[1:] + torch.zeros_like(v[1:]))
        else:
            out[:, gidx[start]] = v[1:, start]
            scratch[1:, gidx[~start]] = v[1:, ~start]

    # Pass A: every chunk of every tile at once, windows [K, W].
    lc = torch.arange(0, tl, chunk)
    ln = torch.clamp(tl - lc, max=chunk)
    halo = torch.clamp(lc, max=span - 1)
    local0 = lc - halo
    w = int((halo + ln).max())
    e = torch.arange(w)
    for tile in range(t):
        live = e < (halo + ln)[:, None]
        gidx = tile * tl + local0[:, None] + e
        sm = ch[:, gidx.clamp(max=total - 1)]
        d = 1
        while d < span and d < tl:
            sm = _steps(sm, d, live & (local0[:, None] + e >= d) & (e >= d))
            d *= 2
        done = live & (e >= halo[:, None])
        if tl <= span:
            finish(sm[:, done], gidx[done], tile)
        else:
            scratch[:, gidx[done]] = sm[:, done]
    # Pass B: runs of `residues` residues, rows p of one tile.
    if tl > span:
        rows = -(-tl // span)
        e = torch.arange(rows * residues)
        p = e // residues
        r0 = torch.arange(0, span, residues)[:, None]
        local = p * span + r0 + e % residues
        live = local < tl
        for tile in range(t):
            gidx = tile * tl + local
            sm = torch.where(live, scratch[:, gidx.clamp(max=total - 1)],
                             0.0)
            s = 1
            while s * span < tl:
                sm = _steps(sm, s * residues, live & (p >= s))
                s *= 2
            finish(sm[:, live], gidx[live], tile)
    # Pass C: the carry chain into tiles 1.. before their first start.
    carry = out[:, tl - 1].clone()
    for tile in range(1, t):
        sl = slice(tile * tl, (tile + 1) * tl)
        pend = scratch[0, sl] <= 0.5
        out[:, sl][:, pend] = scratch[1:, sl][:, pend] + carry[:, None]
        last = (tile + 1) * tl - 1
        carry = out[:, last].clone()
    return tuple(out[i, :n] for i in range(4))


@pytest.mark.parametrize("log_span,chunk,residues", [
    (2, 4, 1), (2, 12, 2), (3, 8, 4), (3, 40, 8), (10, 4096, 32),
    (10, 1536, 32)])
@pytest.mark.parametrize("case", ["rows79", "span3", "negzero", "every",
                                  "short"])
def test_three_pass_schedule_matches_plain(case, log_span, chunk, residues):
    """The decomposition the CUDA kernel runs, bitwise against the plain
    version: tiles shorter than 2^L ("short", 640), ragged residues (79
    rows at 2^10), one segment over three tiles, chunks with and without a
    full halo."""
    args = _case(case) if case != "short" else _segments(640, 640)
    ts = [torch.from_numpy(a) for a in args]
    got = _three_pass(*ts, log_span=log_span, chunk=chunk,
                      residues=residues)
    want = kernels.segmented_scan_sums_plain(*ts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w.numpy()))


def _cloud(seed, n, cap):
    rng = np.random.default_rng(seed)
    pts = np.vstack([
        (rng.random((n, 3)) * [30.0, 20.0, 2.0]).astype(np.float32),
        (rng.normal([5, 5, 1], 0.3, (n // 10, 3))).astype(np.float32),
    ])
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(pts)] = pts
    valid = np.zeros(cap, bool)
    valid[: len(pts)] = True
    xyz[3] = np.nan  # a non-finite row is skipped
    return xyz, valid


@pytest.mark.parametrize("ds_cap", [8192, 4096])
def test_voxel_downsample_sweep_fused_matches_jax(ds_cap):
    xyz, valid = _cloud(0, 6000, 8192)
    voxel = np.float32(0.15)
    want = jax_voxel_fused(jnp.asarray(xyz), jnp.asarray(valid), voxel,
                           factor=3, ds_cap=ds_cap)
    got = voxel_downsample_sweep_fused(torch.from_numpy(xyz),
                                       torch.from_numpy(valid), voxel,
                                       factor=3, ds_cap=ds_cap)
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        g = got[key].numpy()
        if w.dtype == np.float32:
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
    assert bool(got["ds_overflow"]) == (ds_cap == 4096)
