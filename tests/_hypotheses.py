"""Inputs for the tests of RANSAC's plane hypotheses (kernel 19,
`kernels.ransac_hypotheses`), shared by the CPU test against the JAX
package and the card test against the plain version. This module imports
numpy, torch and the port only (no jax), so that the card's tests can use
it."""

import numpy as np
import torch

from pointclouds_tpu_torch.core.cloud import compaction_order


def hypothesis_cloud(case, mapping, seed, n=512, n_valid=300):
    """(xyz f32 [n, 3], valid bool [n], position_rows int64 [n]) as numpy:
    ``n_valid`` valid rows, but "cnt0" ... "cnt3" that many (the draw clamps
    the count to 3), "full" every row, "degenerate" 40 valid points, 32 of
    them on two lines with duplicates, "nan" 24 valid points, one of them
    NaN. Valid rows lead under ``mapping`` "compact", else lie scattered;
    ``position_rows`` lists them first, in a random order."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    k = {"cnt0": 0, "cnt1": 1, "cnt2": 2, "cnt3": 3, "full": n,
         "degenerate": 40, "nan": 24}.get(case, n_valid)
    rows = (np.arange(k) if mapping == "compact"
            else np.sort(rng.choice(n, k, replace=False)))
    valid = np.zeros(n, bool)
    valid[rows] = True
    if case == "degenerate":
        line = rng.integers(0, 6, 32).astype(np.float32)
        xyz[rows[:16]] = np.column_stack([line[:16], np.zeros(16),
                                          np.zeros(16)])
        xyz[rows[16:32]] = np.column_stack([np.full(16, 2.5), line[16:],
                                            np.full(16, -1.0)])
    if case == "nan":
        xyz[rows[5], 1] = np.nan
    key = np.where(valid, rng.permutation(n), 2**31 - 1)
    position_rows = np.argsort(key, kind="stable")
    return xyz, valid, position_rows


def position_map(mapping, valid, position_rows):
    """The wrapper's ``order`` for ``mapping``: "rows" the pipelines'
    `position_rows`, "compact" None (`assume_compact`), "compaction" the
    compaction order of ``valid`` (bool tensor)."""
    if mapping == "rows":
        return torch.from_numpy(position_rows)
    return None if mapping == "compact" else compaction_order(valid)


def assert_same_bits(got, want):
    """Equal dtypes, shapes and bits (a zero's sign too), NaN for NaN (a
    NaN's payload is the arithmetic's own); tensors or arrays."""
    got, want = (np.asarray(x.cpu() if torch.is_tensor(x) else x)
                 for x in (got, want))
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == np.float32:
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        got, want = got.view(np.int32)[~nan], want.view(np.int32)[~nan]
    np.testing.assert_array_equal(got, want)
