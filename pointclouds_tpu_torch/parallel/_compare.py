"""The rules a tiled frame is held to against the unsharded pipeline's
(those of the JAX package's `tests/test_tiles.py` and
`tests/test_tiles_aerial.py`), on numpy arrays: the port's tiled tests
and `chip_smoke.py` share them.

The tiles sum in another order than the unsharded run, so centroids may
move by an ulp, kept counts by a few rows (float64 threshold sums) and
normals by the eigenvector of a near-degenerate neighbourhood; rows are
matched by coordinates, never by position.
"""

from __future__ import annotations

import numpy as np


def clusters_as_sets(xyz, valid, labels, min_size: int) -> list:
    """Clusters of at least ``min_size`` rows as sets of coordinates
    rounded to 0.1 mm (a centroid may differ by an ulp; rows are at least a
    voxel apart), largest first."""
    xyz = np.round(np.asarray(xyz, np.float64), 4)
    out = []
    for lab in np.unique(labels[valid]):
        rows = np.nonzero(valid & (labels == lab))[0]
        if len(rows) >= min_size:
            out.append(frozenset(map(tuple, xyz[rows].tolist())))
    return sorted(out, key=lambda s: (-len(s), sorted(s)[0]))


def plane_close(a, b) -> bool:
    """Plane normals equal up to sign, to 5e-3 in |cos|."""
    return abs(abs(float(np.dot(a, b))) - 1.0) < 5e-3


def centroid_sets_close(got, want) -> bool:
    """The same number of centroids, equal as sets to rtol 3e-7."""
    if got.shape != want.shape:
        return False
    return bool(np.allclose(got[np.lexsort(got.T)], want[np.lexsort(want.T)],
                            rtol=3e-7, atol=1e-6))


def kept_close(got: int, want: int) -> bool:
    """SOR kept counts within max(2, want / 1000) rows."""
    return abs(got - want) <= max(2, want // 1000)


def normals_match(cents, normals, ok, want_cents, want_normals,
                  want_ok) -> bool:
    """Normals matched by their rows' coordinates: more than 99.9% of the
    rows found, median |dot| above 0.9999, and |dot| above 0.999 on 99.9%
    of the rows both runs certify (at least one)."""
    rmap = {tuple(c): (n, o) for c, n, o in zip(
        np.round(want_cents, 4).tolist(), want_normals, want_ok)}
    dots, cert = [], []
    for c, n, o in zip(np.round(cents, 4).tolist(), normals, ok):
        r = rmap.get(tuple(c))
        if r is not None:
            dots.append(abs(float(np.dot(n, r[0]))))
            if o and r[1]:
                cert.append(dots[-1])
    return bool(len(dots) > 0.999 * len(cents) and cert
                and np.median(dots) > 0.9999
                and (np.asarray(cert) > 0.999).mean() > 0.999)
