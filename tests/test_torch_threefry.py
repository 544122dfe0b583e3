"""Threefry bits and RANSAC sample draws of the PyTorch port against
``jax.random`` (the JAX package's 64-bit mode, partitionable threefry)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pointclouds_tpu  # noqa: F401  (x64, as the package runs)
from pointclouds_tpu.ops.segmentation import (
    _sample_three_distinct as jax_sample_three,
)
from pointclouds_tpu_torch.ops.segmentation import _sample_three_distinct
from pointclouds_tpu_torch.utils.threefry import mod_u64, random_bits64

SEEDS = list(range(100)) + [2**31 - 1]


def _as_u64(hi, lo):
    return (hi.numpy().astype(np.uint64) << np.uint64(32)) | lo.numpy().astype(
        np.uint64)


@pytest.mark.parametrize("shape", [(3, 1), (3, 7), (3, 500), (3, 4096)])
def test_bits_match_jax(shape):
    assert jax.config.jax_threefry_partitionable
    draw = jax.jit(lambda s: jax.random.bits(jax.random.PRNGKey(s), shape))
    for seed in SEEDS:
        want = np.asarray(draw(np.int32(seed)))
        assert want.dtype == np.uint64
        hi, lo = random_bits64(seed, shape)
        np.testing.assert_array_equal(_as_u64(hi, lo), want, err_msg=str(seed))


@pytest.mark.parametrize("m", [3, 7, 4096, 93_033, 2**31 - 1])
def test_mod_u64_matches_uint64_modulo(m):
    hi, lo = random_bits64(5, (3, 500))
    want = _as_u64(hi, lo) % np.uint64(m)
    np.testing.assert_array_equal(mod_u64(hi, lo, m).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("cnt", [0, 3, 4, 1000, 93_033])
@pytest.mark.parametrize("seed", [0, 1234, 2**31 - 1])
def test_sample_three_distinct_matches_jax(seed, cnt):
    want = np.asarray(jax_sample_three(jax.random.PRNGKey(seed), 500,
                                       jnp.int32(cnt)))
    got = _sample_three_distinct(seed, 500, cnt).numpy()
    np.testing.assert_array_equal(got, want)
    if cnt >= 3:
        assert (got[:, 0] != got[:, 1]).all() and (got[:, 1] != got[:, 2]).all()
        assert (got[:, 0] != got[:, 2]).all() and (got < cnt).all()
