"""Property tests for the blocked two-level scans (kmer/stats.py) that the
counting, ingest, and distributed-merge kernels build on — exactness vs
the flat scans on awkward lengths (non-multiples of the block, tiny, 2-D)."""

import numpy as np
import pytest

import jax.numpy as jnp

from dbg_assembly.kmer import stats


@pytest.mark.parametrize("n", [1, 5, 4095, 4096, 4097, 10000])
def test_rcummin_blocked_1d(n):
    rng = np.random.default_rng(n)
    x = rng.integers(-2**30, 2**30, size=n).astype(np.int32)
    got = np.asarray(stats.rcummin_blocked(jnp.asarray(x),
                                           np.int32(2**31 - 1)))
    exp = np.minimum.accumulate(x[::-1])[::-1]
    assert np.array_equal(got, exp)


@pytest.mark.parametrize("n,k", [(1, 4), (4097, 4), (9000, 3)])
def test_rcummin_blocked_2d(n, k):
    rng = np.random.default_rng(n + k)
    x = rng.integers(0, 2**20, size=(n, k)).astype(np.int32)
    got = np.asarray(stats.rcummin_blocked(jnp.asarray(x),
                                           np.int32(2**31 - 1)))
    exp = np.minimum.accumulate(x[::-1], axis=0)[::-1]
    assert np.array_equal(got, exp)


@pytest.mark.parametrize("n", [1, 5, 4096, 4097, 10000])
def test_cumsum_blocked_1d(n):
    rng = np.random.default_rng(n * 7)
    x = rng.integers(0, 100, size=n).astype(np.int32)
    got = np.asarray(stats.cumsum_blocked(jnp.asarray(x)))
    assert np.array_equal(got, np.cumsum(x).astype(np.int32))


@pytest.mark.parametrize("n,k", [(4097, 4), (517, 2)])
def test_cumsum_blocked_2d(n, k):
    rng = np.random.default_rng(n - k)
    x = rng.integers(0, 50, size=(n, k)).astype(np.int32)
    got = np.asarray(stats.cumsum_blocked(jnp.asarray(x)))
    assert np.array_equal(got, np.cumsum(x, axis=0).astype(np.int32))
