"""Halo-exchange sequence-axis sharding (parallel/halo.py) vs the
single-device chop/count oracle, on an 8-device CPU mesh."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import conftest  # noqa: F401,E402  (forces cpu + 8 virtual devices)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dbg_assembly import dna  # noqa: E402
from dbg_assembly.parallel import halo  # noqa: E402
from dbg_assembly.parallel.count_sharded import SENTINEL  # noqa: E402
from dbg_assembly.parallel.mesh import data_mesh  # noqa: E402


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return data_mesh(8)


def _oracle_kmers(codes_row, length, ksize):
    """Canonical k-mers of one sequence via the plain host path."""
    row = np.asarray(codes_row[:length], np.uint64)
    if length < ksize:
        return np.zeros(0, np.uint64)
    km = dna.rolling_kmers(row[None], ksize)[0]
    can, _ = dna.canonical(km, ksize)
    return np.asarray(can)


def test_halo_chop_matches_oracle(mesh):
    rng = np.random.default_rng(3)
    ksize = 21
    seqs = [rng.integers(0, 4, n).astype(np.uint8)
            for n in (1000, 777, 1024, 40, ksize - 1, 985)]
    codes, lengths = halo.pad_seqs_for_mesh(seqs, 8, ksize)
    out = np.asarray(halo.halo_chop(jnp.asarray(codes),
                                    jnp.asarray(lengths),
                                    ksize=ksize, mesh=mesh))
    assert out.shape == codes.shape
    for b, s in enumerate(seqs):
        exp = _oracle_kmers(codes[b], lengths[b], ksize)
        got = out[b]
        np.testing.assert_array_equal(got[:len(exp)], exp)
        assert (got[len(exp):] == SENTINEL).all()


def test_halo_chop_boundary_positions_exact(mesh):
    """K-mers that straddle tile boundaries (the halo-served ones) are the
    whole point — check them explicitly."""
    rng = np.random.default_rng(11)
    ksize = 31
    n = 8 * 64
    seq = rng.integers(0, 4, n).astype(np.uint8)
    codes, lengths = halo.pad_seqs_for_mesh([seq], 8, ksize)
    T = codes.shape[1] // 8
    out = np.asarray(halo.halo_chop(jnp.asarray(codes),
                                    jnp.asarray(lengths),
                                    ksize=ksize, mesh=mesh))[0]
    exp = _oracle_kmers(codes[0], lengths[0], ksize)
    for d in range(1, 8):
        for p in range(max(d * T - ksize + 1, 0), d * T):
            if p < len(exp):
                assert out[p] == exp[p], f"straddle kmer at {p} wrong"


def test_count_halo_sharded_matches_oracle(mesh):
    rng = np.random.default_rng(7)
    ksize = 17
    # low-entropy alphabet so there are repeated k-mers to count
    seqs = [np.repeat(rng.integers(0, 4, n // 3 + 1).astype(np.uint8), 3)[:n]
            for n in (3000, 2500, 1200)]
    codes, lengths = halo.pad_seqs_for_mesh(seqs, 8, ksize)
    capacity = codes.size // 8 + 64
    uniq, counts, n_unique, stats = halo.count_halo_sharded(
        jnp.asarray(codes), jnp.asarray(lengths),
        ksize=ksize, mesh=mesh, capacity=capacity)
    uniq = np.asarray(uniq)
    counts = np.asarray(counts)
    n_unique = np.asarray(n_unique)
    got = {}
    SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
    for d in range(8):
        keep = np.flatnonzero(uniq[d] != SENT)
        assert len(keep) == int(n_unique[d])
        for i in keep:
            got[int(uniq[d, i])] = int(counts[d, i])

    exp: dict[int, int] = {}
    for b, s in enumerate(seqs):
        for k in _oracle_kmers(codes[b], lengths[b], ksize):
            exp[int(k)] = exp.get(int(k), 0) + 1
    assert int(stats["dropped"]) == 0
    assert int(stats["total_kmers"]) == sum(exp.values())
    assert int(stats["unique_kmers"]) == len(exp)
    assert got == exp
