import numpy as np
import jax.numpy as jnp

from dbg_assembly.kmer import count as kc


def test_count_stats_matches_compacted_path():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(200, 60)).astype(np.uint8)
    lengths = rng.integers(15, 61, size=200).astype(np.int32)
    flat, _ = kc.chop_canonical(jnp.asarray(codes), jnp.asarray(lengths), 15)
    spec, n_uniq, n_valid = kc.count_stats(flat, max_freq=255)
    u, c, t = kc.count_batch(codes, lengths, 15)
    assert int(n_valid) == t
    assert int(n_uniq) == len(u)
    assert np.array_equal(np.asarray(spec), kc.spectrum(c, max_freq=255))


def test_count_stats_all_sentinel():
    flat = jnp.full(64, kc.SENTINEL, jnp.uint64)
    spec, n_uniq, n_valid = kc.count_stats(flat, max_freq=15)
    assert int(n_uniq) == 0
    assert int(n_valid) == 0
    assert int(np.asarray(spec).sum()) == 0
