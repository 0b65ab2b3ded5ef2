"""Mesh-sharded correction table (correct/sharded.py) vs single-device.

SURVEY P4: at k>17 the 4^k-bit frequency table exceeds one device's HBM;
these tests prove the sharded-residency path (table partitioned over the
mesh 'd' axis, embedding-table probe collective) is bit-identical to the
single-device bitmap path on the 8-device CPU mesh.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from dbg_assembly.correct import device as dev
from dbg_assembly.correct import sharded
from dbg_assembly.kmer import count as kc

K = 11          # 4^11 bits = 512 KiB table


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    return Mesh(np.array(devs[:8]), ("d",))


@pytest.fixture(scope="module")
def bitmap():
    rng = np.random.default_rng(5)
    return rng.integers(0, 256, size=(1 << (2 * K)) // 8, dtype=np.uint8)


def test_probe_collective_matches_bitmap_get(mesh, bitmap):
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 1 << (2 * K), size=4096, dtype=np.uint64)
    bm = sharded.shard_bitmap(mesh, bitmap)
    from jax import shard_map

    f = jax.jit(shard_map(
        lambda b, i: sharded.probe_collective(b, i),
        mesh=mesh, in_specs=(P("d"), P("d")), out_specs=P("d")))
    got = np.asarray(f(bm, jnp.asarray(idx)))
    want = kc.bitmap_get(bitmap, idx).astype(bool)
    np.testing.assert_array_equal(got, want)


def test_full_correction_sharded_matches_single_device(mesh):
    """Stage B: the complete 5-phase corrector —
    phase-4 BBT gap waves + phase-5 head/tail trimming included — runs
    under shard_map with the table sharded, bit-equal to the single-device
    path.  Reads carry planted errors over a genome-derived table so the
    waves and beams do real work."""
    from dbg_assembly.correct.engine import CorrectParams

    rng = np.random.default_rng(11)
    glen, L, n = 30_000, 100, 100       # n not divisible by 8
    genome = rng.integers(0, 4, size=glen).astype(np.uint8)
    starts = rng.integers(0, glen - L, size=n)
    codes = np.stack([genome[s:s + L] for s in starts])
    errs = rng.random(codes.shape) < 0.01
    codes = np.where(errs, (codes + rng.integers(1, 4, codes.shape)) % 4,
                     codes).astype(np.uint8)
    ascii_seq = np.frombuffer(b"ACGT", np.uint8)[codes].copy()
    lengths = np.full(n, L, np.int32)

    counter = kc.KmerCounter(K)
    counter.add(codes, lengths)
    uniq, counts, _ = counter.finalize()
    bm_np = kc.expand_bitmap_rc(kc.freq_bitmap(uniq, counts, K, 1), K)

    p = CorrectParams(ksize=K, max_change=2)
    single = dev.correct_batch_device(
        ascii_seq, codes, lengths, dev.bitmap_device(bm_np), p)
    bm = sharded.shard_bitmap(mesh, bm_np)
    multi = sharded.correct_batch_sharded(mesh, ascii_seq, codes, lengths,
                                          bm, p)
    names = ("one", "multi", "deleted", "trim_left", "trim_right",
             "ascii", "fallback")
    assert len(single) == len(multi) == 7
    for nm, s, m_ in zip(names, single, multi):
        np.testing.assert_array_equal(np.asarray(s), m_, err_msg=nm)
    # the batch exercised real correction work
    assert int(np.asarray(single[0]).sum() + np.asarray(single[1]).sum()) > 0


def test_stage_a_sharded_matches_single_device(mesh, bitmap):
    rng = np.random.default_rng(7)
    n, L = 50, 100                      # deliberately not divisible by 8
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    ascii_seq = np.frombuffer(b"ACGT", np.uint8)[codes].copy()
    lengths = rng.integers(60, L + 1, size=n).astype(np.int32)

    single = dev._stage_a(jnp.asarray(ascii_seq), jnp.asarray(codes),
                          jnp.asarray(lengths), jnp.asarray(bitmap),
                          k=K, m=2 * K, max_change=2)
    bm = sharded.shard_bitmap(mesh, bitmap)
    multi = sharded.stage_a_sharded(mesh, ascii_seq, codes, lengths, bm,
                                    k=K, m=2 * K, max_change=2)
    assert len(single) == len(multi) == 6
    for s, m_ in zip(single, multi):
        np.testing.assert_array_equal(np.asarray(s), m_)
