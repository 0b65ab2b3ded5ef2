import numpy as np
import pytest

from dbg_assembly import dna
from dbg_assembly.kmer import count as kc
from dbg_assembly.io import cz


def naive_counts(codes, lengths, k):
    """Oracle: dict-based canonical k-mer counting."""
    d = {}
    total = 0
    for i in range(len(codes)):
        L = int(lengths[i])
        for j in range(L - k + 1):
            kb = int(dna.seq2bit(codes[i, j:j + k]))
            rc = int(dna.revcomp_kbit(np.uint64(kb), k))
            can = min(kb, rc)
            d[can] = d.get(can, 0) + 1
            total += 1
    return d, total


def test_count_batch_matches_oracle():
    rng = np.random.default_rng(0)
    k = 15
    N, L = 40, 80
    codes = rng.integers(0, 4, size=(N, L)).astype(np.uint8)
    lengths = rng.integers(k, L + 1, size=N).astype(np.int32)
    uniq, counts, total = kc.count_batch(codes, lengths, k)
    oracle, ototal = naive_counts(codes, lengths, k)
    assert total == ototal
    assert len(uniq) == len(oracle)
    got = dict(zip(uniq.tolist(), counts.tolist()))
    assert got == oracle


def test_counter_streaming_merge():
    rng = np.random.default_rng(1)
    k = 13
    codes = rng.integers(0, 4, size=(300, 60)).astype(np.uint8)
    lengths = np.full(300, 60, np.int32)
    c1 = kc.KmerCounter(k, batch_reads=64)
    c1.add(codes, lengths)
    u1, n1, t1 = c1.finalize()
    c2 = kc.KmerCounter(k, batch_reads=1000)
    c2.add(codes, lengths)
    u2, n2, t2 = c2.finalize()
    assert t1 == t2
    assert np.array_equal(u1, u2)
    assert np.array_equal(n1, n2)


def test_bitmap_roundtrip_and_rc():
    rng = np.random.default_rng(2)
    k = 9
    codes = rng.integers(0, 4, size=(50, 40)).astype(np.uint8)
    lengths = np.full(50, 40, np.int32)
    uniq, counts, _ = kc.count_batch(codes, lengths, k)
    bm = kc.freq_bitmap(uniq, counts, k, low_freq_cutoff=1)
    hi = uniq[counts > 1]
    lo = uniq[counts <= 1]
    assert np.all(kc.bitmap_get(bm, hi) == 1)
    assert np.all(kc.bitmap_get(bm, lo) == 0)
    bm_rc = kc.expand_bitmap_rc(bm, k)
    rc = dna.revcomp_kbit(hi.astype(np.uint64), k)
    assert np.all(kc.bitmap_get(bm_rc, rc) == 1)


def test_cz_bits_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    k = 9
    total = 1 << (2 * k)
    bm = rng.integers(0, 256, size=total // 8).astype(np.uint8)
    p = str(tmp_path / "t.cz")
    cz.write_cz_bits(p, bm)
    back = cz.read_cz_bits(p, k)
    assert np.array_equal(bm, back)


def test_cz_bytes_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    k = 9
    total = 1 << (2 * k)
    freqs = rng.integers(0, 256, size=total).astype(np.uint8)
    p = str(tmp_path / "t8.cz")
    cz.write_cz_bytes(p, freqs)
    back = cz.read_cz_bytes(p, k)
    assert np.array_equal(freqs, back)


@pytest.mark.gpu
def test_count_batch_on_gpu_matches_numpy():
    """The production device counter at a real batch width (200 000 PE250
    reads, k=17, as KmerCounter feeds it) against numpy's unique."""
    rng = np.random.default_rng(9)
    k, N, L = 17, 200_000, 250
    genome = rng.integers(0, 4, 2_000_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - L, N)
    codes = genome[starts[:, None] + np.arange(L)]
    lengths = rng.integers(k - 1, L + 1, N).astype(np.int32)
    for i in np.flatnonzero(lengths < L)[:1000]:
        codes[i, lengths[i]:] = 4
    uniq, counts, total = kc.count_batch(codes, lengths, k)
    km = dna.rolling_kmers(codes, k)
    can = np.minimum(km, dna.revcomp_kbit(km, k))
    valid = np.arange(L - k + 1)[None, :] < (lengths[:, None] - k + 1)
    want_u, want_c = np.unique(can[valid], return_counts=True)
    np.testing.assert_array_equal(uniq, want_u)
    np.testing.assert_array_equal(counts, want_c)
    assert total == int(valid.sum())
