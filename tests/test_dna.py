import numpy as np
import jax.numpy as jnp

from dbg_assembly import dna


def ref_revcomp_int(kbit: int, k: int) -> int:
    """Slow oracle for get_rev_com_kbit (DBG_contig/seqKmer.cpp:89-97)."""
    out = 0
    for i in range(k):
        base = (kbit >> (2 * i)) & 3
        out = (out << 2) | (3 - base)
    return out


def test_seq2bit_bit2seq_roundtrip():
    rng = np.random.default_rng(0)
    for k in (5, 17, 31):
        codes = rng.integers(0, 4, size=(20, k)).astype(np.uint8)
        kb = dna.seq2bit(codes)
        for i in range(20):
            s = dna.bit2seq(int(kb[i]), k)
            back = dna.ascii_to_codes(np.frombuffer(s.encode(), np.uint8))
            assert np.array_equal(back, codes[i])


def test_revcomp_kbit_matches_oracle_and_involution():
    rng = np.random.default_rng(1)
    for k in (5, 17, 31):
        kb = rng.integers(0, 1 << (2 * k), size=200, dtype=np.uint64)
        rc = dna.revcomp_kbit(kb, k)
        for i in range(0, 200, 37):
            assert int(rc[i]) == ref_revcomp_int(int(kb[i]), k)
        rc2 = dna.revcomp_kbit(rc, k)
        assert np.array_equal(rc2, kb)


def test_revcomp_kbit_jax_matches_numpy():
    rng = np.random.default_rng(2)
    k = 31
    kb = rng.integers(0, 1 << (2 * k), size=128, dtype=np.uint64)
    out_np = dna.revcomp_kbit(kb, k)
    out_jx = np.asarray(dna.revcomp_kbit(jnp.asarray(kb), k))
    assert np.array_equal(out_np, out_jx)


def test_rolling_kmers_matches_direct():
    rng = np.random.default_rng(3)
    k = 21
    codes = rng.integers(0, 4, size=(8, 60)).astype(np.uint8)
    roll = dna.rolling_kmers(codes, k)
    for i in range(8):
        for j in range(60 - k + 1):
            direct = dna.seq2bit(codes[i, j:j + k])
            assert int(roll[i, j]) == int(direct)


def test_canonical_symmetry():
    rng = np.random.default_rng(4)
    k = 17
    kb = rng.integers(0, 1 << (2 * k), size=500, dtype=np.uint64)
    can, rc = dna.canonical(kb, k)
    can2, _ = dna.canonical(rc, k)
    assert np.array_equal(can, can2)


def test_next_kmer_steps():
    k = 7
    kb = np.uint64(int("0123012" .translate(str.maketrans("0123", "0123")), 4))
    r = dna.next_kmer_rightward(kb, 2, k)
    l = dna.next_kmer_leftward(kb, 3, k)
    assert int(r) == ((int(kb) << 2 | 2) & ((1 << 14) - 1))
    assert int(l) == ((int(kb) >> 2) + (3 << 12))
