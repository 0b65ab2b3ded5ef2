"""Device correction engine (correct/device.py) vs the parity host engine.

Random genomes + error-planted reads; the device wave/beam pipeline must
reproduce the host ReadCorrector's scores, trims, deletions and the
corrected read bytes exactly (fallback rows excluded — they are re-run on
the host engine by the pipeline anyway)."""

import numpy as np
import pytest

from dbg_assembly import dna
from dbg_assembly.kmer import count as kc
from dbg_assembly.correct.engine import (CorrectParams, ReadCorrector,
                                             classify_regions_batch)
from dbg_assembly.correct import device as dev


def _make_case(seed, n_reads=120, read_len=80, k=13, genome_len=4000,
               n_err_max=4):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    # bitmap: genome k-mers (canonical) are "high frequency"
    gk = dna.rolling_kmers(genome, k)
    can = np.minimum(gk, dna.revcomp_kbit(gk, k))
    counts = np.full(len(can), 9, np.int64)
    bitmap = kc.freq_bitmap(can, counts, k, low_freq_cutoff=1)
    bitmap = kc.expand_bitmap_rc(bitmap, k)

    starts = rng.integers(0, genome_len - read_len, n_reads)
    codes = np.stack([genome[s:s + read_len] for s in starts])
    for i in range(n_reads):
        for _ in range(rng.integers(0, n_err_max + 1)):
            p = rng.integers(0, read_len)
            codes[i, p] = rng.integers(0, 4)
    ascii_seq = np.frombuffer(b"ACGT", np.uint8)[codes].copy()
    lengths = np.full(n_reads, read_len, np.int32)
    return ascii_seq, codes, lengths, bitmap


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_device_matches_host(seed):
    ascii_seq, codes, lengths, bitmap = _make_case(seed)
    p = CorrectParams(ksize=13, max_change=2, min_read_len=40).resolved()

    import jax.numpy as jnp
    (one, multi, deleted, tl, tr, am, fb) = dev.correct_batch_device(
        ascii_seq.copy(), codes, lengths, jnp.asarray(bitmap), p)

    bits = classify_regions_batch(codes, lengths, bitmap, p.ksize)
    n = len(lengths)
    host = []
    reads_host = ascii_seq.copy()
    for i in range(n):
        corr = ReadCorrector(bitmap, p)
        L = int(lengths[i])
        read = bytearray(ascii_seq[i, :L].tobytes())
        res = corr.correct_one_read(read, bits[i, :L - p.ksize + 1])
        host.append(res)
        reads_host[i, :L] = np.frombuffer(bytes(read), np.uint8)
    ho, hm, hd, htl, htr = map(np.array, zip(*host))

    keep = ~fb
    assert keep.sum() > 0
    np.testing.assert_array_equal(one[keep], ho[keep], err_msg="one_score")
    np.testing.assert_array_equal(multi[keep], hm[keep],
                                  err_msg="multi_score")
    np.testing.assert_array_equal(deleted[keep], hd[keep],
                                  err_msg="deleted")
    np.testing.assert_array_equal(tl[keep], htl[keep], err_msg="trim_left")
    np.testing.assert_array_equal(tr[keep], htr[keep], err_msg="trim_right")
    np.testing.assert_array_equal(am[keep], reads_host[keep],
                                  err_msg="read bytes")
    # the point of the device path: fallback should be rare
    assert fb.mean() < 0.1


def test_pipeline_jax_engine_matches_native(tmp_path):
    """Full correct_file through engine='jax' vs engine='native'."""
    import gzip
    from dbg_assembly.correct import pipeline

    ascii_seq, codes, lengths, bitmap = _make_case(7, n_reads=60)
    fq = str(tmp_path / "reads.fq.gz")
    with gzip.open(fq, "wb") as f:
        for i in range(len(lengths)):
            seq = ascii_seq[i].tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * len(seq)))
    p = CorrectParams(ksize=13, max_change=2, min_read_len=40)

    pipeline.correct_file(fq, bitmap, p, fmt=1, engine="native")
    ref_out = gzip.open(fq + ".correct.fa.gz").read()
    ref_stat = open(fq + ".correct.stat").read()
    pipeline.correct_file(fq, bitmap, p, fmt=1, engine="jax")
    jax_out = gzip.open(fq + ".correct.fa.gz").read()
    jax_stat = open(fq + ".correct.stat").read()
    assert ref_out == jax_out
    assert ref_stat == jax_stat


def test_bbt_compact_takes_first_active_rows():
    """Active-row compaction runs the first compact_c active rows, in row
    order, exactly as the full-width beam search does, and flags the active
    rows past that width for host fallback without touching them."""
    import functools
    import jax
    import jax.numpy as jnp

    ascii_seq, codes, lengths, bitmap = _make_case(5, n_reads=64)
    k, C = 13, 8
    N, L = ascii_seq.shape
    rng = np.random.default_rng(11)
    active = rng.random(N) < 0.5
    assert active.sum() > C
    bm = jnp.asarray(bitmap)
    args = (jnp.asarray(ascii_seq), jnp.asarray(lengths),
            lambda idx: dev._probe(bm, idx), jnp.asarray(active),
            jnp.full((N,), k + 1, jnp.int32), jnp.asarray(lengths),
            jnp.full((N,), 2, jnp.int32), jnp.asarray(lengths) + 1)
    kw = dict(k=k, rightward=True, is_modify_trimmed=True)
    full = jax.jit(functools.partial(dev._bbt_impl, *args[:3], **kw))(
        *args[3:])
    compact = jax.jit(functools.partial(dev._bbt_compact, *args[:3],
                                        compact_c=C, **kw))(*args[3:])
    full = [np.asarray(x) for x in full]
    new_ascii, num, lnt, last, ovf = (np.asarray(x) for x in compact)

    rank = np.cumsum(active) - 1
    ran = active & (rank < C)
    late = active & (rank >= C)
    for got, want in zip((new_ascii, num, lnt, last), full[:4]):
        np.testing.assert_array_equal(got[ran], want[ran])
    np.testing.assert_array_equal(ovf[ran], full[4][ran])
    assert ovf[late].all() and not ovf[~active].any()
    np.testing.assert_array_equal(new_ascii[~ran], ascii_seq[~ran])
    assert not num[~ran].any()
