"""The scalable pointer-doubling pipeline must reproduce the exact host
path's results: same pruning decisions (conflict-free rounds replay the
reference's slot-order replay) and the same contig/depth content (validated
on orientation-canonicalized multisets — output order and strand are
hash-iteration artifacts the scalable path deliberately does not copy)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

COMP = bytes.maketrans(b"ACGT", b"TGCA")


def canon_seq(s: bytes) -> bytes:
    rc = s.translate(COMP)[::-1]
    return min(s, rc)


def read_fa_seqs(path: str) -> list[bytes]:
    out = []
    with open(path, "rb") as f:
        for line in f:
            if not line.startswith(b">"):
                out.append(line.strip())
    return out


def read_depth_recs(path: str) -> list[bytes]:
    """Depth files are >name\\n<raw bytes>\\n records."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        assert data[i:i + 1] == b">"
        j = data.index(b"\n", i)
        # record seq length from the matching fa is unknown here; depth
        # bytes never contain \n (10 avoided), so next newline ends it
        e = data.index(b"\n", j + 1)
        out.append(data[j + 1:e])
        i = e + 1
    return out


def build_table(genome_size, seed, err=0.0, cov=30.0, K=21):
    from tools.simulate_reads import make_genome, simulate_pe
    from dbg_assembly.contig.graph import GraphBuilder
    from dbg_assembly import dna

    genome = make_genome(genome_size, seed=seed, repeat_frac=0.0)
    r1, q1, r2, q2 = simulate_pe(genome, 100, 300, cov, seed=seed + 1,
                                 err_start=err, err_end=err)
    codes = np.concatenate([dna.ascii_to_codes(r1), dna.ascii_to_codes(r2)])
    lengths = np.full(len(codes), 100, np.int32)
    gb = GraphBuilder(K, max_read_len=250)
    gb.add(codes, lengths)
    return gb.finalize(), K


def run_both(table, K, tmp_path, **flags):
    from dbg_assembly.contig.refassemble import (AssembleParams,
                                                     RefAssembler)
    from dbg_assembly.contig import pointer_doubling as pd

    params = AssembleParams(ksize=K, init_hash_size=0.001,
                            contig_len_cutoff=100, **flags)
    hp = str(tmp_path / "host")
    host_stats = RefAssembler(table, params).run(hp)
    params2 = AssembleParams(ksize=K, init_hash_size=0.001,
                             contig_len_cutoff=100, **flags)
    dp = str(tmp_path / "dbl")
    dbl_stats = pd.assemble_doubling(table, params2, dp)
    return hp, host_stats, dp, dbl_stats


def record_multiset(prefix, kind):
    """Exact (header-after-id, seq, depth) records — the doubling path
    reproduces the serial path's bytes per record; only file order
    (length-sort tie-breaks) may differ."""
    headers, seqs = [], []
    with open(prefix + f".contig.{kind}.fa", "rb") as f:
        for line in f:
            if line.startswith(b">"):
                # strip ">ctg_<id>" — ids depend on file order
                headers.append(line.split(b"\t", 1)[1])
            else:
                seqs.append(line.strip())
    deps = read_depth_recs(prefix + f".contig.{kind}.depth")
    assert len(seqs) == len(deps) == len(headers)
    return sorted(zip(headers, seqs, deps))


def assert_equiv(hp, dp):
    for kind in ("seq", "small"):
        assert record_multiset(hp, kind) == record_multiset(dp, kind), kind
    with open(hp + ".contig.kmer.freq", "rb") as f1, \
            open(dp + ".contig.kmer.freq", "rb") as f2:
        assert f1.read() == f2.read()
    # kmer.freq is order-independent: byte equality required
    with open(hp + ".contig.kmer.freq", "rb") as f1, \
            open(dp + ".contig.kmer.freq", "rb") as f2:
        assert f1.read() == f2.read()


def test_no_pruning_chains_match(tmp_path):
    table, K = build_table(30_000, seed=5)
    hp, hs, dp, ds = run_both(
        table, K, tmp_path, is_remove_tip=False,
        is_remove_lowedge=False, is_remove_bubble=False)
    assert hs.contig_num > 0
    assert (hs.contig_num, hs.contig_len, hs.small_num, hs.small_len) == \
        (ds.contig_num, ds.contig_len, ds.small_num, ds.small_len)
    assert_equiv(hp, dp)


def test_full_pipeline_with_pruning_matches(tmp_path):
    # error-bearing reads so tips/bubbles exist and pruning decisions are
    # actually exercised
    table, K = build_table(40_000, seed=17, err=0.006, cov=40.0)
    hp, hs, dp, ds = run_both(table, K, tmp_path)
    assert hs.tips_removed > 0, "fixture must exercise tip removal"
    assert (hs.tips_removed, hs.tip_len_removed) == \
        (ds.tips_removed, ds.tip_len_removed)
    assert (hs.lowedges_removed, hs.lowedge_len_removed) == \
        (ds.lowedges_removed, ds.lowedge_len_removed)
    assert (hs.bubbles_removed, hs.bubble_len_removed) == \
        (ds.bubbles_removed, ds.bubble_len_removed)
    assert (hs.contig_num, hs.contig_len, hs.small_num, hs.small_len) == \
        (ds.contig_num, ds.contig_len, ds.small_num, ds.small_len)
    assert_equiv(hp, dp)


def test_diploid_bubbles_match(tmp_path):
    """Two haplotypes -> real reconverging bubbles for the batched
    SNP/INDEL compare path."""
    from tools.simulate_reads import make_genome, simulate_pe
    from dbg_assembly.contig.graph import GraphBuilder
    from dbg_assembly import dna

    K = 21
    rng = np.random.default_rng(9)
    g1 = np.asarray(make_genome(30_000, seed=8, repeat_frac=0.0))
    g2 = g1.copy()
    # scatter heterozygous SNPs every ~600 bp
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for p in range(300, len(g2) - 300, 600):
        cur = int(np.flatnonzero(acgt == g2[p])[0])
        g2[p] = acgt[(cur + 1 + int(rng.integers(3))) % 4]
    parts = []
    for i, g in enumerate((g1, g2)):
        r1, q1, r2, q2 = simulate_pe(g, 100, 300, 25.0, seed=30 + i,
                                     err_start=0.0, err_end=0.0)
        parts.append(dna.ascii_to_codes(r1))
        parts.append(dna.ascii_to_codes(r2))
    codes = np.concatenate(parts)
    lengths = np.full(len(codes), 100, np.int32)
    gb = GraphBuilder(K, max_read_len=250)
    gb.add(codes, lengths)
    table = gb.finalize()

    hp, hs, dp, ds = run_both(table, K, tmp_path)
    assert hs.bubbles_removed > 0, "fixture must exercise bubble removal"
    assert (hs.bubbles_removed, hs.bubble_len_removed) == \
        (ds.bubbles_removed, ds.bubble_len_removed)
    assert (hs.contig_num, hs.contig_len, hs.small_num, hs.small_len) == \
        (ds.contig_num, ds.contig_len, ds.small_num, ds.small_len)
    assert_equiv(hp, dp)
