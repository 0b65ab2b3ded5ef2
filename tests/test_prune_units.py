"""Hand-built-graph unit tests for tip/bubble pruning (the reference has no
unit tests; SURVEY.md section 4 calls for these)."""

import numpy as np

from dbg_assembly import dna
from dbg_assembly.contig.graph import GraphBuilder
from dbg_assembly.contig.refassemble import AssembleParams, RefAssembler

K = 15


def full_reads(seq: bytes, depth: int):
    """Whole-sequence reads: every k-mer/transition count == depth exactly."""
    return [seq] * depth


def build_table(read_sets):
    reads = [r for rs in read_sets for r in rs]
    L = max(len(r) for r in reads)
    codes = np.full((len(reads), L), 4, np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = dna.ascii_to_codes(
            np.frombuffer(r, np.uint8))
        lens[i] = len(r)
    gb = GraphBuilder(K, max_read_len=250)
    gb.add(codes, lens)
    return gb.finalize()


def rand_seq(n, seed):
    rng = np.random.default_rng(seed)
    return bytes(bytearray(b"ACGT"[c] for c in rng.integers(0, 4, n)))


def test_tip_removed(tmp_path):
    backbone = rand_seq(200, 1)
    tip = backbone[:80] + rand_seq(25, 2)      # dead-end branch, depth 3
    table = build_table([full_reads(backbone, 10), full_reads(tip, 3)])
    asm = RefAssembler(table, AssembleParams(
        ksize=K, init_hash_size=0.0001, contig_len_cutoff=50))
    stats = asm.run(str(tmp_path / "t"))
    assert stats.tips_removed >= 1
    # the backbone must survive as one contig containing its middle
    seqs = [line.strip() for line in
            open(str(tmp_path / "t") + ".contig.seq.fa", "rb")
            if not line.startswith(b">")]
    mid = backbone[90:130]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    assert any(mid in s or mid.translate(comp)[::-1] in s for s in seqs)


def test_bubble_removes_lower_depth_branch(tmp_path):
    a = rand_seq(100, 3)
    x = rand_seq(40, 4)
    y = bytearray(x)
    y[20] = ord("A" if chr(x[20]) != "A" else "C")
    b = rand_seq(100, 5)
    s1 = a + x + b
    s2 = a + bytes(y) + b
    table = build_table([full_reads(s1, 12), full_reads(s2, 5)])
    asm = RefAssembler(table, AssembleParams(
        ksize=K, init_hash_size=0.0001, contig_len_cutoff=50,
        is_remove_tip=False, is_remove_lowedge=False))
    stats = asm.run(str(tmp_path / "b"))
    assert stats.bubbles_removed == 1
    # surviving contig spans the bubble with the HIGH-depth variant
    seqs = [line.strip() for line in
            open(str(tmp_path / "b") + ".contig.seq.fa", "rb")
            if not line.startswith(b">")]
    probe = x[10:30]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    assert any(probe in s or probe.translate(comp)[::-1] in s for s in seqs)
    probe2 = bytes(y)[10:30]
    assert not any(probe2 in s or probe2.translate(comp)[::-1] in s
                   for s in seqs)
