"""Cross-engine agreement tests (ADVICE round 1).

Each compute stage has up to three implementations — the JAX device path,
a numpy twin, and a native C++ engine.  On the CPU-forced test host the
native engines are the default, so without these tests the JAX/numpy paths
would go unexercised.  Here every path is run on the same inputs and the
results are asserted identical:

  * graph ingest: _aggregate_batch (jax) vs _aggregate_batch_np vs
    NativeIngest (contig/graph.py, native/ingest_engine.cpp);
  * full assembly artifacts: native engine vs DBG_PY_ASSEMBLE=1
    (contig/refassemble.py, native/assemble_engine.cpp);
  * read mapping: native engine vs DBG_PY_MAP=1 (scaffold/index.py,
    native/map_engine.cpp).
"""

import os

import numpy as np
import pytest

from dbg_assembly import dna
from dbg_assembly.contig import graph as G
from dbg_assembly.contig.refassemble import AssembleParams, RefAssembler

K = 15


def _random_reads(n, L, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, L), dtype=np.uint8)
    lengths = rng.integers(K, L + 1, n).astype(np.int32)
    # duplicate some reads so k-mer multiplicities exceed 1
    codes[n // 2:] = codes[: n - n // 2]
    return codes, lengths


def _table_fingerprint(t: G.NodeTable):
    return (t.kmers.tobytes(), t.lcnt.tobytes(), t.rcnt.tobytes(),
            t.first_idx.tobytes(), t.total_reads)


def test_aggregate_batch_jax_np_native_agree():
    import jax.numpy as jnp
    codes, lengths = _random_reads(300, 80, seed=11)

    uj, lj, rj, fj, cj, n_uniq, n_valid = G._aggregate_batch(
        jnp.asarray(codes), jnp.asarray(lengths), K, jnp.int64(0))
    # round-4 contract: records masked at sorted positions; compacting by
    # mask must yield exactly n_unique rows in ascending k-mer order
    uj = np.asarray(uj)
    keep = uj != G.SENTINEL
    assert keep.sum() == int(n_uniq)
    uj = uj[keep]
    lj = np.asarray(lj)[keep]
    rj = np.asarray(rj)[keep]
    fj = np.asarray(fj)[keep]
    cj = np.asarray(cj)[keep]

    (un, ln, rn, fn, cn,
     n_valid_np) = G._aggregate_batch_np(codes, lengths, K, 0)

    from dbg_assembly import native
    ni = native.NativeIngest(K)
    ni.add(codes, lengths, 0)
    uk, lk, rk, fk, total = ni.extract()
    ni.close()

    assert int(n_valid) == n_valid_np == total
    np.testing.assert_array_equal(uj, un)
    np.testing.assert_array_equal(uj, uk)
    np.testing.assert_array_equal(lj, ln)
    np.testing.assert_array_equal(lj, lk)
    np.testing.assert_array_equal(rj, rn)
    np.testing.assert_array_equal(rj, rk)
    np.testing.assert_array_equal(fj, fn)
    np.testing.assert_array_equal(fj, fk)
    np.testing.assert_array_equal(cj, cn)
    assert int(cj.sum()) == total


@pytest.mark.parametrize("env", ["native", "DBG_PY_INGEST"])
def test_graph_builder_paths_agree(env, monkeypatch):
    """GraphBuilder through the native table and the pure-python path."""
    codes, lengths = _random_reads(500, 100, seed=5)
    if env != "native":
        monkeypatch.setenv(env, "1")
    gb = G.GraphBuilder(K, max_read_len=100, batch_reads=128)
    gb.add(codes, lengths)
    t = gb.finalize()

    monkeypatch.delenv("DBG_PY_INGEST", raising=False)
    gb2 = G.GraphBuilder(K, max_read_len=100, batch_reads=128)
    gb2.add(codes, lengths)
    ref = gb2.finalize()
    assert _table_fingerprint(t) == _table_fingerprint(ref)


def _reads_from_genome(genome: bytes, L: int, step: int):
    reads = [genome[i:i + L] for i in range(0, len(genome) - L, step)]
    codes = np.zeros((len(reads), L), np.uint8)
    for i, r in enumerate(reads):
        codes[i] = dna.ascii_to_codes(np.frombuffer(r, np.uint8))
    return codes, np.full(len(reads), L, np.int32)


def test_assemble_native_vs_python_artifacts(tmp_path, monkeypatch):
    rng = np.random.default_rng(77)
    genome = bytes(bytearray(b"ACGT"[c] for c in rng.integers(0, 4, 3000)))
    codes, lengths = _reads_from_genome(genome, 60, 7)
    gb = G.GraphBuilder(K)
    gb.add(codes, lengths)
    table = gb.finalize()
    params = AssembleParams(ksize=K, init_hash_size=0.0001,
                            contig_len_cutoff=50)

    monkeypatch.delenv("DBG_PY_ASSEMBLE", raising=False)
    RefAssembler(table, params).run(str(tmp_path / "nat"))
    monkeypatch.setenv("DBG_PY_ASSEMBLE", "1")
    RefAssembler(table, params).run(str(tmp_path / "py"))

    for suffix in (".contig.seq.fa", ".contig.seq.depth", ".contig.small.fa",
                   ".contig.small.depth", ".contig.kmer.freq",
                   ".contig.tip.fa", ".contig.lowedge.fa",
                   ".contig.bubble.fa"):
        a = open(str(tmp_path / "nat") + suffix, "rb").read()
        b = open(str(tmp_path / "py") + suffix, "rb").read()
        assert a == b, f"artifact mismatch: {suffix}"


def test_map_native_vs_python(monkeypatch):
    from dbg_assembly.scaffold import index as ix
    rng = np.random.default_rng(9)
    contigs = [bytes(bytearray(b"ACGT"[c]
                               for c in rng.integers(0, 4, n)))
               for n in (400, 300, 250)]
    kmap = 17
    # reads sampled from contigs with a couple of mismatches
    reads = []
    for _ in range(60):
        c = contigs[rng.integers(0, len(contigs))]
        s = rng.integers(0, len(c) - 100)
        r = bytearray(c[s:s + 100])
        for _ in range(rng.integers(0, 3)):
            p = rng.integers(0, 100)
            r[p] = ord("ACGT"[rng.integers(0, 4)])
        if rng.integers(0, 2):
            r = r[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))
        reads.append(bytes(r))
    ascii_seq = np.frombuffer(b"".join(reads), np.uint8).reshape(len(reads),
                                                                 100)
    codes = np.zeros_like(ascii_seq)
    for i in range(len(reads)):
        codes[i] = dna.ascii_to_codes(ascii_seq[i])
    lengths = np.full(len(reads), 100, np.int32)

    monkeypatch.delenv("DBG_PY_MAP", raising=False)
    monkeypatch.delenv("DBG_JAX_MAP", raising=False)
    nat = ix.map_reads(ix.build(contigs, kmap), codes, ascii_seq, lengths,
                       seed_kmer_num=10, min_identity=0.95)
    monkeypatch.setenv("DBG_PY_MAP", "1")
    py = ix.map_reads(ix.build(contigs, kmap), codes, ascii_seq, lengths,
                      seed_kmer_num=10, min_identity=0.95)
    monkeypatch.delenv("DBG_PY_MAP", raising=False)
    monkeypatch.setenv("DBG_JAX_MAP", "1")
    jx = ix.map_reads(ix.build(contigs, kmap), codes, ascii_seq, lengths,
                      seed_kmer_num=10, min_identity=0.95)

    for other, name in ((py, "python"), (jx, "jax")):
        np.testing.assert_array_equal(nat.mapped, other.mapped,
                                      err_msg=f"mapped [{name}]")
        m = nat.mapped
        for field in ("contig", "read_start", "read_end", "contig_start",
                      "contig_end", "direct", "identity"):
            np.testing.assert_array_equal(
                getattr(nat, field)[m], getattr(other, field)[m],
                err_msg=f"{field} [{name}]")


def test_assemble_native_raises_on_unwritable_prefix(tmp_path, monkeypatch):
    monkeypatch.delenv("DBG_PY_ASSEMBLE", raising=False)
    codes, lengths = _random_reads(100, 60, seed=2)
    gb = G.GraphBuilder(K)
    gb.add(codes, lengths)
    table = gb.finalize()
    params = AssembleParams(ksize=K, init_hash_size=0.0001,
                            contig_len_cutoff=50)
    bad_prefix = str(tmp_path / "no" / "such" / "dir" / "x")
    with pytest.raises(OSError):
        RefAssembler(table, params).run(bad_prefix)
