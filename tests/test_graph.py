import numpy as np

from dbg_assembly import dna
from dbg_assembly.contig import graph


def naive_table(codes, lengths, k, max_read_len=250):
    """Oracle mirroring DBGgraph.cpp:38-120 semantics."""
    nodes = {}
    order = []
    stream = 0
    for i in range(len(codes)):
        L = min(int(lengths[i]), max_read_len)
        if L < k:
            continue
        for j in range(L - k + 1):
            kb = int(dna.seq2bit(codes[i, j:j + k]))
            rc = int(dna.revcomp_kbit(np.uint64(kb), k))
            if kb <= rc:
                can = kb
                left = int(codes[i, j - 1]) if j > 0 else 4
                right = int(codes[i, j + k]) if j < L - k else 4
            else:
                can = rc
                right = 3 - int(codes[i, j - 1]) if j > 0 else 4
                left = 3 - int(codes[i, j + k]) if j < L - k else 4
            if can not in nodes:
                nodes[can] = [np.zeros(4, int), np.zeros(4, int), stream]
                order.append(can)
            if left != 4:
                nodes[can][0][left] += 1
            if right != 4:
                nodes[can][1][right] += 1
            stream += 1
    return nodes


def test_graph_builder_matches_oracle():
    rng = np.random.default_rng(0)
    k = 11
    N, L = 60, 50
    codes = rng.integers(0, 4, size=(N, L)).astype(np.uint8)
    lengths = rng.integers(5, L + 1, size=N).astype(np.int32)

    gb = graph.GraphBuilder(k, max_read_len=250, batch_reads=16)
    gb.add(codes, lengths)
    t = gb.finalize()
    oracle = naive_table(codes, lengths, k)

    assert t.n_nodes == len(oracle)
    for i in range(t.n_nodes):
        can = int(t.kmers[i])
        assert can in oracle
        assert np.array_equal(t.lcnt[i], oracle[can][0]), (i, can)
        assert np.array_equal(t.rcnt[i], oracle[can][1]), (i, can)

    # first-occurrence order must match the oracle's insertion order
    ins_order = [int(x) for x in
                 t.kmers[np.argsort(t.first_idx, kind="stable")]]
    oracle_order = sorted(oracle, key=lambda c: oracle[c][2])
    assert ins_order == oracle_order


def test_graph_builder_respects_max_read_len():
    rng = np.random.default_rng(1)
    k = 7
    codes = rng.integers(0, 4, size=(10, 40)).astype(np.uint8)
    lengths = np.full(10, 40, np.int32)
    gb = graph.GraphBuilder(k, max_read_len=20)
    gb.add(codes, lengths)
    t = gb.finalize()
    oracle = naive_table(codes, lengths, k, max_read_len=20)
    assert t.n_nodes == len(oracle)
    assert t.total_kmers == 10 * (20 - k + 1)


def test_edge_counter_saturation_matches_reference_semantics():
    """Edge counters saturate at 255 (the reference's 8-bit BitAddVal adds,
    kmerSet.cpp:341); occurrence counts stay exact.  All ingest paths must
    agree on the saturated values."""
    import numpy as np
    from dbg_assembly.contig.graph import GraphBuilder

    k = 13
    read = np.tile(np.array([0, 1, 2, 3, 1, 0, 3, 2], np.uint8), 8)[:60]
    codes = np.tile(read, (400, 1))          # one read x400 -> counts 400
    lengths = np.full(400, 60, np.int32)

    gb_native = GraphBuilder(k)              # CPU backend -> native engine
    gb_native.add(codes, lengths)
    t1 = gb_native.finalize()

    import os
    os.environ["DBG_PY_INGEST"] = "1"
    try:
        gb_np = GraphBuilder(k)              # numpy aggregate path
        gb_np.add(codes, lengths)
        t2 = gb_np.finalize()
    finally:
        del os.environ["DBG_PY_INGEST"]

    assert t1.lcnt.max() == 255 and t1.lcnt.max() <= 255
    assert np.array_equal(t1.kmers, t2.kmers)
    assert np.array_equal(t1.lcnt, t2.lcnt)
    assert np.array_equal(t1.rcnt, t2.rcnt)
    assert np.array_equal(t1.counts, t2.counts)
    # the periodic read yields 12 occurrences per species per read
    assert t1.counts.max() == 4800           # occurrence counts exact
