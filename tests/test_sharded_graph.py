import numpy as np

from dbg_assembly.parallel import mesh as meshmod
from dbg_assembly.parallel import count_sharded
from dbg_assembly.contig.graph import GraphBuilder


def test_distributed_graph_ingest_matches_single_device():
    rng = np.random.default_rng(0)
    k = 13
    N, L = 512, 80
    codes = rng.integers(0, 4, size=(N, L)).astype(np.uint8)
    lengths = rng.integers(k, L + 1, size=N).astype(np.int32)

    gb = GraphBuilder(k, max_read_len=250)
    gb.add(codes, lengths)
    table = gb.finalize()

    m = meshmod.data_mesh(8)
    cs, ls = meshmod.shard_batch(m, codes, lengths)
    P = L - k + 1
    capacity = (N // 8) * P // 8 * 2 + 64
    uniq, lcnt, rcnt, first_idx, counts, n_unique, stats = \
        count_sharded.graph_ingest_step(
            cs, ls, 0, ksize=k, mesh=m, capacity=capacity)

    assert int(stats["dropped"]) == 0
    assert int(stats["total_kmers"]) == table.total_kmers
    assert int(stats["unique_kmers"]) == table.n_nodes

    got = {}
    un = np.asarray(uniq)
    lc = np.asarray(lcnt)
    rc = np.asarray(rcnt)
    nu = np.asarray(n_unique)
    SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
    for d in range(un.shape[0]):
        keep = np.flatnonzero(un[d] != SENT)
        assert len(keep) == int(nu[d])
        for i in keep:
            got[int(un[d, i])] = (tuple(lc[d, i]), tuple(rc[d, i]))
    want = {int(table.kmers[i]): (tuple(table.lcnt[i]), tuple(table.rcnt[i]))
            for i in range(table.n_nodes)}
    assert got == want


def test_graphbuilder_mesh_mode_bit_identical():
    """GraphBuilder(mesh=...) — the production distributed ingest path —
    must finalize a NodeTable bit-identical to the single-device builder,
    INCLUDING first-occurrence stream positions (the field that shapes the
    reference hash-order emulation), across multiple streamed batches."""
    rng = np.random.default_rng(3)
    k = 13
    N, L = 600, 72
    codes = rng.integers(0, 4, size=(N, L)).astype(np.uint8)
    lengths = rng.integers(k, L + 1, size=N).astype(np.int32)

    gb1 = GraphBuilder(k, max_read_len=250, batch_reads=130)
    gb2 = GraphBuilder(k, max_read_len=250, batch_reads=130,
                       mesh=meshmod.data_mesh(8))
    for off in range(0, N, 200):   # stream in uneven slices
        gb1.add(codes[off:off + 200], lengths[off:off + 200])
        gb2.add(codes[off:off + 200], lengths[off:off + 200])
    t1 = gb1.finalize()
    t2 = gb2.finalize()

    assert np.array_equal(t1.kmers, t2.kmers)
    assert np.array_equal(t1.lcnt, t2.lcnt)
    assert np.array_equal(t1.rcnt, t2.rcnt)
    assert np.array_equal(t1.first_idx, t2.first_idx)
    assert t1.total_kmers == t2.total_kmers
    assert t1.total_reads == t2.total_reads
