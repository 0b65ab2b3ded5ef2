import numpy as np
import jax

from dbg_assembly.parallel import mesh as meshmod
from dbg_assembly.parallel import count_sharded
from dbg_assembly.kmer import count as kc


def test_sharded_count_matches_single_device():
    rng = np.random.default_rng(0)
    k = 15
    N, L = 512, 64
    codes = rng.integers(0, 4, size=(N, L)).astype(np.uint8)
    lengths = rng.integers(k, L + 1, size=N).astype(np.int32)

    m = meshmod.data_mesh(8)
    cs, ls = meshmod.shard_batch(m, codes, lengths)
    P = L - k + 1
    capacity = (N // 8) * P // 8 * 2 + 64
    uniq, counts, n_unique, stats = count_sharded.count_step(
        cs, ls, ksize=k, mesh=m, capacity=capacity)

    ref_u, ref_c, ref_total = kc.count_batch(codes, lengths, k)
    assert int(stats["dropped"]) == 0
    assert int(stats["total_kmers"]) == ref_total
    assert int(stats["unique_kmers"]) == len(ref_u)

    # merge per-device runs and compare against the single-device counter
    got = {}
    un = np.asarray(uniq)
    cn = np.asarray(counts)
    nu = np.asarray(n_unique)
    SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
    for d in range(un.shape[0]):
        keep = un[d] != SENT          # records masked at sorted positions
        assert keep.sum() == int(nu[d])
        for u, c in zip(un[d][keep], cn[d][keep]):
            got[int(u)] = int(c)
    assert got == dict(zip(ref_u.tolist(), ref_c.tolist()))

    # ownership: every kmer on device d must satisfy kmer % 8 == d
    for d in range(un.shape[0]):
        vals = un[d][un[d] != SENT]
        assert np.all(vals % 8 == d)


def test_skewed_input_overflows_then_counts_exactly():
    """Production drop policy: a batch whose k-mers all
    land on one owner shard overflows the default bucket capacity; the
    exact wrapper must double capacity and still return exact counts."""
    k = 15
    N, L = 512, 64
    # every read is the same homopolymer-free 2-periodic sequence -> only a
    # couple of distinct k-mer species -> worst-case owner skew
    codes = np.tile(np.array([0, 1], np.uint8), (N, L // 2))
    lengths = np.full(N, L, np.int32)

    m = meshmod.data_mesh(8)
    cs, ls = meshmod.shard_batch(m, codes, lengths)

    # the plain step at default capacity must drop (precondition for the test)
    cap0 = count_sharded.default_capacity(N, L, k, 8)
    _, _, _, stats0 = count_sharded.count_step(
        cs, ls, ksize=k, mesh=m, capacity=cap0)
    assert int(stats0["dropped"]) > 0

    uniq, counts, n_unique, stats = count_sharded.count_step_exact(
        cs, ls, ksize=k, mesh=m)
    assert int(stats["dropped"]) == 0
    assert stats["capacity_doublings"] >= 1

    ref_u, ref_c, ref_total = kc.count_batch(codes, lengths, k)
    assert int(stats["total_kmers"]) == ref_total
    got = {}
    un, cn, nu = np.asarray(uniq), np.asarray(counts), np.asarray(n_unique)
    SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
    for d in range(un.shape[0]):
        keep = un[d] != SENT
        assert keep.sum() == int(nu[d])
        for u, c in zip(un[d][keep], cn[d][keep]):
            got[int(u)] = int(c)
    assert got == dict(zip(ref_u.tolist(), ref_c.tolist()))


def test_skewed_ingest_exact_edges():
    k = 15
    N, L = 256, 64
    codes = np.tile(np.array([0, 1, 2], np.uint8), (N, -(-L // 3)))[:, :L] \
        .astype(np.uint8).copy()
    lengths = np.full(N, L, np.int32)
    m = meshmod.data_mesh(8)
    cs, ls = meshmod.shard_batch(m, codes, lengths)
    uniq, lcnt, rcnt, first_idx, counts, n_unique, stats = \
        count_sharded.graph_ingest_step_exact(cs, ls, ksize=k, mesh=m)
    assert int(stats["dropped"]) == 0
    from dbg_assembly.contig.graph import GraphBuilder
    gb = GraphBuilder(k)
    gb.add(codes, lengths)
    ref = gb.finalize()
    got_edges = {}
    un, ln_, rn = np.asarray(uniq), np.asarray(lcnt), np.asarray(rcnt)
    nu = np.asarray(n_unique)
    SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
    for d in range(un.shape[0]):
        keep = np.flatnonzero(un[d] != SENT)
        assert len(keep) == int(nu[d])
        for i in keep:
            # raw step outputs are unsaturated; NodeTable-level
            # saturation (min 255) applies at GraphBuilder.finalize
            got_edges[int(un[d, i])] = (
                np.minimum(ln_[d, i], 255).tolist(),
                np.minimum(rn[d, i], 255).tolist())
    ref_edges = {int(u): (l.tolist(), r.tolist())
                 for u, l, r in zip(ref.kmers, ref.lcnt, ref.rcnt)}
    assert got_edges == ref_edges
