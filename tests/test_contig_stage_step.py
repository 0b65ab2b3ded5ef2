"""contig_stage_step (the bench's device contig-stage kernel) must agree
with the host _Graph path: links, linear flags, and chain resolution."""
import os
import sys

import numpy as np
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dbg_assembly.contig import pointer_doubling as pd
from dbg_assembly.contig.graph import GraphBuilder
from dbg_assembly.contig.refassemble import AssembleParams


def test_contig_stage_step_matches_host():
    rng = np.random.default_rng(2)
    genome = rng.integers(0, 4, 5000).astype(np.uint8)
    starts = rng.integers(0, 5000 - 80, 600)
    codes = np.stack([genome[s:s + 80] for s in starts]).astype(np.uint8)
    lengths = np.full(600, 80, np.int32)
    gb = GraphBuilder(21)
    gb.add(codes, lengths)
    t = gb.finalize()
    params = AssembleParams(ksize=21, init_hash_size=0.0001)
    g = pd._Graph(t, params)
    g.calc_links()
    M = g.M
    l_num, r_num, linear, e, dist, cyc = pd.contig_stage_step(
        jnp.asarray(g.kmers), jnp.asarray(g.lcnt[:M]),
        jnp.asarray(g.rcnt[:M]), k=21, cut=params.kmer_freq_cutoff)
    np.testing.assert_array_equal(np.asarray(l_num), g.l_num[:M])
    np.testing.assert_array_equal(np.asarray(r_num), g.r_num[:M])
    np.testing.assert_array_equal(np.asarray(linear), g.linear[:M])

    # successor/chain agreement vs the host construction (read_out path)
    alive = (~g.deleted[:M]) & g.linear[:M]
    node = np.repeat(np.arange(M, dtype=np.int64), 2)
    sdir = np.tile(np.array([1, -1], np.int64), M)
    base = np.where(sdir == 1, g.r_base[node], g.l_base[node])
    nf, ndir = g.next_ids(node, sdir, base)
    nxt = g.locate(nf)
    ok = alive[node] & (nxt != M) & g.linear[np.minimum(nxt, M)]
    succ_host = np.where(ok, 2 * nxt + (ndir == -1).astype(np.int64),
                         2 * M)
    eh, dh, ch = g.resolve_chains(succ_host)
    d_k = np.asarray(dist)
    c_k = np.asarray(cyc)
    # kernel layout: [right states 0..M) ++ [left states M..2M); host
    # interleaves (2i, 2i+1)
    d_inter = np.empty(2 * M, np.int64)
    d_inter[0::2] = d_k[:M]
    d_inter[1::2] = d_k[M:]
    c_inter = np.empty(2 * M, bool)
    c_inter[0::2] = c_k[:M]
    c_inter[1::2] = c_k[M:]
    live = alive[node]
    np.testing.assert_array_equal(d_inter[live], dh[live])
    np.testing.assert_array_equal(c_inter[live], ch[live])
    assert live.sum() > 1000


def test_native_succ_build_matches_xla_twin():
    from dbg_assembly import native
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    starts = rng.integers(0, 3000 - 60, 400)
    codes = np.stack([genome[s:s + 60] for s in starts]).astype(np.uint8)
    lengths = np.full(400, 60, np.int32)
    gb = GraphBuilder(17)
    gb.add(codes, lengths)
    t = gb.finalize()
    g = pd._Graph(t, AssembleParams(ksize=17, init_hash_size=0.0001))
    g.calc_links()
    M = g.M
    alive = (~g.deleted[:M]) & g.linear[:M]
    succ_native = native.succ_build(g.kmers, g.l_base[:M], g.r_base[:M],
                                    alive.astype(np.uint8), 17)
    succ_xla, e, dist, cyc = (np.asarray(x) for x in pd._succ_resolve(
        jnp.asarray(g.kmers), jnp.asarray(g.l_base[:M]),
        jnp.asarray(g.r_base[:M]), jnp.asarray(alive), k=17))
    np.testing.assert_array_equal(succ_native, succ_xla)
    assert (succ_native < 2 * M).sum() > 500    # real chains exist


def test_native_resolve_chains_matches_xla():
    """Fuzz resolve_chains_host against the XLA doubling program on
    random functional graphs (chains, merges, cycles, rho shapes):
    exact (e, dist) on non-cyclic states, cyclic flag everywhere."""
    from dbg_assembly import native
    rng = np.random.default_rng(7)
    for trial in range(6):
        n = int(rng.integers(3, 2000))
        succ = rng.integers(0, n + 1, n).astype(np.int64)
        # bias toward chain-like structure on even trials
        if trial % 2 == 0:
            perm = rng.permutation(n)
            succ = np.where(rng.random(n) < 0.9,
                            np.roll(perm, 1), succ).astype(np.int64)
        en, dn, cn = native.resolve_chains_host(succ)
        ex, dx, cx = (np.asarray(v) for v in
                      pd._resolve_chains(jnp.asarray(succ)))
        np.testing.assert_array_equal(cn, cx)
        ok = ~cx
        np.testing.assert_array_equal(en[ok], ex[ok])
        np.testing.assert_array_equal(dn[ok], dx[ok])


def test_native_resolve_chains_on_real_graph():
    from dbg_assembly import native
    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    starts = rng.integers(0, 3000 - 60, 400)
    codes = np.stack([genome[s:s + 60] for s in starts]).astype(np.uint8)
    lengths = np.full(400, 60, np.int32)
    gb = GraphBuilder(17)
    gb.add(codes, lengths)
    t = gb.finalize()
    g = pd._Graph(t, AssembleParams(ksize=17, init_hash_size=0.0001))
    g.calc_links()
    M = g.M
    alive = (~g.deleted[:M]) & g.linear[:M]
    succ = native.succ_build(g.kmers, g.l_base[:M], g.r_base[:M],
                             alive.astype(np.uint8), 17)
    en, dn, cn = native.resolve_chains_host(succ)
    ex, dx, cx = g.resolve_chains(succ)
    np.testing.assert_array_equal(cn, cx)
    ok = ~cx
    np.testing.assert_array_equal(en[ok], ex[ok])
    np.testing.assert_array_equal(dn[ok], dx[ok])
    assert ok.sum() > 500


def test_native_collect_heads_matches_numpy():
    from dbg_assembly import native
    rng = np.random.default_rng(11)
    for _ in range(5):
        M = int(rng.integers(4, 800))
        n = 2 * M
        alive = rng.random(M) < 0.8
        succ = rng.integers(0, n + 1, n).astype(np.int64)
        node = np.repeat(np.arange(M, dtype=np.int64), 2)
        succ[~alive[node]] = n
        _, _, cyc = native.resolve_chains_host(succ)
        hn, fbn = native.collect_heads(alive.astype(np.uint8), succ,
                                       cyc.astype(np.uint8))
        is_state = alive[node]
        rev = np.arange(n, dtype=np.int64) ^ 1
        heads = is_state & ~cyc & (succ[rev] >= n) & ~cyc[rev]
        np.testing.assert_array_equal(hn, np.flatnonzero(heads))
        assert set(fbn.tolist()) == set(node[cyc & is_state].tolist())
        assert len(set(fbn.tolist())) == len(fbn)
