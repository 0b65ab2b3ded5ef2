"""Mesh-sharded contig stage: pruning + pointer-doubling over the sharded
node table (SURVEY.md section 5 long-context item 1).

The reference prunes and reads out contigs by serial hash-pointer chasing
on one host (DBG_contig/contig.cpp:832-896); the scalable single-device
path (pointer_doubling.py) replaced the walks with bulk array programs.
This module distributes those bulk programs over a jax Mesh:

  * table residency — the sorted node table is sharded by k-mer ownership
    (owner = kmer mod D, the same ownership rule as the distributed ingest,
    parallel/count_sharded.py), each shard holding its sorted slice plus
    the rows' global (sorted-table) indices;
  * table search (the bulk analog of exist_kmerset probing,
    kmerSet.cpp:280-302) — the embedding-table collective pattern proven
    in correct/sharded.py: all_gather the query batch, every shard answers
    the k-mers it owns (a local searchsorted), psum_scatter returns each
    device its answer slice.  Per-call traffic is O(queries * D) int64s;
    the table never moves;
  * link/topology pass (calculate_kmer_links, contig.cpp:107-205) — a
    purely local shard_map pass over the sharded counters, histogram
    psum'd;
  * chain resolution — pointer doubling over the sharded successor array:
    each of the O(log n) rounds all_gathers the jump table and advances
    the local block (traffic n*16B per device per round; a
    hierarchically-blocked exchange could cut this to the boundary set,
    noted as future work).

Division of labor (and honest scaling story): the DEVICE mesh executes
every O(M) bulk phase — search, link calc, successor build (read_out's
locate over all 2M directed states routes through the sharded search),
chain resolution.  The HOST keeps the O(M) mutable flag mirrors
(deleted/linear, 1 byte each) and runs the O(candidates) pruning decision
replay (tips/bubbles are ~1e1..1e3 per genome), answering that replay's
few-k-mer probes from its own sorted copy of the table, plus final sequence
assembly — the contig OUTPUT is O(genome) host bytes regardless.  Byte
parity: MeshGraph overrides only HOW bulk steps execute, never a decision,
so artifacts are byte-identical to the single-device doubling path
(tests/test_mesh_assemble.py asserts this on an 8-device CPU mesh).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .graph import NodeTable
from .pointer_doubling import _Graph
from .refassemble import AssembleParams

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


# =========================================================================
# sharded programs
# =========================================================================

@functools.partial(jax.jit, static_argnames=("mesh",))
def _search_sharded(km_sh, gid_sh, queries, *, mesh):
    """Collective table search: queries [Q] u64 -> global row index or -1.

    km_sh/gid_sh: [D, S] per-shard sorted k-mers (SENTINEL-padded) and
    their global sorted-table indices (-1 at pads).  queries are sharded
    on 'd'; SENTINEL query slots (padding) return -1.
    """
    def body(km, gid, q):
        km, gid = km[0], gid[0]
        allq = jax.lax.all_gather(q, "d", tiled=True)          # [Q]
        idx = jnp.searchsorted(km, allq)
        idx = jnp.minimum(idx, km.shape[0] - 1)
        found = (km[idx] == allq) & (allq != SENTINEL)
        ans = jnp.where(found, gid[idx] + 1, 0)
        out = jax.lax.psum_scatter(ans, "d", scatter_dimension=0,
                                   tiled=True)
        return out - 1

    return shard_map(body, mesh=mesh,
                     in_specs=(P("d", None), P("d", None), P("d")),
                     out_specs=P("d"))(km_sh, gid_sh, queries)


@functools.partial(jax.jit, static_argnames=("mesh", "cut"))
def _links_sharded(lcnt_sh, rcnt_sh, *, mesh, cut: int):
    """calculate_kmer_links' counter math per shard + psum'd histogram."""

    def one_side(c):
        q = c > cut
        num = jnp.minimum(jnp.sum(q, axis=1), 3).astype(jnp.int32)
        base = jnp.argmax(jnp.where(q, c, 0), axis=1).astype(jnp.int32)
        return num, base

    def hist256(v):
        # integer scatter-add: exact in any update order, and O(len(v))
        # memory where a broadcast compare against the 256 bins
        # materializes [len(v), 256] on backends that do not fuse it
        # (stats.histogram_small's lax.scan carry is replicated and trips
        # shard_map's varying-axes check); counters are saturated to 255
        return jnp.zeros((256,), jnp.int64).at[v].add(1, mode="drop")

    def body(l, r):
        l, r = l[0], r[0]
        l_num, l_base = one_side(l)
        r_num, r_base = one_side(r)
        hist = hist256(l.reshape(-1)) + hist256(r.reshape(-1))
        hist = jax.lax.psum(hist, "d")
        return (l_num[None], r_num[None], l_base[None], r_base[None],
                hist[None])

    return shard_map(body, mesh=mesh,
                     in_specs=(P("d", None, None), P("d", None, None)),
                     out_specs=(P("d", None), P("d", None), P("d", None),
                                P("d", None), P("d", None)))(lcnt_sh,
                                                             rcnt_sh)


@functools.partial(jax.jit, static_argnames=("mesh", "n_real", "rounds"))
def _resolve_sharded(succ, *, mesh, n_real: int, rounds: int):
    """Pointer doubling over a 'd'-sharded successor array.

    succ: [n_pad] int64 (STOP encoded as n_real; pad slots hold n_real).
    Each round all_gathers the (e, r) jump tables and advances the local
    block — no data-dependent cross-device gathers, only dense
    collectives.  Returns (end, dist, cyclic) as in
    pointer_doubling._resolve_chains."""
    n_pad = succ.shape[0]

    def body(s):
        s = s
        dev = jax.lax.axis_index("d").astype(jnp.int64)
        B = s.shape[0]
        my_idx = dev * B + jnp.arange(B, dtype=jnp.int64)
        stop = s >= n_real
        e = jnp.where(stop, my_idx, s)
        r = jnp.where(stop, jnp.int64(0), jnp.int64(1))

        def rnd(_, st):
            e, r = st
            eg = jax.lax.all_gather(e, "d", tiled=True)        # [n_pad]
            rg = jax.lax.all_gather(r, "d", tiled=True)
            return eg[e], r + rg[e]

        e, r = jax.lax.fori_loop(0, rounds, rnd, (e, r))
        sg = jax.lax.all_gather(s, "d", tiled=True)
        cyclic = sg[jnp.minimum(e, n_pad - 1)] < n_real
        return e, r + 1, cyclic

    return shard_map(body, mesh=mesh, in_specs=(P("d"),),
                     out_specs=(P("d"), P("d"), P("d")))(succ)


# =========================================================================
# MeshGraph
# =========================================================================

class MeshGraph(_Graph):
    """_Graph whose O(M) bulk phases execute on a device mesh.

    Overrides: _search (sharded collective table probe), _links_bulk
    (sharded counter pass), resolve_chains (sharded pointer doubling).
    Every pruning/readout DECISION inherits unchanged, so outputs are
    byte-identical to the single-device doubling path."""

    # searches of at most this many k-mers stay on the host (see _search)
    host_search_max = 4096

    def __init__(self, table: NodeTable, params: AssembleParams,
                 mesh: Mesh, axis: str = "d"):
        super().__init__(table, params)
        self.mesh = mesh
        self.axis = axis
        D = mesh.shape[axis]
        self._D = D
        kmers = self.kmers                      # [M] sorted (incl. poly-A)
        owner = (kmers % np.uint64(D)).astype(np.int64)
        order = np.argsort(owner, kind="stable")   # per-owner, still sorted
        counts = np.bincount(owner, minlength=D)
        S = max(int(counts.max()), 1)
        km_sh = np.full((D, S), SENTINEL, np.uint64)
        gid_sh = np.full((D, S), -1, np.int64)
        lcnt_sh = np.zeros((D, S, 4), np.int32)
        rcnt_sh = np.zeros((D, S, 4), np.int32)
        off = 0
        for d in range(D):
            c = int(counts[d])
            rows = order[off:off + c]
            km_sh[d, :c] = kmers[rows]
            gid_sh[d, :c] = rows
            lcnt_sh[d, :c] = self.lcnt[rows]
            rcnt_sh[d, :c] = self.rcnt[rows]
            off += c
        row = NamedSharding(mesh, P(axis, None))
        self._km_sh = jax.device_put(km_sh, row)
        self._gid_sh = jax.device_put(gid_sh, row)
        self._lcnt_sh = jax.device_put(
            lcnt_sh, NamedSharding(mesh, P(axis, None, None)))
        self._rcnt_sh = jax.device_put(
            rcnt_sh, NamedSharding(mesh, P(axis, None, None)))
        self._gid_np = gid_sh
        self._S = S

    # -------------------------------------------------------- bulk hooks
    def _search(self, nf: np.ndarray) -> np.ndarray:
        Q = len(nf)
        if Q == 0:
            return np.zeros(0, np.int64)
        if Q <= self.host_search_max:
            # the pruning walks and the readout's per-chain boundary probes
            # ask for a handful of k-mers at a time, tens of thousands of
            # times per genome: a fixed-cost collective round trip each
            # would dominate the stage, and the host holds the same sorted
            # table, so the answer is the same
            return super()._search(nf)
        # pad to the least power-of-FOUR multiple of D that holds Q: at
        # most log4(Q_max/D)+1 shapes ever compile, and a one-k-mer probe
        # (the readout's per-chain boundary lookups) moves D*4 queries,
        # not the padded size of the largest search so far
        Qp = self._D
        while Qp < Q:
            Qp *= 4
        qp = np.full(Qp, SENTINEL, np.uint64)
        qp[:Q] = np.asarray(nf, np.uint64)
        q = jax.device_put(qp, NamedSharding(self.mesh, P(self.axis)))
        out = _search_sharded(self._km_sh, self._gid_sh, q, mesh=self.mesh)
        return np.asarray(out)[:Q]

    def _links_bulk(self):
        M = self.M
        l_num_s, r_num_s, l_base_s, r_base_s, hist = _links_sharded(
            self._lcnt_sh, self._rcnt_sh, mesh=self.mesh,
            cut=int(self.p.kmer_freq_cutoff))
        gid = self._gid_np.reshape(-1)
        keep = gid >= 0
        dst = gid[keep]
        l_num = np.zeros(M, np.int32)
        r_num = np.zeros(M, np.int32)
        l_base = np.zeros(M, np.int32)
        r_base = np.zeros(M, np.int32)
        l_num[dst] = np.asarray(l_num_s).reshape(-1)[keep]
        r_num[dst] = np.asarray(r_num_s).reshape(-1)[keep]
        l_base[dst] = np.asarray(l_base_s).reshape(-1)[keep]
        r_base[dst] = np.asarray(r_base_s).reshape(-1)[keep]
        # histogram counted every PAD row's zero counters too (8 zero-bin
        # hits per pad row); the reference histogram starts at depth 1, and
        # write_kmer_freq never emits bin 0, so pads are invisible — but
        # keep the host-identical value anyway for the stats mirror
        depth_stat = np.asarray(hist)[0].copy()
        n_pads = int((~keep).sum())
        depth_stat[0] -= 8 * n_pads
        return l_num, r_num, l_base, r_base, depth_stat

    def resolve_chains(self, succ: np.ndarray):
        n_real = len(succ)
        D = self._D
        n_pad = -(-n_real // D) * D
        sp = np.full(n_pad, n_real, np.int64)
        sp[:n_real] = succ
        rounds = int(np.ceil(np.log2(max(n_real, 2)))) + 1
        s = jax.device_put(sp, NamedSharding(self.mesh, P(self.axis)))
        e, dist, cyc = _resolve_sharded(s, mesh=self.mesh, n_real=n_real,
                                        rounds=rounds)
        return (np.asarray(e)[:n_real], np.asarray(dist)[:n_real],
                np.asarray(cyc)[:n_real])


def assemble_doubling_mesh(table: NodeTable, params: AssembleParams,
                           prefix: str, mesh: Mesh):
    """assemble_doubling with the bulk phases on a device mesh
    (links -> tips -> lowedges -> bubbles -> doubling readout, phase order
    per contig.cpp:54-102).  Byte-identical artifacts to the single-device
    scalable path."""
    from . import pointer_doubling as pd
    g = MeshGraph(table, params, mesh)
    g.calc_links()
    g.write_kmer_freq(prefix + ".contig.kmer.freq")
    if params.is_remove_tip:
        pd.remove_tips(g, prefix + ".contig.tip.fa")
    if params.is_remove_lowedge:
        pd.remove_lowedges(g, prefix + ".contig.lowedge.fa")
    if params.is_remove_bubble:
        pd.remove_bubbles(g, prefix + ".contig.bubble.fa")
    pd.read_out_contigs(g, prefix)
    return g.stats
