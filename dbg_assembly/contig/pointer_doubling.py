"""Production scalable contig pipeline: bulk pruning + pointer-doubling readout.

The reference extracts contigs by serially chasing hash pointers one node at
a time (DBG_contig/contig.cpp:832-896) after three sequential pruning passes
(tips contig.cpp:281-355, low-cov edges :601-776, bubbles :375-582).  The
byte-parity path (refassemble.py / native/assemble_engine.cpp) replays that
order exactly for validation.  This module is the SCALABLE path promised by
SURVEY.md P7 / section 7 step 5 — the same decisions computed as bulk array
programs:

  * link calculation (contig.cpp:107-205): one vectorized pass;
  * pruning: all candidate walks advance in LOCKSTEP batches
    (walk_batch), then decisions finalize in conflict-free ROUNDS — a
    candidate whose read set intersects an earlier-priority candidate's
    write set defers to the next round, so every finalized decision sees
    exactly the state the reference's sequential replay would have seen.
    Priority is the reference's true hash-slot iteration order (emulated
    via native.hash_layout, the same emulation the byte-parity path uses).
    Interacting candidates are rare (tips 34 / bubbles 4.3k on E. coli),
    so almost everything lands in round one;
  * readout (contig.cpp:900-1046): the de Bruijn successor function over
    surviving linear nodes is materialized as directed-state index arrays
    (state = node x walk-direction) and every maximal chain is resolved
    with O(log chain_length) pointer-doubling rounds of bulk gathers —
    no serial walk.  Cycles and hairpin (self-reverse) chains, which the
    reference splits by delete-order, fall back to an exact serial walk
    (they are vanishingly rare and detected precisely).

Deliberate divergence from the byte-parity path: output contig ORDER and
STRAND are hash-iteration artifacts in the reference (seed = first
surviving chain member in slot order).  This path emits each contig in its
canonical orientation (min(seq, revcomp)) sorted by length; equality with
the parity path is validated on the orientation-canonicalized sequence
multiset + per-base depth multiset + N50 (tests/test_pointer_doubling.py,
tools/validate_doubling_scale.py).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .. import dna
from .. import native
from ..io import stat as statio
from .graph import NodeTable
from .refassemble import (AssembleParams, AssembleStats, bit2seq,
                          compare_two_seq_simple, global_aligning)

BASES = np.frombuffer(b"ACGTN", np.uint8)
C_BASES = np.frombuffer(b"TGCAN", np.uint8)
_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def _revcomp_bytes(s: bytes) -> bytes:
    return s.translate(_COMP)[::-1]


def _adjust_depth_bytes(d: np.ndarray) -> np.ndarray:
    """Depth chars avoid '\\n' (10) and '>' (62): contig.cpp:849-851."""
    return np.where((d == 10) | (d == 62), d - 1, d).astype(np.uint8)


# =========================================================================
# graph state: vectorized primitives over the sorted node table
# =========================================================================

class _Graph:
    """Mutable pruning state over a NodeTable.  Node ids index the SORTED
    k-mer array (locate = vectorized searchsorted, the bulk analog of
    exist_kmerset DBG_contig/kmerSet.cpp:280-302); iteration priority is
    the emulated reference slot order."""

    def __init__(self, table: NodeTable, params: AssembleParams):
        self.p = params
        self.k = params.ksize
        self.mask = np.uint64((1 << (2 * self.k)) - 1)
        kmers = table.kmers
        first_idx = table.first_idx.astype(np.int64)
        pre = 0 if (kmers == np.uint64(0)).any() else 1
        if pre:
            # the reference unconditionally appends a (possibly empty)
            # poly-A node (DBGgraph.cpp:417-418); table stays sorted
            kmers = np.concatenate([[np.uint64(0)], kmers])
            first_idx = np.concatenate([[np.int64(2 ** 62)], first_idx])
        self.M = M = len(kmers)
        M1 = M + 1                           # + sentinel row (reads zeros)
        self.kmers = kmers                   # [M] sorted ascending
        # one allocation each for [poly-A row?] + counters + sentinel row
        # (the old minimum/astype + two concatenates copied each 214MB
        # plane three times)
        self.lcnt = np.zeros((M1, 4), np.int32)
        self.rcnt = np.zeros((M1, 4), np.int32)
        np.minimum(table.lcnt, 255, out=self.lcnt[pre:pre + len(table.lcnt)],
                   casting="unsafe")
        np.minimum(table.rcnt, 255, out=self.rcnt[pre:pre + len(table.rcnt)],
                   casting="unsafe")
        self.deleted = np.zeros(M1, bool)
        self.l_num = np.zeros(M1, np.int32)
        self.r_num = np.zeros(M1, np.int32)
        self.l_base = np.zeros(M1, np.int32)
        self.r_base = np.zeros(M1, np.int32)
        self.linear = np.zeros(M1, bool)
        self.stats = AssembleStats()

        # exact reference slot-iteration order (same emulation as
        # refassemble._build_hash: insertion in first-occurrence stream
        # order, poly-A key 0 last, jenkins64 linear probing)
        init = int(params.init_hash_size * 1_000_000_000)
        size = 3 if init < 3 else native.find_next_prime(init)
        self.stats.hash_size = size
        is_polyA = kmers == np.uint64(0)
        normal = np.flatnonzero(~is_polyA)
        order = normal[native.radix_argsort_u64(first_idx[normal])]
        if len(order) > int(size * params.load_factor):
            raise RuntimeError("node table exceeds hash capacity — raise "
                               "init_hash_size")
        slots, disp, conflicts = native.hash_layout_disp(kmers[order], size)
        self.stats.hash_conflicts = conflicts
        if table.counts is not None:
            counts = table.counts
            if len(counts) != M:
                counts = np.concatenate([[np.int32(0)], counts])
            self.stats.hash_conflicts_occ = int(
                (disp * counts[order].astype(np.int64)).sum())
        slot_of = np.full(M, -1, np.int64)
        slot_of[order] = slots
        occupied = np.zeros(size, bool)
        occupied[slots] = True
        pa = int(np.flatnonzero(is_polyA)[0])
        hc = int(native.jenkins64(np.uint64(0)) % np.uint64(size))
        while occupied[hc]:
            self.stats.hash_conflicts_occ += 1
            hc = 0 if hc + 1 == size else hc + 1
        slot_of[pa] = hc
        # node -> iteration rank by ascending slot (native dense pass)
        self.prio = native.slot_rank(slot_of, size)

    # ----------------------------------------------------------- locate
    def locate(self, nf: np.ndarray) -> np.ndarray:
        """Canonical k-mer values -> node ids (M = missing/deleted).

        The bulk analog of exist_kmerset (kmerSet.cpp:280-302).  MeshGraph
        (mesh_assemble.py) overrides _search to run the table search as a
        sharded collective program; the mutable deleted mask applies here."""
        nf = np.asarray(nf, np.uint64)
        idx = self._search(nf)
        found = (idx >= 0) & ~self.deleted[np.maximum(idx, 0)]
        return np.where(found, idx, self.M).astype(np.int64)

    def _search(self, nf: np.ndarray) -> np.ndarray:
        """Static-table search: k-mer values -> sorted-table index or -1."""
        idx = np.searchsorted(self.kmers, nf)
        idx = np.minimum(idx, self.M - 1)
        return np.where(self.kmers[idx] == nf, idx, -1).astype(np.int64)

    def resolve_chains(self, succ: np.ndarray):
        """Pointer-doubling chain resolution (MeshGraph runs it sharded)."""
        e, dist, cyclic = _resolve_chains(jnp.asarray(succ))
        return np.asarray(e), np.asarray(dist), np.asarray(cyclic)

    # ------------------------------------------------------------ links
    def calc_links(self):
        """calculate_kmer_links (contig.cpp:107-205), one bulk pass.
        Also snapshots tip/branch candidate lists in slot order, exactly
        as the reference collects them during this scan.  The O(M) counter
        math lives in _links_bulk (MeshGraph runs it sharded)."""
        M = self.M
        (self.l_num[:M], self.r_num[:M], self.l_base[:M], self.r_base[:M],
         self.depth_stat) = self._links_bulk()
        self.linear[:M] = (self.l_num[:M] == 1) & (self.r_num[:M] == 1)
        no_links = (self.l_num[:M] == 0) & (self.r_num[:M] == 0)
        self.deleted[:M] |= no_links
        st = self.stats
        st.total_nodes = M
        st.deleted_lowfreq = int(no_links.sum())
        st.linear_nodes = int(self.linear[:M].sum())
        # argsort of a permutation is its inverse — one O(M) scatter,
        # not another 13M-key radix sort
        so = np.empty(M, np.int64)
        so[self.prio] = np.arange(M, dtype=np.int64)
        self.tip_nodes = so[(self.l_num[so] + self.r_num[so]) == 1]
        self.branch_nodes = so[(self.l_num[so] > 1) | (self.r_num[so] > 1)]
        st.tip_candidates = len(self.tip_nodes)
        st.branch_candidates = len(self.branch_nodes)

    def _links_bulk(self):
        """O(M) link/topology pass over the counters: per-node link count
        (capped at 3), max-depth base (first strictly-greater wins =
        argmax, contig.cpp:136-139) and the 256-bin depth histogram —
        one native pass (the numpy form cost ~3.5s at 13.4M nodes)."""
        cut = self.p.kmer_freq_cutoff
        M = self.M
        return native.links_pass(self.lcnt[:M], self.rcnt[:M], cut)

    def write_kmer_freq(self, path: str):
        with open(path, "w") as f:
            f.write("Kmer_depth\tAppear_times\n")
            for i in range(1, 256):
                f.write(f"{i}\t{self.depth_stat[i]}\n")

    # ------------------------------------------------------- walk steps
    def next_ids(self, ids: np.ndarray, dirs: np.ndarray,
                 bases: np.ndarray):
        """One walk step from (node, direction) via the given base:
        returns (next_canonical, next_dir) — contig.cpp:801-807."""
        from .. import dna
        km = self.kmers[np.minimum(ids, self.M - 1)]
        b = bases.astype(np.uint64)
        right = dirs == 1
        nk = np.where(right,
                      ((km << np.uint64(2)) | b) & self.mask,
                      (km >> np.uint64(2))
                      + (b << np.uint64(2 * (self.k - 1))))
        rc = dna.revcomp_kbit(nk, self.k)
        flip = nk >= rc
        nf = np.where(flip, rc, nk)
        ndir = np.where(flip, -dirs, dirs)
        return nf, ndir

    def walk_batch(self, start: np.ndarray, dirs: np.ndarray, cutoff: int):
        """Vectorized get_linear_path (contig.cpp:779-827): every
        candidate's walk advances in lockstep vector steps.

        Returns dict with path_len [n], path_depth [n], visited [n,cutoff]
        (node ids, M-padded), chars [n,cutoff] (ASCII), last [n],
        mark_branch [n], arrive_dir [n] (walk_direct on arrival at last)."""
        n = len(start)
        path_len = np.zeros(n, np.int64)
        path_depth = np.zeros(n, np.int64)
        visited = np.full((n, max(cutoff, 1)), self.M, np.int64)
        chars = np.zeros((n, max(cutoff, 1)), np.uint8)
        last = np.full(n, self.M, np.int64)
        arrive = np.zeros(n, np.int64)
        # active-set compaction: most walks stop within a few steps, so
        # each step operates only on the still-walking rows (the full-width
        # lockstep form paid the whole candidate set for all `cutoff`
        # steps — ~1/3 of the doubling assembler's wall at 10 Mb)
        act_rows = np.arange(n)
        idx = start.astype(np.int64).copy()
        cur = dirs.astype(np.int64).copy()
        orig_all = dirs.astype(np.int64)
        for step in range(cutoff):
            if len(act_rows) == 0:
                break
            right = cur == 1
            b = np.where(right, self.r_base[idx], self.l_base[idx])
            cnt = np.where(right, self.rcnt[idx, b], self.lcnt[idx, b])
            path_len[act_rows] += 1
            path_depth[act_rows] += cnt
            visited[act_rows, step] = idx
            same = cur == orig_all[act_rows]
            chars[act_rows, step] = np.where(same, BASES[b], C_BASES[b])
            nf, ndir = self.next_ids(idx, cur, b)
            nxt = self.locate(nf)
            stop = (~self.linear[nxt]) | (nxt == self.M) | \
                   (path_len[act_rows] >= cutoff)
            srows = act_rows[stop]
            last[srows] = nxt[stop]
            arrive[srows] = ndir[stop]
            keep = ~stop
            act_rows = act_rows[keep]
            idx = nxt[keep]
            cur = ndir[keep]
        mark_branch = (last != self.M) & (self.l_num[last] > 0) & \
                      (self.r_num[last] > 0)
        return dict(path_len=path_len, path_depth=path_depth,
                    visited=visited, chars=chars, last=last,
                    mark_branch=mark_branch, arrive=arrive)

    # ------------------------------------------------------------ recalc
    def recalc(self, ids: np.ndarray):
        """Vectorized recalculate_kmer_links (contig.cpp:210-277): for the
        given nodes, re-validate neighbors, zero dangling counters, refresh
        num/base/linear."""
        ids = np.unique(np.asarray(ids, np.int64))
        ids = ids[ids < self.M]
        if len(ids) == 0:
            return
        from .. import dna
        cut = self.p.kmer_freq_cutoff
        km = self.kmers[ids]
        for side in ("l", "r"):
            cntarr = self.lcnt if side == "l" else self.rcnt
            cnt = cntarr[ids]                                  # [n, 4]
            b = np.arange(4, dtype=np.uint64)[None, :]
            if side == "l":
                nk = (km[:, None] >> np.uint64(2)) + \
                     (b << np.uint64(2 * (self.k - 1)))
            else:
                nk = ((km[:, None] << np.uint64(2)) | b) & self.mask
            rc = dna.revcomp_kbit(nk, self.k)
            nf = np.minimum(nk, rc)
            ex = self.locate(nf.reshape(-1)).reshape(nf.shape) != self.M
            qual = cnt > cut
            dangling = qual & ~ex
            cnt = np.where(dangling, 0, cnt)
            cntarr[ids] = cnt
            alive = qual & ex
            num = np.minimum(alive.sum(1), 3)
            base = np.argmax(np.where(alive, cnt, 0), axis=1)
            if side == "l":
                self.l_num[ids] = num
                self.l_base[ids] = np.where(num > 0, base, 0)
            else:
                self.r_num[ids] = num
                self.r_base[ids] = np.where(num > 0, base, 0)
        self.linear[ids] = (self.l_num[ids] == 1) & (self.r_num[ids] == 1)
        self.linear[self.M] = False


# =========================================================================
# conflict-round driver
# =========================================================================

def _rounds(g: _Graph, pending, evaluate, apply):
    """Finalize candidates in conflict-free rounds.

    pending: candidate node ids in reference iteration priority.
    evaluate(ids) -> (reads, writes, records): per candidate, the node ids
    its decision READ, the ids it would WRITE (empty if it would not act),
    and a cached record for apply.  apply(id, record) finalizes (mutating
    g) and returns its ACTUAL write set — which may exceed the estimate
    when a node's own earlier branch changed its later branches' walks, so
    applied writes are re-checked against every later candidate's reads.
    A candidate defers when its reads intersect any earlier-priority
    candidate's (estimated or actual) writes; each finalized decision thus
    saw exactly the state the reference's sequential replay would have."""
    pending = list(int(x) for x in pending)
    while pending:
        ids = np.asarray(pending, np.int64)
        reads, writes, records = evaluate(ids)
        est_writer: dict[int, int] = {}
        for pos, ws in enumerate(writes):
            for v in ws:
                if v not in est_writer:
                    est_writer[v] = pos
        applied_writes: set[int] = set()
        next_pending = []
        for pos in range(len(ids)):
            rd = reads[pos]
            clean = all(est_writer.get(v, pos) >= pos for v in rd) and \
                not any(v in applied_writes for v in rd)
            if clean:
                actual = apply(int(ids[pos]), records[pos])
                if actual:
                    applied_writes.update(int(v) for v in actual)
            else:
                next_pending.append(int(ids[pos]))
        if len(next_pending) == len(pending):
            raise RuntimeError("conflict rounds made no progress")
        pending = next_pending


# =========================================================================
# pruning phases
# =========================================================================

def remove_tips(g: _Graph, out_path: str):
    """remove_error_tips (contig.cpp:281-355) as one batched walk per
    round.  Matches the reference quirk of NOT skipping candidates already
    deleted by an earlier tip (their stale links are walked as-is)."""
    p = g.p
    lines = []
    state = dict(num=0, length=0)

    def evaluate(ids):
        dirs = np.where(g.l_num[ids] == 1, -1, 1)
        w = g.walk_batch(ids, dirs, p.tip_len_cutoff)
        reads, writes, records = [], [], []
        for i in range(len(ids)):
            ln = int(w["path_len"][i])
            dep = int(w["path_depth"][i])
            vec = w["visited"][i, :ln]
            last = int(w["last"][i])
            qualify = (dep <= p.tip_depth_cutoff * ln
                       and ln <= p.tip_len_cutoff)
            rd = [int(ids[i])] + vec.tolist() + [last]
            reads.append(rd)
            writes.append(vec.tolist() + [last] if qualify else [])
            records.append((int(dirs[i]), ln, dep, vec.copy(),
                            w["chars"][i, :ln].tobytes(), last,
                            bool(w["mark_branch"][i]), qualify))
        return reads, writes, records

    def apply(idx, rec):
        walk, ln, dep, vec, tip_str, last, is_branch, qualify = rec
        if not qualify:
            return []
        state["num"] += 1
        state["length"] += ln
        g.deleted[vec] = True
        g.recalc(np.asarray([last]))
        mark = "branch" if is_branch else "break"
        kmer_str = bit2seq(int(g.kmers[idx]), g.k)
        s = tip_str.decode()
        out = kmer_str + s if walk == 1 else s[::-1] + kmer_str
        lkm_last = int(g.kmers[last]) if last < g.M else 0
        if walk == 1:
            lkm, lmark = int(g.kmers[idx]), "break"
            rkm, rmark = lkm_last, mark
        else:
            rkm, rmark = int(g.kmers[idx]), "break"
            lkm, lmark = lkm_last, mark
        avg = dep / ln
        lines.append(
            f">tip_{state['num']}\tlength: {ln + g.k}"
            f"\tavgDepth: {statio.fmt_g6(avg)}\tLeftEndKmer: {lkm} {lmark}"
            f"\tRightEndKmer: {rkm} {rmark}\n{out}\n")
        return vec.tolist() + [last]

    _rounds(g, g.tip_nodes, evaluate, apply)
    with open(out_path, "w") as f:
        f.writelines(lines)
    g.stats.tips_removed = state["num"]
    g.stats.tip_len_removed = state["length"]


def _branch_bases(cnt_row, cut):
    out_b, out_d = [], []
    for j in range(4):
        d = int(cnt_row[j])
        if d > cut:
            out_b.append(j)
            out_d.append(d)
    return out_b, out_d


def remove_lowedges(g: _Graph, out_path: str):
    """remove_lowCov_edges (contig.cpp:601-776).  Evaluation batches every
    (branch node, side, base) lane into one lockstep walk; finalization
    re-derives each clean node's branches serially (r side then l side,
    fresh per-side base lists) exactly like the reference, which matters
    only when an earlier branch of the SAME node deleted state."""
    p = g.p
    lines = []
    state = dict(num=0, length=0)
    cut = p.kmer_freq_cutoff

    def evaluate(ids):
        n = len(ids)
        lane_node, lane_dir, lane_base, lane_cand = [], [], [], []
        for side_dir, cnt_all, num_all in (
                (1, g.rcnt, g.r_num), (-1, g.lcnt, g.l_num)):
            has = num_all[ids] >= 2
            mask = (cnt_all[ids] > cut) & has[:, None]        # [n,4]
            ci, bj = np.nonzero(mask)
            lane_cand.append(ci)
            lane_node.append(ids[ci])
            lane_dir.append(np.full(len(ci), side_dir, np.int64))
            lane_base.append(bj.astype(np.int64))
        lane_cand = np.concatenate(lane_cand)
        lane_node = np.concatenate(lane_node)
        lane_dir = np.concatenate(lane_dir)
        lane_base = np.concatenate(lane_base)
        if len(lane_node):
            nf, nd = g.next_ids(lane_node, lane_dir, lane_base)
            i1 = g.locate(nf)
            lin = g.linear[i1]
            wsel = np.flatnonzero(lin)
            w = g.walk_batch(i1[wsel], nd[wsel], p.lowedge_len_cutoff) \
                if len(wsel) else None
        else:
            i1 = np.zeros(0, np.int64)
            lin = np.zeros(0, bool)
            wsel = np.zeros(0, np.int64)
            w = None
        wpos = np.full(len(lane_node), -1, np.int64)
        wpos[wsel] = np.arange(len(wsel))

        reads = [[int(i)] for i in ids]
        writes = [[] for _ in ids]
        for li in range(len(lane_node)):
            c = int(lane_cand[li])
            ii = int(i1[li])
            if ii < g.M:
                reads[c].append(ii)
            if not lin[li]:
                continue
            k = int(wpos[li])
            ln = int(w["path_len"][k]) + 1
            dep = int(w["path_depth"][k]) + \
                int((g.rcnt if lane_dir[li] == 1 else g.lcnt)[
                    lane_node[li], lane_base[li]])
            last = int(w["last"][k])
            vec = w["visited"][k, :ln - 1]
            reads[c].extend(vec.tolist())
            reads[c].append(last)
            if (ln <= p.lowedge_len_cutoff
                    and dep <= p.lowedge_depth_cutoff * ln
                    and not g.linear[last]):
                writes[c].extend(vec.tolist())
                writes[c].extend([last, int(ids[c])])
        records = [bool(w_) for w_ in writes]     # True -> may act
        return reads, writes, records

    def apply(idx, may_act):
        if not may_act:
            return []
        actual = []
        for side in ("r", "l"):
            num = g.r_num[idx] if side == "r" else g.l_num[idx]
            if num < 2:
                continue
            cnt_row = (g.rcnt if side == "r" else g.lcnt)[idx]
            vb, vd = _branch_bases(cnt_row, cut)
            for j, b in enumerate(vb):
                nf, ndir = g.next_ids(
                    np.asarray([idx]),
                    np.asarray([1 if side == "r" else -1]),
                    np.asarray([b]))
                i1 = int(g.locate(nf)[0])
                if not g.linear[i1]:
                    continue
                w = g.walk_batch(np.asarray([i1]), ndir,
                                 p.lowedge_len_cutoff)
                ln = int(w["path_len"][0]) + 1
                dep = int(w["path_depth"][0]) + vd[j]
                last = int(w["last"][0])
                if not (ln <= p.lowedge_len_cutoff
                        and dep <= p.lowedge_depth_cutoff * ln
                        and not g.linear[last]):
                    continue
                state["num"] += 1
                state["length"] += ln
                vec = w["visited"][0, :ln - 1]
                g.deleted[vec] = True
                g.recalc(np.asarray([last, idx]))
                actual.extend(vec.tolist())
                actual.extend([last, idx])
                estr = w["chars"][0, :ln - 1].tobytes().decode()
                k1 = bit2seq(int(g.kmers[i1]), g.k)
                out1 = k1 + estr if int(ndir[0]) == 1 else estr[::-1] + k1
                avg = dep / ln
                mark = "branch" if w["mark_branch"][0] else "break"
                lk = int(g.kmers[last]) if last < g.M else 0
                if side == "r":
                    lines.append(
                        f">lowedge_{state['num']}\tlength: {ln + g.k}"
                        f"\tavgDepth: {statio.fmt_g6(avg)}"
                        f"\tLeftEndKmer: {int(g.kmers[idx])} branch"
                        f"\tRightEndKmer: {lk} {mark}\n{out1}\n")
                else:
                    # divergent spacing in the reference's leftward branch
                    # (contig.cpp:763) — reproduced deliberately
                    lines.append(
                        f">lowedge_{state['num']}    length:{ln + g.k}"
                        f"    avgDepth:{statio.fmt_g6(avg)}"
                        f"\tLeftEndKmer: {lk} {mark}"
                        f"\tRightEndKmer: {int(g.kmers[idx])} branch"
                        f"\n{out1}\n")
        return actual

    _rounds(g, g.branch_nodes, evaluate, apply)
    with open(out_path, "w") as f:
        f.writelines(lines)
    g.stats.lowedges_removed = state["num"]
    g.stats.lowedge_len_removed = state["length"]


def remove_bubbles(g: _Graph, out_path: str):
    """remove_hetero_bubbles (contig.cpp:375-582): both branch walks of
    every bubble-shaped node advance in one lockstep batch; sequence
    compare (SNP hamming / INDEL Needleman-Wunsch) runs at finalization
    from the cached walks (valid by the conflict-round guarantee)."""
    p = g.p
    lines = []
    state = dict(num=0, length=0)
    cut = p.kmer_freq_cutoff

    def evaluate(ids):
        n = len(ids)
        l_num, r_num = g.l_num[ids], g.r_num[ids]
        shape_l = (l_num == 2) & (r_num == 1)
        shape_r = (l_num == 1) & (r_num == 2)
        is_b = shape_l | shape_r
        walkdir = np.where(shape_l, -1, 1).astype(np.int64)
        cnt = np.where(shape_l[:, None], g.lcnt[ids], g.rcnt[ids])
        q = cnt > cut
        b1 = np.argmax(q, axis=1)
        b2 = np.argmax(q & (np.arange(4)[None, :] > b1[:, None]), axis=1)
        d1 = cnt[np.arange(n), b1]
        d2 = cnt[np.arange(n), b2]
        sel = np.flatnonzero(is_b)
        lane_node = np.repeat(ids[sel], 2)
        lane_dir = np.repeat(walkdir[sel], 2)
        lane_base = np.stack([b1[sel], b2[sel]], 1).reshape(-1)
        if len(lane_node):
            nf, nd = g.next_ids(lane_node, lane_dir, lane_base)
            i12 = g.locate(nf)
            lin2 = g.linear[i12].reshape(-1, 2)
            ok = lin2.all(1)
            wsel = np.flatnonzero(np.repeat(ok, 2))
            w = g.walk_batch(i12[wsel], nd[wsel], p.bubble_len_cutoff) \
                if len(wsel) else None
        else:
            i12 = np.zeros(0, np.int64)
            ok = np.zeros(0, bool)
            wsel = np.zeros(0, np.int64)
            w = None
        wpos = np.full(len(lane_node), -1, np.int64)
        wpos[wsel] = np.arange(len(wsel))

        reads = [[int(i)] for i in ids]
        writes = [[] for _ in ids]
        records = [None] * n
        for s_i, c in enumerate(sel):
            c = int(c)
            la = 2 * s_i
            ii = i12[la:la + 2]
            reads[c].extend(int(x) for x in ii if x < g.M)
            if not ok[s_i]:
                continue
            k1, k2 = int(wpos[la]), int(wpos[la + 1])
            rec = dict(
                walk=int(walkdir[c]),
                vd=(int(d1[c]), int(d2[c])),
                i12=(int(ii[0]), int(ii[1])),
                nd=(int(nd[la]), int(nd[la + 1])),
                lens=(int(w["path_len"][k1]), int(w["path_len"][k2])),
                deps=(int(w["path_depth"][k1]), int(w["path_depth"][k2])),
                lasts=(int(w["last"][k1]), int(w["last"][k2])),
                marks=(bool(w["mark_branch"][k1]),
                       bool(w["mark_branch"][k2])),
                vecs=(w["visited"][k1, :int(w["path_len"][k1])].copy(),
                      w["visited"][k2, :int(w["path_len"][k2])].copy()),
                strs=(w["chars"][k1, :int(w["path_len"][k1])].tobytes(),
                      w["chars"][k2, :int(w["path_len"][k2])].tobytes()))
            records[c] = rec
            for v in (0, 1):
                reads[c].extend(rec["vecs"][v].tolist())
            reads[c].extend(rec["lasts"])
            if rec["lasts"][0] == rec["lasts"][1]:
                # may delete either path + recalc last/idx
                writes[c].extend(rec["vecs"][0].tolist())
                writes[c].extend(rec["vecs"][1].tolist())
                writes[c].extend([rec["lasts"][0], int(ids[c])])
        return reads, writes, records

    def apply(idx, rec):
        if rec is None or rec["lasts"][0] != rec["lasts"][1]:
            return []
        walk = rec["walk"]
        len1, len2 = rec["lens"]
        dep1, dep2 = rec["deps"]
        last1 = rec["lasts"][0]
        avg1, avg2 = dep1 / len1, dep2 / len2
        w1, w2 = rec["nd"]
        ks1 = bit2seq(int(g.kmers[rec["i12"][0]]), g.k)
        s1 = rec["strs"][0].decode()
        bs1 = ks1 + s1 if w1 == 1 else s1[::-1] + ks1
        ks2 = bit2seq(int(g.kmers[rec["i12"][1]]), g.k)
        s2 = rec["strs"][1].decode()
        bs2 = ks2 + s2 if w2 == 1 else s2[::-1] + ks2
        if w1 != w2:
            bs1 = _revcomp_bytes(bs1.encode()).decode()
        len1 += 1
        len2 += 1
        dep1 += rec["vd"][0]
        dep2 += rec["vd"][1]
        diff_rate = 0.0
        btype = ""
        if len1 == len2:
            diff_rate = compare_two_seq_simple(bs1, bs2) / len1
            btype = "SNP"
        if len1 != len2 or diff_rate > p.bubble_base_diff_rate:
            bs1, bs2 = global_aligning(bs1, bs2)
            diff_rate = compare_two_seq_simple(bs1, bs2) / len1
            btype = "INDEL"
        if not (diff_rate < p.bubble_base_diff_rate
                and abs(len1 - len2) < p.bubble_len_cutoff
                * p.bubble_len_diff_rate
                and len1 <= p.bubble_len_cutoff
                and len2 <= p.bubble_len_cutoff):
            return []
        pick = 0 if avg1 < avg2 else 1
        ln = (len1, len2)[pick]
        vec = rec["vecs"][pick]
        g.deleted[vec] = True
        g.recalc(np.asarray([last1, idx]))
        state["num"] += 1
        state["length"] += ln
        mark1 = "branch" if rec["marks"][0] else "break"
        lkm_last = int(g.kmers[last1]) if last1 < g.M else 0
        if walk == 1:
            lkm, lmark = int(g.kmers[idx]), "branch"
            rkm, rmark = lkm_last, mark1
        else:
            rkm, rmark = int(g.kmers[idx]), "branch"
            lkm, lmark = lkm_last, mark1
        lines.append(
            f">bubble_{state['num']}\ttype: {btype}\tlength1: {len1 + g.k}"
            f"\tavgDepth1: {statio.fmt_g6(avg1)}\tlength2: {len2 + g.k}"
            f"\tavgDepth2: {statio.fmt_g6(avg2)}\tremoved: {pick + 1}"
            f"\tLeftEndKmer: {lkm} {lmark}"
            f"\tRightEndKmer: {rkm} {rmark}\n{bs1}\n{bs2}\n")
        return vec.tolist() + [last1, idx]

    _rounds(g, g.branch_nodes, evaluate, apply)
    with open(out_path, "w") as f:
        f.writelines(lines)
    g.stats.bubbles_removed = state["num"]
    g.stats.bubble_len_removed = state["length"]


# =========================================================================
# pointer-doubling readout
# =========================================================================

@functools.partial(jax.jit, static_argnames=("k",))
def _succ_resolve(kmers: jnp.ndarray, l_base: jnp.ndarray,
                  r_base: jnp.ndarray, alive: jnp.ndarray, *, k: int):
    """Fused successor-build + pointer-doubling for read_out_contigs:
    next-kmer math, sorted-table search and chain resolution as ONE XLA
    program over the interleaved 2M directed states (state 2i = node i
    rightward, 2i+1 leftward).  Replaces the separate numpy
    next_ids/locate/resolve passes."""
    M = kmers.shape[0]
    mask = jnp.uint64((1 << (2 * k)) - 1)
    STOP = jnp.int64(2 * M)

    def step(base, right: bool):
        b = base.astype(jnp.uint64)
        if right:
            nk = ((kmers << jnp.uint64(2)) | b) & mask
        else:
            nk = (kmers >> jnp.uint64(2)) \
                | (b << jnp.uint64(2 * (k - 1)))
        rc = dna.revcomp_kbit(nk, k)
        flip = nk >= rc
        nf = jnp.where(flip, rc, nk)
        left_after = flip if right else ~flip
        idx = jnp.searchsorted(kmers, nf)
        idxc = jnp.minimum(idx, M - 1)
        ok = alive & (kmers[idxc] == nf) & alive[idxc]
        return jnp.where(ok, 2 * idxc + left_after, STOP)

    succ = jnp.stack([step(r_base, True), step(l_base, False)],
                     axis=1).reshape(-1)
    e, dist, cyclic = _resolve_chains(succ)
    return succ, e, dist, cyclic


@functools.partial(jax.jit, static_argnames=("k", "cut"))
def contig_stage_step(kmers: jnp.ndarray, lcnt: jnp.ndarray,
                      rcnt: jnp.ndarray, *, k: int, cut: int):
    """Device-resident contig stage over a sorted node table: the link/
    topology pass (calculate_kmer_links, contig.cpp:107-205), the directed
    successor function over 2M states (read_out_contigs' chain walk,
    one table search per state), and pointer-doubling chain resolution —
    the same programs MeshGraph runs sharded, composed on one chip for
    bench.py's stages.contig measurement.

    kmers: [M] uint64 ascending, SENTINEL rows inert (their counters must
    be 0).  State layout: i = node i walking canonical-rightward,
    M+i = leftward.  Returns (l_num, r_num, linear, e, dist, cyclic)."""
    M = kmers.shape[0]
    lq, rq = lcnt > cut, rcnt > cut
    l_num = jnp.minimum(jnp.sum(lq, axis=1), 3).astype(jnp.int32)
    r_num = jnp.minimum(jnp.sum(rq, axis=1), 3).astype(jnp.int32)
    l_base = jnp.argmax(jnp.where(lq, lcnt, 0), axis=1).astype(jnp.int32)
    r_base = jnp.argmax(jnp.where(rq, rcnt, 0), axis=1).astype(jnp.int32)
    linear = (l_num == 1) & (r_num == 1)

    mask = jnp.uint64((1 << (2 * k)) - 1)
    km2 = jnp.concatenate([kmers, kmers])
    base = jnp.concatenate([r_base, l_base]).astype(jnp.uint64)
    right = jnp.arange(2 * M, dtype=jnp.int64) < M
    nk = jnp.where(right,
                   ((km2 << jnp.uint64(2)) | base) & mask,
                   (km2 >> jnp.uint64(2))
                   | (base << jnp.uint64(2 * (k - 1))))
    rc = dna.revcomp_kbit(nk, k)
    flip = nk >= rc
    nf = jnp.where(flip, rc, nk)
    ndir_left = flip ^ ~right          # walking leftward after the step
    # method="sort": the search joins queries and keys through ONE sort
    # instead of per-query binary probing (a chain of dependent random
    # gathers per query)
    idx = jnp.searchsorted(kmers, nf, method="sort")
    idxc = jnp.minimum(idx, M - 1)
    found = kmers[idxc] == nf
    lin2 = jnp.concatenate([linear, linear])
    ok = lin2 & found & linear[idxc]
    STOP = jnp.int64(2 * M)
    succ = jnp.where(ok, idxc + jnp.where(ndir_left, M, 0), STOP)
    # statically UNROLLED doubling: a while/fori-loop body's gathers hit
    # the slow in-loop gather path; straight-line rounds gather at full
    # bandwidth
    n = succ.shape[0]
    s_idx = jnp.arange(n, dtype=succ.dtype)
    stop2 = succ >= n
    e = jnp.where(stop2, s_idx, succ)
    r = jnp.where(stop2, jnp.int64(0), jnp.int64(1))
    rounds = int(np.ceil(np.log2(max(int(n), 2)))) + 1
    for _ in range(rounds):
        e, r = e[e], r + r[e]
    succ_p = jnp.concatenate([succ, jnp.array([n], succ.dtype)])
    cyclic = succ_p[e] < n
    return l_num, r_num, linear, e, r + 1, cyclic


@jax.jit
def _resolve_chains(succ: jnp.ndarray):
    """Jump-pointer doubling over the directed-state successor function.

    succ: [n] int64 with STOP encoded as n.  Returns (end [n] = state id of
    each state's chain end, dist [n] = states from s to end inclusive,
    cyclic [n]).  O(log n) rounds of bulk gathers — the scalable analog of
    the reference's serial get_linear_seq pointer chase."""
    n = succ.shape[0]
    s_idx = jnp.arange(n, dtype=succ.dtype)
    stop = succ >= n
    e = jnp.where(stop, s_idx, succ)
    r = jnp.where(stop, jnp.int64(0), jnp.int64(1))

    # early exit: the fixed point arrives after ceil(log2(longest
    # chain)) rounds, usually far below log2(n) — each round is a full
    # n-wide gather pass, so stopping early is a direct saving.  CYCLES
    # never reach a fixed point (e keeps rotating), so the round cap is
    # load-bearing, not just a safety net.
    rounds = int(np.ceil(np.log2(max(int(n), 2)))) + 1

    def cond(st):
        return st[2] & (st[3] < rounds)

    def body(st):
        e, r, _, i = st
        e2 = e[e]
        return e2, r + r[e], jnp.any(e2 != e), i + 1

    e, r, _, _ = jax.lax.while_loop(
        cond, body, (e, r, jnp.asarray(True), jnp.int32(0)))
    succ_p = jnp.concatenate([succ, jnp.array([n], succ.dtype)])
    cyclic = succ_p[e] < n
    return e, r + 1, cyclic


def _serial_get_linear_seq(g: _Graph, idx: int, walk: int):
    """Exact serial get_linear_seq (contig.cpp:832-896) over _Graph state,
    DELETING traversed nodes — used only for the rare cycle/hairpin chains
    whose output depends on delete order."""
    original = walk
    seq_len = 0
    seq_depth = 0
    chars = bytearray()
    depths = bytearray()
    is_repeat = "Unknown"
    while True:
        seq_len += 1
        if walk == 1:
            b = int(g.r_base[idx])
            d = int(g.rcnt[idx, b])
        else:
            b = int(g.l_base[idx])
            d = int(g.lcnt[idx, b])
        seq_depth += d
        if d in (10, 62):
            d -= 1
        depths.append(d)
        chars.append(int(BASES[b]) if walk == original else int(C_BASES[b]))
        nf, nd = g.next_ids(np.asarray([idx]), np.asarray([walk]),
                            np.asarray([b]))
        walk = int(nd[0])
        nxt = int(g.locate(nf)[0])
        if (not g.linear[nxt]) or nxt == g.M:
            mark = "break" if (nxt == g.M or g.l_num[nxt] == 0
                               or g.r_num[nxt] == 0) else "branch"
            if mark == "branch":
                is_repeat = "Repeat" if (
                    (walk == 1 and g.r_num[nxt] > 1)
                    or (walk == -1 and g.l_num[nxt] > 1)) else "Unique"
            return (seq_len, seq_depth, bytes(chars), nxt, mark,
                    bytes(depths), is_repeat)
        g.deleted[nxt] = True
        idx = nxt


def _boundary_info(g: _Graph, nxt: int, arrive_dir: int):
    """(end kmer value, mark, repeat tag) for a walk stopping at nxt."""
    if nxt >= g.M:
        return 0, "break", "Unknown"
    if g.l_num[nxt] == 0 or g.r_num[nxt] == 0:
        return int(g.kmers[nxt]), "break", "Unknown"
    rep = "Repeat" if ((arrive_dir == 1 and g.r_num[nxt] > 1)
                       or (arrive_dir == -1 and g.l_num[nxt] > 1)) \
        else "Unique"
    return int(g.kmers[nxt]), "branch", rep


def read_out_contigs(g: _Graph, prefix: str):
    """read_out_contig (contig.cpp:900-1046) via chain decomposition.

    Every surviving linear node belongs to exactly one maximal chain; the
    directed successor function over 2M states (state 2i = node i walking
    canonical-rightward, 2i+1 leftward) is materialized with bulk steps,
    chains resolve by pointer doubling, and sequences/depth strings
    assemble with bulk scatters.  Each chain is emitted in the frame the
    reference's serial readout would use — seed = first chain member in
    slot order, k average-depth bytes at the seed's k-mer position,
    strand = the seed's canonical frame — so every record is
    byte-identical to the serial path's; only file ORDER can differ
    (length-sort ties).  Cycles and hairpin (self-reverse) chains fall
    back to the exact serial walker in slot order."""
    import os as _os
    import time as _time
    _prof = _os.environ.get("DBG_PD_PROFILE")
    _t0 = _time.perf_counter()

    def _t(msg):
        nonlocal _t0
        if _prof:
            print(f"    [ro] {msg:18s} {_time.perf_counter() - _t0:7.2f}s",
                  flush=True)
        _t0 = _time.perf_counter()

    p = g.p
    M = g.M
    k = g.k
    alive = (~g.deleted[:M]) & g.linear[:M]

    # ---- directed successor function over 2M states (bulk)
    n_states = 2 * M
    STOP = n_states
    node = np.repeat(np.arange(M, dtype=np.int64), 2)
    sdir = np.tile(np.array([1, -1], np.int64), M)
    base = np.where(sdir == 1, g.r_base[node], g.l_base[node])
    depth = np.where(sdir == 1, g.rcnt[node, base],
                     g.lcnt[node, base]).astype(np.int64)
    if type(g) is _Graph:
        # native hash-lookup successor pass + XLA pointer doubling: one
        # native pass replaces the separate numpy passes (next_ids /
        # locate / resolve_chains)
        succ = native.succ_build(g.kmers, g.l_base[:M], g.r_base[:M],
                                 alive.astype(np.uint8), g.k)
        _t("succ_build")
        # native O(n) chase-with-backfill twin of the XLA doubling
        # program (identical outputs on non-cyclic states, flag-only on
        # cyclic ones — test_contig_stage_step.py fuzzes the pair); the
        # doubling program itself is what MeshGraph/contig_stage_step
        # run sharded/on-device
        e, dist, cyclic = native.resolve_chains_host(succ)
        _t("resolve_chains")
    else:
        nf, ndir_a = g.next_ids(node, sdir, base)
        nxt_a = g.locate(nf)
        ok = alive[node] & (nxt_a != M) & g.linear[np.minimum(nxt_a, M)]
        succ = np.where(ok, 2 * nxt_a + (ndir_a == -1).astype(np.int64),
                        STOP)
        succ = np.where(alive[node], succ, STOP)
        e, dist, cyclic = g.resolve_chains(succ)

    def state_next(s: int):
        """(next node id, arriving direction) of one directed state —
        boundary-info lookups touch only a handful of states, so they do
        not warrant materializing the full nxt/ndir arrays."""
        nd = np.array([1 if s % 2 == 0 else -1], np.int64)
        nid = np.array([s >> 1], np.int64)
        b = g.r_base[nid] if s % 2 == 0 else g.l_base[nid]
        nf1, nd1 = g.next_ids(nid, nd, np.asarray(b, np.int64))
        return int(g.locate(nf1)[0]), int(nd1[0])

    is_state = alive[node]
    # one native scan instead of five full-width boolean temporaries:
    # head = alive state, neither it nor its reverse cyclic, reverse has
    # no successor; fallback = nodes of cyclic alive states
    head_states, fb_arr = native.collect_heads(
        alive.astype(np.uint8), succ, cyclic.astype(np.uint8))
    mate = e[head_states] ^ 1
    hairpin = mate == head_states
    fallback_nodes = set(fb_arr.tolist())
    for h in head_states[hairpin]:
        st_h = int(h)
        # hairpin chain: collect its nodes for serial fallback
        s = st_h
        while s != STOP:
            fallback_nodes.add(int(node[s]))
            s = int(succ[s])
    head_states = head_states[(head_states <= mate) & ~hairpin]
    _t("heads")

    recs = []   # (seq bytes, depth bytes, header str after id)

    if len(head_states):
        n_chains = len(head_states)
        L_chain = dist[head_states]
        head_dir = sdir[head_states]
        # chain id of every state via its end state (hugepaged: the
        # e[st_ids] gather below probes it at random)
        cid_of_end = native._huge_empty(n_states, np.int64)
        cid_of_end.fill(-1)
        cid_of_end[e[head_states]] = np.arange(n_chains)
        st_ids = np.flatnonzero(is_state & ~cyclic)
        cid = cid_of_end[e[st_ids]]
        selm = cid >= 0
        st_ids = st_ids[selm]
        cid = cid[selm]
        pos = L_chain[cid] - dist[st_ids]
        # chars/depths in CHAIN orientation (original=+1 convention:
        # BASES when the state walks canonical-rightward, C_BASES else)
        b = base[st_ids]
        rel = np.where(sdir[st_ids] == 1, b, 3 - b).astype(np.int64)
        dep = depth[st_ids]

        off = np.zeros(n_chains + 1, np.int64)
        np.cumsum(L_chain, out=off[1:])
        body_codes = native._huge_empty(off[-1], np.int64)
        body_codes.fill(0)
        body_deps = native._huge_empty(off[-1], np.int64)
        body_deps.fill(0)
        body_codes[off[cid] + pos] = rel
        body_deps[off[cid] + pos] = dep
        _t("body scatters")

        # reference seed of each chain = the member node first in slot
        # order (read_out_contig scan order, contig.cpp:930): the k
        # average-depth bytes sit at the seed's k-mer position and the
        # output strand is the seed's canonical frame — reproducing both
        # makes every record byte-identical to the serial readout
        # per-chain min-prio member (native one-pass segment argmin; the
        # np.lexsort+np.unique form cost ~3s at 9.3M nodes).  prio is
        # unique per node and each node appears once per chain, so the
        # first-lowest-index tie rule matches the stable lexsort pick.
        am = native.seg_argmin(cid, g.prio[node[st_ids]], n_chains)
        seed_state = st_ids[am]                        # [n_chains]
        seed_pos = pos[am]
        _t("seed argmin")

        hrev = head_states ^ 1
        # left-boundary char/depth in chain orientation: rev(head) emits
        # BASES in ITS walk frame; complement when the head itself walks
        # canonical-leftward
        lb = base[hrev]
        bchar = np.where(head_dir == 1, BASES[lb], C_BASES[lb])
        bdep = depth[hrev]
        head_node = node[head_states]
        for c in range(n_chains):
            h = int(head_states[c])
            L = int(L_chain[c])
            o = int(off[c])
            codes = body_codes[o:o + L]
            deps = body_deps[o:o + L]
            total_dep = int(deps.sum()) + int(bdep[c])
            avg = total_dep / (L + 1)
            kmer_str = bit2seq(int(g.kmers[head_node[c]]), k).encode()
            if head_dir[c] != 1:
                kmer_str = _revcomp_bytes(kmer_str)
            chain_chars = BASES[codes].tobytes()
            seq = bytes([int(bchar[c])]) + kmer_str + chain_chars
            dv = int(avg) & 0xFF
            if dv in (10, 62):
                dv -= 1
            mid = bytes([dv] * k)
            # edge-depth bytes in chain orientation: left boundary + one
            # per state; avg block inserted at the seed position (edge
            # counters are symmetric by construction — each adjacency
            # event increments both end nodes' counters, DBGgraph.cpp:93-96)
            eflat = np.concatenate([[int(bdep[c])], deps])
            eadj = _adjust_depth_bytes(eflat).tobytes()
            q = int(seed_pos[c])
            dbytes = eadj[:q + 1] + mid + eadj[q + 1:]
            # header boundary info: left = rev(head) stop, right = end stop
            ln_id, ln_dir = state_next(h ^ 1)
            lkm, lmark, lrep = _boundary_info(g, ln_id, ln_dir)
            endst = int(e[h])
            rn_id, rn_dir = state_next(endst)
            rkm, rmark, rrep = _boundary_info(g, rn_id, rn_dir)
            if sdir[seed_state[c]] != 1:
                # the seed walks canonical-leftward on this chain: the
                # reference emits the reverse-complement frame
                seq = _revcomp_bytes(seq)
                dbytes = dbytes[::-1]
                lkm, lmark, lrep, rkm, rmark, rrep = \
                    rkm, rmark, rrep, lkm, lmark, lrep
            ctype = "RepeatNode" if (lrep == "Repeat"
                                     and rrep == "Repeat") else ""
            header = (f"\tlength: {len(seq)}"
                      f"\tavgDepth: {statio.fmt_lexical(avg)}"
                      f"\tLeftEndKmer: {lkm} {lmark}-{lrep}"
                      f"\tRightEndKmer: {rkm} {rmark}-{rrep}"
                      f"\t{ctype}\n")
            recs.append((seq, dbytes, header))
        _t("chain loop")

    # ---- cycles + hairpins: exact serial walker in slot order
    if fallback_nodes:
        fb = np.asarray(sorted(fallback_nodes), np.int64)
        fb = fb[np.argsort(g.prio[fb], kind="stable")]
        for i in fb:
            i = int(i)
            if g.deleted[i] or not g.linear[i]:
                continue
            kmer_str = bit2seq(int(g.kmers[i]), k).encode()
            (rlen, rdep, rstr, rlast, rmark, rdepths,
             rrep) = _serial_get_linear_seq(g, i, 1)
            (llen, ldep, lstr, llast, lmark, ldepths,
             lrep) = _serial_get_linear_seq(g, i, -1)
            ctype = "RepeatNode" if (lrep == "Repeat"
                                     and rrep == "Repeat") else ""
            g.deleted[i] = True
            seq = lstr[::-1] + kmer_str + rstr
            avg = (ldep + rdep) / (llen + rlen)
            dv = int(avg) & 0xFF
            if dv in (10, 62):
                dv -= 1
            dbytes = ldepths[::-1] + bytes([dv] * k) + rdepths
            lkm = int(g.kmers[llast]) if llast < g.M else 0
            rkm = int(g.kmers[rlast]) if rlast < g.M else 0
            header = (f"\tlength: {len(seq)}"
                      f"\tavgDepth: {statio.fmt_lexical(avg)}"
                      f"\tLeftEndKmer: {lkm} {lmark}-{lrep}"
                      f"\tRightEndKmer: {rkm} {rmark}-{rrep}"
                      f"\t{ctype}\n")
            recs.append((seq, dbytes, header))

    # ---- length-sorted output with odd ids (contig.cpp:1014-1046)
    lens = np.array([len(r[0]) for r in recs], dtype=np.uint64)
    perm = native.gcc44_sort_perm_desc(lens) if len(recs) else []
    st = g.stats
    with open(prefix + ".contig.seq.fa", "w") as ctg_f, \
            open(prefix + ".contig.seq.depth", "wb") as ctg_d, \
            open(prefix + ".contig.small.fa", "w") as small_f, \
            open(prefix + ".contig.small.depth", "wb") as small_d:
        contig_id = 1
        for pi in perm:
            seq, dbytes, header = recs[int(pi)]
            name = f">ctg_{contig_id}"
            if len(seq) >= p.contig_len_cutoff:
                ctg_f.write(name + header + seq.decode() + "\n")
                ctg_d.write(name.encode() + b"\n" + dbytes + b"\n")
                st.contig_num += 1
                st.contig_len += len(seq)
            else:
                small_f.write(name + header + seq.decode() + "\n")
                small_d.write(name.encode() + b"\n" + dbytes + b"\n")
                st.small_num += 1
                st.small_len += len(seq)
            contig_id += 2
    _t("write files")
    return st


# =========================================================================
# driver
# =========================================================================

def assemble_doubling(table: NodeTable, params: AssembleParams,
                      prefix: str) -> AssembleStats:
    """Full scalable assembly: links -> tips -> lowedges -> bubbles ->
    pointer-doubling readout (phase order per contig.cpp:54-102).  Emits
    the same artifact set as the byte-parity path."""
    import os as _os
    import time as _time
    prof = _os.environ.get("DBG_PD_PROFILE")
    t0 = _time.perf_counter()

    def _t(msg):
        nonlocal t0
        if prof:
            print(f"  [pd] {msg:18s} {_time.perf_counter() - t0:7.2f}s",
                  flush=True)
        t0 = _time.perf_counter()

    g = _Graph(table, params)
    _t("graph init")
    g.calc_links()
    _t("calc_links")
    g.write_kmer_freq(prefix + ".contig.kmer.freq")
    _t("kmer.freq")
    if params.is_remove_tip:
        remove_tips(g, prefix + ".contig.tip.fa")
        _t("tips")
    if params.is_remove_lowedge:
        remove_lowedges(g, prefix + ".contig.lowedge.fa")
        _t("lowedges")
    if params.is_remove_bubble:
        remove_bubbles(g, prefix + ".contig.bubble.fa")
        _t("bubbles")
    read_out_contigs(g, prefix)
    _t("readout")
    return g.stats
