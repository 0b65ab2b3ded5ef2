"""Order-exact graph pruning + contig readout over the device-built NodeTable.

The reference's tip/bubble/low-edge removal and contig extraction
(DBG_contig/contig.cpp) are inherently sequential AND order-sensitive: node
processing order is hash-slot order, deletions mutate shared link state, and
output files interleave with the walks.  This module replays that exact
behavior on the host over the bulk-aggregated node table, reproducing:

  * hash-slot ordering via native hash_layout (first-occurrence insertion,
    single-thread semantics; poly-A/T node appended last,
    DBGgraph.cpp:152-164,417-418);
  * calculate_kmer_links (contig.cpp:107-205) vectorized in numpy;
  * remove_error_tips / remove_lowCov_edges / remove_hetero_bubbles /
    read_out_contig (contig.cpp:281-1046) as faithful sequential replays,
    including the reference's quirks: stale tip/branch lists, the
    out-of-table sentinel reading as zeros (mmap'd fresh pages), the
    leftward low-edge header's divergent spacing (contig.cpp:763), unstable
    std::sort tie order (native stdsort_perm_desc), and depth bytes 10/62
    avoidance (contig.cpp:849-851).

The scalable order-free readout for huge graphs lives in pointer_doubling.py;
this module is the bit-parity path and the source of all *.contig.* files.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import native
from ..io import stat as statio
from .graph import NodeTable

BASES = "ACGTN"
C_BASES = "TGCAN"

SENT = -1   # sentinel node id == reference's kset->size (reads as zeros)


def _g6(x: float) -> str:
    return statio.fmt_g6(x)


def _lex(x) -> str:
    if isinstance(x, float):
        return statio.fmt_lexical(x)
    return str(x)


def revcomp_int(kbit: int, k: int) -> int:
    out = 0
    for _ in range(k):
        out = (out << 2) | (3 - (kbit & 3))
        kbit >>= 2
    return out


def bit2seq(kbit: int, k: int) -> str:
    return "".join("ACGT"[(kbit >> (2 * (k - 1 - i))) & 3] for i in range(k))


def global_aligning(seq_i: str, seq_j: str):
    """Needleman-Wunsch, match +3 / mismatch -5 / gap -5, tie preference
    subs >= gap_i >= gap_j (DBG_contig/global_aligning.cpp:20-35,98-182)."""
    gap = -5
    n, m = len(seq_i), len(seq_j)
    score = np.zeros((n + 1, m + 1), dtype=np.int64)
    direct = np.zeros((n + 1, m + 1), dtype=np.int8)
    score[0, 1:] = gap * np.arange(1, m + 1)
    direct[0, 1:] = 1
    score[1:, 0] = gap * np.arange(1, n + 1)
    direct[1:, 0] = 2
    si = np.frombuffer(seq_i.encode(), np.uint8)
    sj = np.frombuffer(seq_j.encode(), np.uint8)
    sub = np.where(si[:, None] == sj[None, :], 3, -5)
    for i in range(1, n + 1):
        srow = score[i - 1]
        subs = srow[:-1] + sub[i - 1]
        row = score[i]
        drow = direct[i]
        for j in range(1, m + 1):
            s = subs[j - 1]
            gi = row[j - 1] + gap
            gj = srow[j] + gap
            if s >= gi and s >= gj:
                row[j] = s
                drow[j] = 0
            elif gi > s and gi >= gj:
                row[j] = gi
                drow[j] = 1
            else:
                row[j] = gj
                drow[j] = 2
    ai, aj = [], []
    pi, pj = n, m
    while pi > 0 or pj > 0:
        d = direct[pi, pj]
        if d == 0:
            ai.append(seq_i[pi - 1])
            aj.append(seq_j[pj - 1])
            pi -= 1
            pj -= 1
        elif d == 1:
            ai.append("-")
            aj.append(seq_j[pj - 1])
            pj -= 1
        else:
            ai.append(seq_i[pi - 1])
            aj.append("-")
            pi -= 1
    return "".join(reversed(ai)), "".join(reversed(aj))


def compare_two_seq_simple(s1: str, s2: str) -> int:
    return sum(1 for a, b in zip(s1, s2) if a != b and a != "-" and b != "-")


@dataclass
class AssembleParams:
    ksize: int = 31
    kmer_freq_cutoff: int = 2          # -D
    init_hash_size: float = 1.0        # -i (units of 1e9 slots)
    load_factor: float = 0.7           # -l
    is_remove_tip: bool = True
    tip_len_cutoff: int = 100
    tip_depth_cutoff: float = 3.0
    is_remove_lowedge: bool = True
    lowedge_len_cutoff: int = 100
    lowedge_depth_cutoff: float = 3.0
    is_remove_bubble: bool = True
    bubble_len_cutoff: int = 100
    bubble_len_diff_rate: float = 0.1
    bubble_base_diff_rate: float = 0.1
    contig_len_cutoff: int = 125       # -M
    max_doublings: int = 10            # -e (DBGgraph.cpp:18)
    buffer_reads: int = 10_000         # -b (enlargement check granularity)


def _cap(size: int, load: float) -> int:
    """max = (uint64)(size * load_factor) with C FLOAT math
    (kmerSet.cpp:113/149: load_factor is a 32-bit float member)."""
    import numpy as np
    return int(np.float32(size) * np.float32(load))


@dataclass
class HashSchedule:
    """Enlargement/degrade plan derived from the first-occurrence read
    ordinals (emulates the between-buffer checks of DBGgraph.cpp:337-351
    and enlarge_kmerset_parallel, kmerSet.cpp:132-189)."""
    sizes: list          # hash size per epoch (len == n_enlarge + 1)
    ends: list           # node count at which each enlargement fires
    enlarge_reads: list  # global read ordinal of each enlargement boundary
    alerts: list         # (global boundary ordinal, Total_reads_num then)
    ingest_ranges: list | None   # [(start, end)] per file; None = no degrade


def compute_hash_schedule(first_read: "np.ndarray", file_starts: list,
                          total_fed: int, params: AssembleParams):
    """Walk the reference's per-buffer capacity checks.  first_read: the
    first-occurrence global read ordinal of every NORMAL node (poly-A
    bypasses the hash during ingest, DBGgraph.cpp:152-164).  A check fires
    only after a FULL buffer (ReadsNum == BufferNum; a file's partial last
    buffer breaks the loop before the check)."""
    import numpy as np
    from .. import native

    p = params
    init = int(p.init_hash_size * 1_000_000_000)
    size = 3 if init < 3 else native.find_next_prime(init)
    cap = _cap(size, p.load_factor)
    b = p.buffer_reads
    fr = np.sort(first_read)
    bounds = list(file_starts) + [total_fed]
    sizes = [size]
    ends: list = []
    enlarge_reads: list = []
    alerts: list = []
    ranges: list = []
    t = 0
    stopped = False
    ingested = 0
    for fi in range(len(file_starts)):
        s, e = bounds[fi], bounds[fi + 1]
        if stopped:
            take = min(b, e - s)
            ranges.append((s, s + take))
            ingested += take
            if e - s >= b:          # full buffer -> the check fires again
                alerts.append((s + b, ingested))
            continue
        i = 1
        while s + i * b <= e:
            q = s + i * b
            c = int(np.searchsorted(fr, q))
            if c > cap:
                if t < p.max_doublings:
                    ns = size
                    while True:     # kmerSet.cpp:137 do-while, float math
                        ns = native.find_next_prime(ns * 2)
                        if not (np.float32(ns) * np.float32(p.load_factor)
                                < np.float32(c + 1)):
                            break
                    sizes.append(ns)
                    ends.append(c)
                    enlarge_reads.append(q)
                    size = ns
                    cap = _cap(size, p.load_factor)
                    t += 1
                else:
                    stopped = True
                    ranges.append((s, q))
                    ingested += q - s
                    alerts.append((q, ingested))
                    break
            i += 1
        if not stopped:
            ranges.append((s, e))
            ingested += e - s
    return HashSchedule(sizes, ends, enlarge_reads, alerts,
                        ranges if stopped else None)


@dataclass
class AssembleStats:
    total_nodes: int = 0
    deleted_lowfreq: int = 0
    linear_nodes: int = 0
    tip_candidates: int = 0
    branch_candidates: int = 0
    tips_removed: int = 0
    tip_len_removed: int = 0
    lowedges_removed: int = 0
    lowedge_len_removed: int = 0
    bubbles_removed: int = 0
    bubble_len_removed: int = 0
    contig_num: int = 0
    contig_len: int = 0
    small_num: int = 0
    small_len: int = 0
    hash_size: int = 0
    hash_conflicts: int = 0         # insert-time probe displacements
    hash_conflicts_occ: int = 0     # per-OCCURRENCE displacements: what the
    # reference's count_conflict accumulates in the ingest CAS loop
    # (DBGgraph.cpp:200) plus the final poly-A insert (DBGgraph.cpp:418)


class RefAssembler:
    """Replays the reference pipeline over a NodeTable (single instance use)."""

    def __init__(self, table: NodeTable, params: AssembleParams,
                 schedule: "HashSchedule | None" = None, epoch_occ=None):
        """schedule/epoch_occ: hash-enlargement emulation (pipeline.py
        computes them when the node count exceeds the initial capacity);
        epoch_occ[e] = per-table-row occurrence counts with read ordinal
        below epoch boundary e (for the count_conflict parity)."""
        self.p = params
        self.k = params.ksize
        self.mask = (1 << (2 * self.k)) - 1
        self.stats = AssembleStats()
        self._build_hash(table, schedule, epoch_occ)

    # ------------------------------------------------------------------ hash
    def _build_hash(self, table: NodeTable, schedule=None, epoch_occ=None):
        p = self.p
        if schedule is not None:
            size = schedule.sizes[-1]
        else:
            init = int(p.init_hash_size * 1_000_000_000)
            size = 3 if init < 3 else native.find_next_prime(init)
        self.size = size
        self.stats.hash_size = size

        kmers = table.kmers
        lcnt = np.minimum(table.lcnt, 255).astype(np.int32)
        rcnt = np.minimum(table.rcnt, 255).astype(np.int32)
        first_idx = table.first_idx
        if not (kmers == 0).any():
            # the reference unconditionally appends a (possibly empty)
            # poly-A node (build_debruijn_graph, DBGgraph.cpp:417-418)
            kmers = np.concatenate([[np.uint64(0)], kmers])
            lcnt = np.concatenate([np.zeros((1, 4), np.int32), lcnt])
            rcnt = np.concatenate([np.zeros((1, 4), np.int32), rcnt])
            first_idx = np.concatenate([[np.int64(2 ** 62)], first_idx])
        M = len(kmers)
        is_polyA = kmers == 0
        normal = np.flatnonzero(~is_polyA)
        # first_idx values are distinct; native LSD radix argsort is
        # stable and ~6x numpy's comparison argsort at 5M nodes
        order = normal[native.radix_argsort_u64(first_idx[normal])]
        if schedule is None and len(order) > _cap(size, p.load_factor):
            raise RuntimeError(
                f"node table ({len(order)}) exceeds hash capacity "
                f"({size}*{p.load_factor}) and no enlargement schedule "
                "was provided (pipeline.run computes one)")
        if len(order) >= size:
            raise RuntimeError(
                f"node table ({len(order)}) would overfill the final hash "
                f"({size}) — the reference would probe forever here")
        counts = table.counts
        if counts is not None and len(counts) != M:
            counts = np.concatenate([[np.int32(0)], counts])
        if schedule is not None and len(schedule.sizes) > 1:
            slots, conflicts, snaps = native.hash_layout_epochs(
                kmers[order], schedule.sizes, schedule.ends)
            self.stats.hash_conflicts = conflicts
            if counts is not None and epoch_occ is not None:
                # occurrences in epoch e probe the epoch-e layout: the
                # buffer whose completion triggers enlargement is inserted
                # (and probed) BEFORE the redistribution
                occ_cum = [np.zeros(M, np.int64)]
                for o in epoch_occ:
                    if len(o) != M:   # poly-A row prepended above
                        o = np.concatenate([[np.int64(0)], o])
                    occ_cum.append(o.astype(np.int64))
                occ_cum.append(counts.astype(np.int64))
                total = 0
                for e in range(len(schedule.sizes)):
                    sz = schedule.sizes[e]
                    sl = snaps[e]
                    ins = sl >= 0
                    home = (native.jenkins64(kmers[order][ins])
                            % np.uint64(sz)).astype(np.int64)
                    disp = (sl[ins] - home) % sz
                    d_occ = (occ_cum[e + 1][order][ins]
                             - occ_cum[e][order][ins])
                    total += int((disp * d_occ).sum())
                self.stats.hash_conflicts_occ = total
        else:
            # per-occurrence conflicts: every occurrence probes the full
            # insert-time displacement of its species (the slot path is
            # frozen at insert); poly-A k-mers bypass the hash
            slots, disp, conflicts = native.hash_layout_disp(kmers[order],
                                                             size)
            self.stats.hash_conflicts = conflicts
            if counts is not None:
                self.stats.hash_conflicts_occ = int(
                    (disp * counts[order].astype(np.int64)).sum())

        # node arrays indexed by node id 0..M-1 (+ sentinel row M of zeros)
        self.kmer = np.concatenate([kmers, [np.uint64(0)]])
        self.lcnt = np.concatenate([lcnt, np.zeros((1, 4), np.int32)])
        self.rcnt = np.concatenate([rcnt, np.zeros((1, 4), np.int32)])
        self.slot_of = np.full(M + 1, -1, np.int64)
        self.slot_of[order] = slots

        # poly-A node: inserted LAST regardless of first occurrence
        # (add_node_to_kmerset probing from jenkins(0)%size)
        occupied = np.zeros(size, bool)
        occupied[slots] = True
        pa = int(np.flatnonzero(is_polyA)[0])
        hc = int(native.jenkins64(np.uint64(0)) % np.uint64(size))
        while occupied[hc]:
            self.stats.hash_conflicts_occ += 1
            hc = 0 if hc + 1 == size else hc + 1
        self.slot_of[pa] = hc
        self.polyA_id = pa
        self.n_nodes = len(self.kmer) - 1     # excludes sentinel
        self.SENT_ID = self.n_nodes           # sentinel row index

        # kmer -> node id lookup (exist_kmerset equivalent) — built lazily:
        # only the Python replay path probes it, and materializing a
        # multi-million-entry dict cost ~10 s the native engine never used
        self._lookup = None

        self.deleted = np.zeros(self.n_nodes + 1, bool)
        # klink fields (+ sentinel row zeros)
        n1 = self.n_nodes + 1
        self.l_num = np.zeros(n1, np.int8)
        self.l_base = np.zeros(n1, np.int8)
        self.r_num = np.zeros(n1, np.int8)
        self.r_base = np.zeros(n1, np.int8)
        self.linear = np.zeros(n1, bool)
        self.in_tip = np.zeros(n1, bool)
        self.in_bubble = np.zeros(n1, bool)
        self.in_lowedge = np.zeros(n1, bool)
        self.in_repeat = np.zeros(n1, bool)

        # slot order for iteration (ascending slot): slots are distinct,
        # so inverting by dense scatter (occ[slot] = id, then compact)
        # replaces a 5M-element argsort with one O(size) pass
        occ_node = np.full(size, -1, np.int64)
        occ_node[self.slot_of[:self.n_nodes]] = np.arange(self.n_nodes)
        self.slot_order = occ_node[occ_node >= 0]

    @property
    def lookup(self) -> dict:
        if self._lookup is None:
            self._lookup = {int(k): i for i, k in enumerate(
                self.kmer[:self.n_nodes])}
            # poly-A key 0 maps to the poly-A node (the normal table never
            # stores kmer 0 twice)
            self._lookup[0] = self.polyA_id
        return self._lookup

    def exist(self, kmer: int) -> int:
        nid = self.lookup.get(kmer, self.SENT_ID)
        if nid != self.SENT_ID and self.deleted[nid]:
            return self.SENT_ID
        return nid

    # --------------------------------------------------------------- klinks
    def calculate_kmer_links(self):
        cut = self.p.kmer_freq_cutoff
        n = self.n_nodes
        l = self.lcnt[:n]
        r = self.rcnt[:n]
        lq = l > cut
        rq = r > cut
        self.l_num[:n] = np.minimum(lq.sum(1), 3)
        self.r_num[:n] = np.minimum(rq.sum(1), 3)
        self.l_base[:n] = np.argmax(np.where(lq, l, 0), axis=1)
        self.r_base[:n] = np.argmax(np.where(rq, r, 0), axis=1)
        self.linear[:n] = (self.l_num[:n] == 1) & (self.r_num[:n] == 1)
        no_links = (self.l_num[:n] == 0) & (self.r_num[:n] == 0)
        self.deleted[:n] |= no_links

        # depth histogram over all 8 counters of every node
        depth_stat = (np.bincount(l.reshape(-1), minlength=256)
                      + np.bincount(r.reshape(-1), minlength=256))
        self.depth_stat = depth_stat

        st = self.stats
        st.total_nodes = n
        st.deleted_lowfreq = int(no_links.sum())
        st.linear_nodes = int(self.linear[:n].sum())
        so = self.slot_order
        self.tip_nodes = so[(self.l_num[so] + self.r_num[so]) == 1]
        self.branch_nodes = so[(self.l_num[so] > 1) | (self.r_num[so] > 1)]
        st.tip_candidates = len(self.tip_nodes)
        st.branch_candidates = len(self.branch_nodes)

    def write_kmer_freq(self, path: str):
        with open(path, "w") as f:
            f.write("Kmer_depth\tAppear_times\n")
            for i in range(1, 256):
                f.write(f"{i}\t{self.depth_stat[i]}\n")

    def recalculate_kmer_links(self, idx: int):
        """Parity: contig.cpp:210-277 (re-validate neighbors, mask dangling)."""
        if idx == self.SENT_ID:
            return
        cut = self.p.kmer_freq_cutoff
        k = self.k
        self.l_num[idx] = 0
        self.l_base[idx] = 0
        self.linear[idx] = False
        maxd = 0
        km = int(self.kmer[idx])
        for j in range(4):
            d = int(self.lcnt[idx, j])
            if d > cut:
                nk = (km >> 2) + (j << (2 * (k - 1)))
                rc = revcomp_int(nk, k)
                nf = nk if nk < rc else rc
                if self.exist(nf) != self.SENT_ID:
                    if self.l_num[idx] < 3:
                        self.l_num[idx] += 1
                    if maxd < d:
                        maxd = d
                        self.l_base[idx] = j
                else:
                    self.lcnt[idx, j] = 0
        self.r_num[idx] = 0
        self.r_base[idx] = 0
        maxd = 0
        for j in range(4):
            d = int(self.rcnt[idx, j])
            if d > cut:
                nk = ((km << 2) | j) & self.mask
                rc = revcomp_int(nk, k)
                nf = nk if nk < rc else rc
                if self.exist(nf) != self.SENT_ID:
                    if self.r_num[idx] < 3:
                        self.r_num[idx] += 1
                    if maxd < d:
                        maxd = d
                        self.r_base[idx] = j
                else:
                    self.rcnt[idx, j] = 0
        if self.l_num[idx] == 1 and self.r_num[idx] == 1:
            self.linear[idx] = True

    # ---------------------------------------------------------------- walks
    def get_linear_path(self, idx: int, walk_direct: int, len_cutoff: int):
        """Parity: contig.cpp:779-827."""
        k = self.k
        original = walk_direct
        path_len = 0
        path_depth = 0
        vec = []
        chars = []
        while True:
            path_len += 1
            vec.append(idx)
            km = int(self.kmer[idx])
            if walk_direct == 1:
                b = int(self.r_base[idx])
                nk = ((km << 2) | b) & self.mask
                path_depth += int(self.rcnt[idx, b])
                chars.append(BASES[b] if original == 1 else C_BASES[b])
            else:
                b = int(self.l_base[idx])
                nk = (km >> 2) + (b << (2 * (k - 1)))
                path_depth += int(self.lcnt[idx, b])
                chars.append(C_BASES[b] if original == 1 else BASES[b])
            rc = revcomp_int(nk, k)
            if nk < rc:
                nf = nk
            else:
                nf = rc
                walk_direct = -walk_direct
            nxt = self.exist(nf)
            if (not self.linear[nxt]) or nxt == self.SENT_ID \
                    or path_len >= len_cutoff:
                last = nxt
                if nxt == self.SENT_ID:
                    mark = "break"
                elif self.l_num[nxt] == 0 or self.r_num[nxt] == 0:
                    mark = "break"
                else:
                    mark = "branch"
                return (path_len, path_depth, vec, "".join(chars), last, mark)
            idx = nxt

    def get_linear_seq(self, idx: int, walk_direct: int):
        """Parity: contig.cpp:832-896 (deletes traversed nodes)."""
        k = self.k
        original = walk_direct
        seq_len = 0
        seq_depth = 0
        chars = []
        depths = bytearray()
        is_repeat = "Unknown"
        while True:
            seq_len += 1
            km = int(self.kmer[idx])
            if walk_direct == 1:
                b = int(self.r_base[idx])
                nk = ((km << 2) | b) & self.mask
                d = int(self.rcnt[idx, b])
                seq_depth += d
                if d in (10, 62):
                    d -= 1
                depths.append(d)
                chars.append(BASES[b] if original == 1 else C_BASES[b])
            else:
                b = int(self.l_base[idx])
                nk = (km >> 2) + (b << (2 * (k - 1)))
                d = int(self.lcnt[idx, b])
                seq_depth += d
                if d in (10, 62):
                    d -= 1
                depths.append(d)
                chars.append(C_BASES[b] if original == 1 else BASES[b])
            rc = revcomp_int(nk, k)
            if nk < rc:
                nf = nk
            else:
                nf = rc
                walk_direct = -walk_direct
            nxt = self.exist(nf)
            if (not self.linear[nxt]) or nxt == self.SENT_ID:
                last = nxt
                if nxt == self.SENT_ID:
                    mark = "break"
                elif self.l_num[nxt] == 0 or self.r_num[nxt] == 0:
                    mark = "break"
                else:
                    mark = "branch"
                    if (walk_direct == 1 and self.r_num[nxt] > 1) or \
                       (walk_direct == -1 and self.l_num[nxt] > 1):
                        is_repeat = "Repeat"
                    else:
                        is_repeat = "Unique"
                return (seq_len, seq_depth, "".join(chars), last, mark,
                        bytes(depths), is_repeat)
            else:
                self.deleted[nxt] = True
                idx = nxt

    # ----------------------------------------------------------------- tips
    def remove_error_tips(self, out_path: str):
        p = self.p
        lines = []
        total_num = 0
        total_len = 0
        for idx in self.tip_nodes:
            idx = int(idx)
            walk = -1 if self.l_num[idx] == 1 else 1
            (tip_len, tip_depth, vec, tip_str, last,
             mark) = self.get_linear_path(idx, walk, p.tip_len_cutoff)
            avg = tip_depth / tip_len
            if avg <= p.tip_depth_cutoff and tip_len <= p.tip_len_cutoff:
                total_num += 1
                total_len += tip_len
                for v in vec:
                    self.deleted[v] = True
                self.recalculate_kmer_links(last)
                self.in_tip[last] = True
                if walk == 1:
                    lkm, lmark = int(self.kmer[idx]), "break"
                    rkm, rmark = int(self.kmer[last]), mark
                else:
                    rkm, rmark = int(self.kmer[idx]), "break"
                    lkm, lmark = int(self.kmer[last]), mark
                kmer_str = bit2seq(int(self.kmer[idx]), self.k)
                out = kmer_str + tip_str if walk == 1 \
                    else tip_str[::-1] + kmer_str
                lines.append(
                    f">tip_{total_num}\tlength: {tip_len + self.k}"
                    f"\tavgDepth: {_g6(avg)}\tLeftEndKmer: {lkm} {lmark}"
                    f"\tRightEndKmer: {rkm} {rmark}\n{out}\n")
        with open(out_path, "w") as f:
            f.writelines(lines)
        self.stats.tips_removed = total_num
        self.stats.tip_len_removed = total_len

    # ------------------------------------------------------------- lowedges
    def _branch_bases(self, cnt_row) -> tuple[list[int], list[int]]:
        cut = self.p.kmer_freq_cutoff
        bases, depths = [], []
        for j in range(4):
            d = int(cnt_row[j])
            if d > cut:
                bases.append(j)
                depths.append(d)
        return bases, depths

    def remove_lowCov_edges(self, out_path: str):
        p = self.p
        k = self.k
        lines = []
        num = 0
        tot_len = 0
        for idx in self.branch_nodes:
            idx = int(idx)
            if self.r_num[idx] >= 2:
                vb, vd = self._branch_bases(self.rcnt[idx])
                for j in range(len(vb)):
                    km = int(self.kmer[idx])
                    nk = ((km << 2) | vb[j]) & self.mask
                    rc = revcomp_int(nk, k)
                    if nk < rc:
                        nf, w1 = nk, 1
                    else:
                        nf, w1 = rc, -1
                    idx1 = self.exist(nf)
                    if not self.linear[idx1]:
                        continue
                    (elen, edep, vec, estr, last,
                     mark) = self.get_linear_path(idx1, w1,
                                                  p.lowedge_len_cutoff)
                    elen += 1
                    edep += vd[j]
                    avg = edep / elen
                    if elen <= p.lowedge_len_cutoff and \
                            avg <= p.lowedge_depth_cutoff and \
                            not self.linear[last]:
                        num += 1
                        tot_len += elen
                        for v in vec:
                            self.deleted[v] = True
                        self.recalculate_kmer_links(last)
                        self.recalculate_kmer_links(idx)
                        self.in_lowedge[idx] = True
                        self.in_lowedge[last] = True
                        kmer_str1 = bit2seq(int(self.kmer[idx1]), k)
                        out1 = kmer_str1 + estr if w1 == 1 \
                            else estr[::-1] + kmer_str1
                        lines.append(
                            f">lowedge_{num}\tlength: {elen + k}"
                            f"\tavgDepth: {_g6(avg)}"
                            f"\tLeftEndKmer: {int(self.kmer[idx])} branch"
                            f"\tRightEndKmer: {int(self.kmer[last])} {mark}"
                            f"\n{out1}\n")
            if self.l_num[idx] >= 2:
                vb, vd = self._branch_bases(self.lcnt[idx])
                for j in range(len(vb)):
                    km = int(self.kmer[idx])
                    nk = (km >> 2) + (vb[j] << (2 * (k - 1)))
                    rc = revcomp_int(nk, k)
                    if nk < rc:
                        nf, w1 = nk, -1
                    else:
                        nf, w1 = rc, 1
                    idx1 = self.exist(nf)
                    if not self.linear[idx1]:
                        continue
                    (elen, edep, vec, estr, last,
                     mark) = self.get_linear_path(idx1, w1,
                                                  p.lowedge_len_cutoff)
                    elen += 1
                    edep += vd[j]
                    avg = edep / elen
                    if elen <= p.lowedge_len_cutoff and \
                            avg <= p.lowedge_depth_cutoff and \
                            not self.linear[last]:
                        num += 1
                        tot_len += elen
                        for v in vec:
                            self.deleted[v] = True
                        self.recalculate_kmer_links(last)
                        self.recalculate_kmer_links(idx)
                        self.in_lowedge[idx] = True
                        self.in_lowedge[last] = True
                        kmer_str1 = bit2seq(int(self.kmer[idx1]), k)
                        out1 = kmer_str1 + estr if w1 == 1 \
                            else estr[::-1] + kmer_str1
                        # NOTE divergent spacing in the reference's leftward
                        # branch (contig.cpp:763) — reproduced deliberately
                        lines.append(
                            f">lowedge_{num}    length:{elen + k}"
                            f"    avgDepth:{_g6(avg)}"
                            f"\tLeftEndKmer: {int(self.kmer[last])} {mark}"
                            f"\tRightEndKmer: {int(self.kmer[idx])} branch"
                            f"\n{out1}\n")
        with open(out_path, "w") as f:
            f.writelines(lines)
        self.stats.lowedges_removed = num
        self.stats.lowedge_len_removed = tot_len

    # -------------------------------------------------------------- bubbles
    def remove_hetero_bubbles(self, out_path: str):
        p = self.p
        k = self.k
        lines = []
        num = 0
        tot_len = 0
        comp = str.maketrans("ACGTN", "TGCAN")
        for idx in self.branch_nodes:
            idx = int(idx)
            if self.l_num[idx] == 2 and self.r_num[idx] == 1:
                walk = -1
                vb, vd = self._branch_bases(self.lcnt[idx])
            elif self.l_num[idx] == 1 and self.r_num[idx] == 2:
                walk = 1
                vb, vd = self._branch_bases(self.rcnt[idx])
            else:
                continue
            km = int(self.kmer[idx])
            if walk == 1:
                nk1 = ((km << 2) | vb[0]) & self.mask
                nk2 = ((km << 2) | vb[1]) & self.mask
            else:
                nk1 = (km >> 2) + (vb[0] << (2 * (k - 1)))
                nk2 = (km >> 2) + (vb[1] << (2 * (k - 1)))
            rc1 = revcomp_int(nk1, k)
            rc2 = revcomp_int(nk2, k)
            if nk1 < rc1:
                nf1, w1 = nk1, walk
            else:
                nf1, w1 = rc1, -walk
            if nk2 < rc2:
                nf2, w2 = nk2, walk
            else:
                nf2, w2 = rc2, -walk
            idx1 = self.exist(nf1)
            idx2 = self.exist(nf2)
            if not self.linear[idx1] or not self.linear[idx2]:
                continue
            (len1, dep1, vec1, str1, last1,
             mark1) = self.get_linear_path(idx1, w1, p.bubble_len_cutoff)
            (len2, dep2, vec2, str2, last2,
             mark2) = self.get_linear_path(idx2, w2, p.bubble_len_cutoff)
            avg1 = dep1 / len1
            avg2 = dep2 / len2
            if last1 != last2:
                if avg1 > p.lowedge_depth_cutoff and \
                        avg2 > p.lowedge_depth_cutoff:
                    self.in_repeat[idx] = True
                continue
            ks1 = bit2seq(int(self.kmer[idx1]), k)
            bs1 = ks1 + str1 if w1 == 1 else str1[::-1] + ks1
            ks2 = bit2seq(int(self.kmer[idx2]), k)
            bs2 = ks2 + str2 if w2 == 1 else str2[::-1] + ks2
            if w1 != w2:
                bs1 = bs1[::-1].translate(comp)
            len1 += 1
            len2 += 1
            dep1 += vd[0]
            dep2 += vd[1]
            diff_rate = 0.0
            btype = ""
            if len1 == len2:
                diff = compare_two_seq_simple(bs1, bs2)
                diff_rate = diff / len1
                btype = "SNP"
            if len1 != len2 or diff_rate > p.bubble_base_diff_rate:
                a1, a2 = global_aligning(bs1, bs2)
                bs1, bs2 = a1, a2
                diff = compare_two_seq_simple(bs1, bs2)
                diff_rate = diff / len1
                btype = "INDEL"
            if diff_rate < p.bubble_base_diff_rate and \
                    abs(len1 - len2) < p.bubble_len_cutoff * \
                    p.bubble_len_diff_rate and \
                    len1 <= p.bubble_len_cutoff and \
                    len2 <= p.bubble_len_cutoff:
                if avg1 < avg2:
                    for v in vec1:
                        self.deleted[v] = True
                    self.recalculate_kmer_links(last1)
                    self.recalculate_kmer_links(idx)
                    num += 1
                    tot_len += len1
                    removed = 1
                else:
                    for v in vec2:
                        self.deleted[v] = True
                    self.recalculate_kmer_links(last2)
                    self.recalculate_kmer_links(idx)
                    num += 1
                    tot_len += len2
                    removed = 2
                if walk == 1:
                    lkm, lmark = int(self.kmer[idx]), "branch"
                    rkm, rmark = int(self.kmer[last1]), mark1
                else:
                    rkm, rmark = int(self.kmer[idx]), "branch"
                    lkm, lmark = int(self.kmer[last1]), mark1
                lines.append(
                    f">bubble_{num}\ttype: {btype}\tlength1: {len1 + k}"
                    f"\tavgDepth1: {_g6(avg1)}\tlength2: {len2 + k}"
                    f"\tavgDepth2: {_g6(avg2)}\tremoved: {removed}"
                    f"\tLeftEndKmer: {lkm} {lmark}"
                    f"\tRightEndKmer: {rkm} {rmark}\n{bs1}\n{bs2}\n")
                self.in_bubble[idx] = True
                self.in_bubble[last1] = True
        with open(out_path, "w") as f:
            f.writelines(lines)
        self.stats.bubbles_removed = num
        self.stats.bubble_len_removed = tot_len

    # -------------------------------------------------------------- readout
    def read_out_contig(self, prefix: str):
        p = self.p
        k = self.k
        recs = []       # (len, header_after_id, seq, depth bytes)
        for i in self.slot_order:
            i = int(i)
            if self.deleted[i] or not self.linear[i]:
                continue
            kmer_str = bit2seq(int(self.kmer[i]), k)
            (rlen, rdep, rstr, rlast, rmark, rdepths,
             rrep) = self.get_linear_seq(i, 1)
            (llen, ldep, lstr, llast, lmark, ldepths,
             lrep) = self.get_linear_seq(i, -1)
            ctype = "RepeatNode" if (lrep == "Repeat" and rrep == "Repeat") \
                else ""
            self.deleted[i] = True
            contig_str = lstr[::-1] + kmer_str + rstr
            contig_len = llen + k + rlen
            contig_depth = (ldep + rdep) / (llen + rlen)
            mid = bytearray()
            dv = int(contig_depth) & 0xFF
            if dv in (10, 62):
                dv -= 1
            mid.extend([dv] * k)
            depth_bytes = ldepths[::-1] + bytes(mid) + rdepths
            header = (f"\tlength: {contig_len}"
                      f"\tavgDepth: {_lex(contig_depth)}"
                      f"\tLeftEndKmer: {int(self.kmer[llast])} "
                      f"{lmark}-{lrep}"
                      f"\tRightEndKmer: {int(self.kmer[rlast])} "
                      f"{rmark}-{rrep}\t{ctype}\n{contig_str}\n")
            recs.append((len(contig_str), header, depth_bytes))

        lens = np.array([r[0] for r in recs], dtype=np.uint64)
        perm = native.gcc44_sort_perm_desc(lens) if len(recs) else []
        ctg_f = open(prefix + ".contig.seq.fa", "w")
        ctg_d = open(prefix + ".contig.seq.depth", "wb")
        small_f = open(prefix + ".contig.small.fa", "w")
        small_d = open(prefix + ".contig.small.depth", "wb")
        st = self.stats
        contig_id = 1
        for pi in perm:
            ln, header, depth_bytes = recs[int(pi)]
            name = f">ctg_{contig_id}"
            if ln >= p.contig_len_cutoff:
                ctg_f.write(name + header)
                ctg_d.write(name.encode() + b"\n" + depth_bytes + b"\n")
                st.contig_num += 1
                st.contig_len += ln
            else:
                small_f.write(name + header)
                small_d.write(name.encode() + b"\n" + depth_bytes + b"\n")
                st.small_num += 1
                st.small_len += ln
            contig_id += 2
        for f in (ctg_f, small_f):
            f.close()
        for f in (ctg_d, small_d):
            f.close()

    # ----------------------------------------------------------------- main
    def run(self, prefix: str) -> AssembleStats:
        import os
        if os.environ.get("DBG_PY_ASSEMBLE") != "1":
            return self.run_native(prefix)
        return self.run_python(prefix)

    def run_native(self, prefix: str) -> AssembleStats:
        """Native engine (native/assemble_engine.cpp): same replay at
        reference-binary speed.  This Python class remains the readable
        specification; DBG_PY_ASSEMBLE=1 switches back to it."""
        p = self.p
        lcnt = np.ascontiguousarray(self.lcnt, np.int32)
        rcnt = np.ascontiguousarray(self.rcnt, np.int32)
        s = native.assemble_run(self.kmer, lcnt, rcnt, self.n_nodes,
                                self.slot_of[:self.n_nodes], self.size,
                                self.slot_order, prefix, p)
        st = self.stats
        (st.total_nodes, st.deleted_lowfreq, st.linear_nodes,
         st.tip_candidates, st.branch_candidates, st.tips_removed,
         st.tip_len_removed, st.lowedges_removed, st.lowedge_len_removed,
         st.bubbles_removed, st.bubble_len_removed, st.contig_num,
         st.contig_len, st.small_num, st.small_len) = (int(x) for x in s)
        return st

    def run_python(self, prefix: str) -> AssembleStats:
        p = self.p
        self.calculate_kmer_links()
        self.write_kmer_freq(prefix + ".contig.kmer.freq")
        if p.is_remove_tip:
            self.remove_error_tips(prefix + ".contig.tip.fa")
            self.tip_nodes = np.zeros(0, np.int64)
        if p.is_remove_lowedge:
            self.remove_lowCov_edges(prefix + ".contig.lowedge.fa")
        if p.is_remove_bubble:
            self.remove_hetero_bubbles(prefix + ".contig.bubble.fa")
            self.branch_nodes = np.zeros(0, np.int64)
        self.read_out_contig(prefix)
        return self.stats
