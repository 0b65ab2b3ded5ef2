"""De Bruijn graph construction — device bulk path.

The reference ingests reads into a lock-free hash with per-node packed
edge counters (KmerNode{kmer, l_link, r_link} with four 8-bit saturating
counters per side — DBG_contig/kmerSet.h:70-75, DBGgraph.cpp:126-213).

Array replacement (SURVEY.md P2/P5): per batch,
  1. rolling canonical k-mer chop with neighbor-base extraction
     (strand-swapped/complemented when the reverse complement is canonical,
     DBGgraph.cpp:80-89),
  2. stable sort by k-mer,
  3. segment-reduce one-hot left/right neighbor counters and segment-min of
     the global stream index (first-occurrence order, needed to reproduce
     the reference's hash-slot ordering downstream),
then a host-side streaming merge across batches.  No atomics, no CAS: the
k-mer species IS the reduction key.

Parity notes:
  * read length capped at max_read_len (DBGgraph.cpp:63);
  * N treated as A inside k-mers AND as a neighbor base (k-mer alphabet,
    DBG_contig/seqKmer.cpp:15-17);
  * neighbor base = 4 (none) at read boundaries (DBGgraph.cpp:76-89);
  * counter saturation at 255 per increment == min(total, 255);
  * poly-A/T (canonical k-mer == 0) participates like any node here; the
    readout emulator appends it last (DBGgraph.cpp:152-164,417-418).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from .. import dna


def _force_py() -> bool:
    import os
    return os.environ.get("DBG_PY_INGEST") == "1"

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


@functools.partial(jax.jit, static_argnames=("ksize",))
def _chop_with_edges(codes: jnp.ndarray, lengths: jnp.ndarray, ksize: int):
    """[N, L] codes -> per-position (canonical kmer, left, right, valid).

    left/right are 0..3 neighbor codes or 4 when at the read edge, already
    strand-adjusted for canonical orientation.
    """
    N, L = codes.shape
    P = L - ksize + 1
    kmers = dna.rolling_kmers(codes, ksize)                   # [N, P]
    rc = dna.revcomp_kbit(kmers, ksize)
    use_fwd = kmers <= rc                                     # DBGgraph.cpp:80
    can = jnp.where(use_fwd, kmers, rc)

    codes_i = codes.astype(jnp.int32)
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    jlen = lengths.astype(jnp.int32)[:, None]
    has_left = pos > 0
    has_right = pos < (jlen - ksize)
    # left neighbor of window j is base j-1; right neighbor is base j+k
    lshift = jnp.concatenate(
        [jnp.zeros((N, 1), jnp.int32), codes_i[:, :P - 1]], axis=1)
    rshift = codes_i[:, ksize:ksize + P] if ksize + P <= L else \
        jnp.concatenate([codes_i[:, ksize:],
                         jnp.zeros((N, ksize + P - L), jnp.int32)], axis=1)
    left = jnp.where(use_fwd,
                     jnp.where(has_left, lshift, 4),
                     jnp.where(has_right, 3 - rshift, 4))
    right = jnp.where(use_fwd,
                      jnp.where(has_right, rshift, 4),
                      jnp.where(has_left, 3 - lshift, 4))
    valid = pos < (jlen - ksize + 1)
    can = jnp.where(valid, can, SENTINEL)
    return can, left.astype(jnp.int32), right.astype(jnp.int32), valid


@functools.partial(jax.jit, static_argnames=("ksize",))
def _aggregate_batch(codes, lengths, ksize, base_index):
    """Chop one batch and segment-reduce edge counters per unique k-mer.

    Returns (uniq [n], lcnt [n,4], rcnt [n,4], first_idx [n], counts [n],
    n_unique, n_valid) with per-run records left MASKED AT THEIR SORTED
    POSITIONS (SENTINEL/0 at non-run-start slots), n = N*P, mirroring the
    counting path: a device-side compaction sort would cost a second full
    sort, and full-length lax.cummin scans compile pathologically; the
    host compacts with a boolean mask.
    """
    from ..kmer import stats as _stats
    can, left, right, valid = _chop_with_edges(codes, lengths, ksize)
    flat_k = can.reshape(-1)
    flat_l = left.reshape(-1)
    flat_r = right.reshape(-1)
    n = flat_k.shape[0]
    if n >= 2 ** 31:
        raise OverflowError(f"batch of {n} k-mer slots exceeds the int32 "
                            "position index; split the batch")
    stream_idx = base_index + jnp.arange(n, dtype=jnp.int64)

    # ONE two-operand stable sort carries the payloads (no argsort + 4
    # random gathers); stability keeps stream order inside each run, so
    # the run head holds the first occurrence.  The left/right
    # edge codes ride in bits 41-46 of the stream-index operand (payload
    # width sets sort cost; stream positions stay < 2^41 = ~9 Tbp per
    # ingest run, far past any input this pipeline feeds — and the
    # GraphBuilder guards the bound).
    spacked = (stream_idx
               | (flat_l.astype(jnp.int64) << 41)
               | (flat_r.astype(jnp.int64) << 44))
    sk, sp = jax.lax.sort((flat_k, spacked), num_keys=1, is_stable=True)
    sidx = sp & jnp.int64((1 << 41) - 1)
    sl = ((sp >> 41) & 7).astype(jnp.int32)
    sr = ((sp >> 44) & 7).astype(jnp.int32)

    first = jnp.concatenate([jnp.ones((1,), bool), sk[1:] != sk[:-1]])
    first = first & (sk != SENTINEL)
    n_unique = jnp.sum(first.astype(jnp.int64))
    is_valid = (sk != SENTINEL)
    n_valid = jnp.sum(is_valid.astype(jnp.int64))

    # Segment reductions WITHOUT data-dependent gathers/scatters and
    # WITHOUT flat scans: blocked two-level cumsum/reverse-cummin
    # (kmer.stats) — run totals materialize at run-FIRST positions as
    # "cum at run end" minus "cum before me".
    last = jnp.concatenate([sk[1:] != sk[:-1], jnp.ones((1,), bool)])
    last = last & is_valid

    lhot = (sl[:, None] == jnp.arange(4)[None, :]).astype(jnp.int32)
    rhot = (sr[:, None] == jnp.arange(4)[None, :]).astype(jnp.int32)
    lhot = jnp.where(is_valid[:, None], lhot, 0)
    rhot = jnp.where(is_valid[:, None], rhot, 0)
    cum_l = _stats.cumsum_blocked(lhot)       # inclusive, monotone
    cum_r = _stats.cumsum_blocked(rhot)
    BIGI = jnp.int32(2 ** 31 - 1)
    end_l = _stats.rcummin_blocked(
        jnp.where(last[:, None], cum_l, BIGI), BIGI)
    end_r = _stats.rcummin_blocked(
        jnp.where(last[:, None], cum_r, BIGI), BIGI)
    tot_l = end_l - (cum_l - lhot)            # run totals at FIRST positions
    tot_r = end_r - (cum_r - rhot)
    # clip to the counter saturation point: the merge chain ends in
    # min(total, 255), and min commutes with summing pre-clipped parts,
    # so per-batch clipping is exact
    pos32 = jnp.arange(n, dtype=jnp.int32)
    end_pos = _stats.rcummin_blocked(jnp.where(last, pos32, jnp.int32(n)),
                                     jnp.int32(n))
    run_len = end_pos - pos32 + 1

    fm = first
    uniq = jnp.where(fm, sk, SENTINEL)
    first_idx = jnp.where(fm, sidx, jnp.int64(2 ** 62))
    lcnt = jnp.where(fm[:, None], jnp.clip(tot_l, 0, 255), 0)
    rcnt = jnp.where(fm[:, None], jnp.clip(tot_r, 0, 255), 0)
    counts = jnp.where(fm, run_len, 0)
    return uniq, lcnt, rcnt, first_idx, counts, n_unique, n_valid


def _aggregate_batch_np(codes: np.ndarray, lengths: np.ndarray, ksize: int,
                        base_index: int):
    """numpy twin of _aggregate_batch for the CPU backend: numpy's stable
    integer argsort is a radix sort (~10x the XLA CPU comparison sort) and
    np.add.reduceat does the segment sums in one C pass.  Returns compact
    (uniq, lcnt, rcnt, first_idx, n_valid)."""
    N, L = codes.shape
    P = L - ksize + 1
    kmers = dna.rolling_kmers(np.asarray(codes), ksize)
    rc = dna.revcomp_kbit(kmers, ksize)
    use_fwd = kmers <= rc
    can = np.where(use_fwd, kmers, rc)
    codes_i = codes.astype(np.int32)
    pos = np.arange(P, dtype=np.int32)[None, :]
    jlen = lengths.astype(np.int32)[:, None]
    has_left = pos > 0
    has_right = pos < (jlen - ksize)
    lshift = np.concatenate(
        [np.zeros((N, 1), np.int32), codes_i[:, :P - 1]], axis=1)
    rshift = codes_i[:, ksize:ksize + P] if ksize + P <= L else \
        np.concatenate([codes_i[:, ksize:],
                        np.zeros((N, ksize + P - L), np.int32)], axis=1)
    left = np.where(use_fwd,
                    np.where(has_left, lshift, 4),
                    np.where(has_right, 3 - rshift, 4))
    right = np.where(use_fwd,
                     np.where(has_right, rshift, 4),
                     np.where(has_left, 3 - lshift, 4))
    valid = pos < (jlen - ksize + 1)
    flat_k = np.where(valid, can, SENTINEL).reshape(-1)
    n_valid = int(valid.sum())

    order = np.argsort(flat_k, kind="stable")
    sk = flat_k[order]
    sl = left.reshape(-1)[order]
    sr = right.reshape(-1)[order]
    first = np.ones(len(sk), bool)
    first[1:] = sk[1:] != sk[:-1]
    first &= sk != SENTINEL
    starts = np.flatnonzero(first)
    if len(starts) == 0:
        return (np.zeros(0, np.uint64), np.zeros((0, 4), np.int32),
                np.zeros((0, 4), np.int32), np.zeros(0, np.int64),
                np.zeros(0, np.int32), n_valid)
    uniq = sk[starts]
    vmask = sk != SENTINEL
    lcnt = np.empty((len(starts), 4), np.int32)
    rcnt = np.empty((len(starts), 4), np.int32)
    for b in range(4):
        lcnt[:, b] = np.add.reduceat(
            ((sl == b) & vmask).astype(np.int32), starts)
        rcnt[:, b] = np.add.reduceat(
            ((sr == b) & vmask).astype(np.int32), starts)
    # per-batch clip at the 255 saturation point, matching the device
    # kernel's packed-u32 totals (exact: min(total,255) at finalize
    # commutes with summing pre-clipped parts)
    np.minimum(lcnt, 255, out=lcnt)
    np.minimum(rcnt, 255, out=rcnt)
    # stable sort keeps stream order inside each run -> run head is the min
    first_idx = base_index + order[starts].astype(np.int64)
    counts = np.add.reduceat(vmask.astype(np.int32), starts)
    return uniq, lcnt, rcnt, first_idx, counts, n_valid


@dataclass
class NodeTable:
    """Aggregated de Bruijn node table, sorted by k-mer value."""
    kmers: np.ndarray       # [M] uint64 canonical, sorted ascending
    lcnt: np.ndarray        # [M, 4] int32, SATURATED at 255 (the
    rcnt: np.ndarray        # reference's 8-bit counters, kmerSet.cpp:341)
    first_idx: np.ndarray   # [M] int64 first-occurrence stream position
    total_kmers: int = 0
    total_reads: int = 0
    counts: np.ndarray | None = None   # [M] int32 k-mer individuals

    @property
    def n_nodes(self) -> int:
        return len(self.kmers)


def _merge_parts(parts):
    ks = np.concatenate([p[0] for p in parts])
    ls = np.concatenate([p[1] for p in parts])
    rs = np.concatenate([p[2] for p in parts])
    fi = np.concatenate([p[3] for p in parts])
    cn = np.concatenate([p[4] for p in parts])
    order = np.argsort(ks, kind="stable")
    ks, ls, rs, fi, cn = ks[order], ls[order], rs[order], fi[order], \
        cn[order]
    first = np.ones(len(ks), bool)
    first[1:] = ks[1:] != ks[:-1]
    starts = np.flatnonzero(first)
    uniq = ks[first]
    # reduceat promotes int32 -> int64; keep the NodeTable's declared int32
    # (counters are saturated to 255 at every use site)
    lcnt = np.add.reduceat(ls, starts, axis=0).astype(np.int32, copy=False)
    rcnt = np.add.reduceat(rs, starts, axis=0).astype(np.int32, copy=False)
    fmin = np.minimum.reduceat(fi, starts)
    csum = np.add.reduceat(cn, starts).astype(np.int32, copy=False)
    return [(uniq, lcnt, rcnt, fmin, csum)]


class GraphBuilder:
    """Streaming builder: feed read batches, finalize to a NodeTable.

    mesh: a jax Mesh with a 'd' axis switches ingest to the DISTRIBUTED
    path — batches shard over devices, k-mers route to owner shards with
    all_to_all, owners segment-reduce (parallel/count_sharded.py
    graph_ingest_step_exact, the production caller of the exact
    capacity-doubling drop policy).  The finalized NodeTable is
    bit-identical to the single-device builder's (tests/
    test_sharded_graph.py)."""

    def __init__(self, ksize: int, max_read_len: int = 250,
                 batch_reads: int = 100_000, mesh=None):
        self.ksize = ksize
        self.max_read_len = max_read_len
        self.batch_reads = batch_reads
        self.mesh = mesh
        self.parts = []
        self.stream_pos = 0       # global k-mer position counter
        self.total_kmers = 0
        self.total_reads = 0
        self._native = None
        # stream -> read-ordinal mapping for the enlargement/degrade
        # emulation (kmerSet.cpp:132-189, DBGgraph.cpp:337-351): ordinals
        # count EVERY read fed (including <k skips — they occupy reference
        # buffer slots); segments record (stream_base, P, kept_ordinals)
        self.read_seq = 0         # global read ordinal (incl. short reads)
        self.file_starts: list[int] = []
        self._segments: list[tuple[int, int, np.ndarray]] = []

    def new_file(self) -> None:
        """Mark a reference file boundary (buffers never span files)."""
        self.file_starts.append(self.read_seq)

    def stream_to_read(self, stream_idx: np.ndarray) -> np.ndarray:
        """Map stream positions (first_idx values) to global read ordinals."""
        if not self._segments:
            return np.zeros(len(stream_idx), np.int64)
        bases = np.array([s[0] for s in self._segments], np.int64)
        seg = np.searchsorted(bases, stream_idx, side="right") - 1
        out = np.empty(len(stream_idx), np.int64)
        for s in np.unique(seg):
            base, P, ords = self._segments[s]
            m = seg == s
            out[m] = ords[(stream_idx[m] - base) // P]
        return out

    def _add_mesh(self, cb: np.ndarray, lb: np.ndarray) -> None:
        from ..parallel import count_sharded, mesh as meshmod
        k = self.ksize
        n_dev = self.mesh.shape["d"]
        n_rows = len(cb)
        cb = meshmod.pad_to_multiple(np.asarray(cb), n_dev)
        lb = meshmod.pad_to_multiple(np.asarray(lb), n_dev)
        cs, ls = meshmod.shard_batch(self.mesh, cb, lb)
        uniq, lcnt, rcnt, fidx, cnt, n_unique, stats = \
            count_sharded.graph_ingest_step_exact(
                cs, ls, self.stream_pos, ksize=k, mesh=self.mesh)
        un = np.asarray(uniq)
        lc = np.asarray(lcnt)
        rc = np.asarray(rcnt)
        fi = np.asarray(fidx)
        cn = np.asarray(cnt)
        nu = np.asarray(n_unique)
        for d in range(un.shape[0]):
            # per-shard records are masked at sorted positions (round-4
            # gather-free merge); boolean-mask compaction on host
            keep = un[d] != SENTINEL
            if int(keep.sum()) != int(nu[d]):
                raise RuntimeError(
                    f"shard {d}: masked-record count {int(keep.sum())} != "
                    f"reported n_unique {int(nu[d])} — merged node table "
                    "would be corrupt")
            if keep.any():
                self.parts.append((un[d][keep], lc[d][keep], rc[d][keep],
                                   fi[d][keep], cn[d][keep]))
        P = cb.shape[1] - k + 1
        # advance by the UNPADDED extent so stream positions match the
        # single-device builder bit-for-bit; padded rows' (overlapping)
        # positions are never recorded — they have no valid windows
        self.stream_pos += n_rows * P
        self.total_kmers += int(stats["total_kmers"])
        self.total_reads += n_rows
        if len(self.parts) >= 8 * max(1, un.shape[0]):
            self.parts = _merge_parts(self.parts)

    def add(self, codes: np.ndarray, lengths: np.ndarray) -> None:
        if codes.shape[1] > self.max_read_len:
            codes = codes[:, :self.max_read_len]
            lengths = np.minimum(lengths, self.max_read_len)
        k = self.ksize
        for off in range(0, len(codes), self.batch_reads):
            cb = codes[off:off + self.batch_reads]
            lb = lengths[off:off + self.batch_reads]
            # skip reads shorter than k (DBGgraph.cpp:51-53)
            keep = lb >= k
            # stream index must advance PER VALID POSITION in read order;
            # padding positions between reads do not disturb relative order,
            # so a per-batch dense index block is order-correct as long as
            # batches are fed sequentially.
            cb = cb[keep]
            lb = lb[keep]
            if len(cb) == 0:
                continue
            # the packed-payload sort carries edge codes in bits 41-46 of
            # the stream-index operand (_aggregate_batch); fail loudly if a
            # run ever approaches that bound instead of corrupting counters
            P_all = cb.shape[1] - k + 1
            if self.stream_pos + len(cb) * P_all >= (1 << 41):
                raise OverflowError(
                    "ingest stream index would exceed 2^41 positions "
                    f"({self.stream_pos + len(cb) * P_all}); split the run")
            self._segments.append(
                (self.stream_pos, P_all,
                 self.read_seq + off + np.flatnonzero(keep)))
            if self.mesh is not None:
                self._add_mesh(cb, lb)
                continue
            if jax.default_backend() == "cpu" and not _force_py():
                # native streaming table (ingest_engine.cpp): the host twin
                # of the device kernel for CPU-backend runs
                if self._native is None:
                    from .. import native
                    self._native = native.NativeIngest(k)
                self._native.add(cb, lb, self.stream_pos)
                P = cb.shape[1] - k + 1
                self.stream_pos += len(cb) * P
                self.total_reads += int(keep.sum())
                continue
            if jax.default_backend() == "cpu":
                uniq, lcnt, rcnt, fidx, cnt, n_valid = _aggregate_batch_np(
                    np.asarray(cb), np.asarray(lb), k, self.stream_pos)
                self.parts.append((uniq, lcnt, rcnt, fidx, cnt))
            else:
                (uniq, lcnt, rcnt, fidx, cnt, n_uniq,
                 n_valid) = _aggregate_batch(
                    jnp.asarray(cb), jnp.asarray(lb), k,
                    jnp.int64(self.stream_pos))
                # outputs are masked at sorted positions (SENTINEL rows);
                # boolean-mask compaction here is a host memory-bandwidth
                # pass, same as the counting path
                uniq = np.asarray(uniq)
                keep_m = uniq != SENTINEL
                self.parts.append((uniq[keep_m],
                                   np.asarray(lcnt)[keep_m],
                                   np.asarray(rcnt)[keep_m],
                                   np.asarray(fidx)[keep_m],
                                   np.asarray(cnt)[keep_m]))
            P = cb.shape[1] - k + 1
            self.stream_pos += len(cb) * P
            self.total_kmers += int(n_valid)
            self.total_reads += int(keep.sum())
            if len(self.parts) >= 8:
                self.parts = _merge_parts(self.parts)
        self.read_seq += len(codes)

    def finalize(self) -> NodeTable:
        if self._native is not None:
            (kmers, lcnt, rcnt, fidx, counts,
             total) = self._native.extract_full()
            self._native.close()
            self._native = None
            return NodeTable(kmers, lcnt, rcnt, fidx, total,
                             self.total_reads, counts=counts)
        if not self.parts:
            return NodeTable(np.zeros(0, np.uint64), np.zeros((0, 4), np.int32),
                             np.zeros((0, 4), np.int32), np.zeros(0, np.int64),
                             0, self.total_reads,
                             counts=np.zeros(0, np.int32))
        self.parts = _merge_parts(self.parts)
        u, l_, r, f, c = self.parts[0]
        # saturation applies at the END of the merge chain: min(total, 255)
        # equals the native/reference per-increment saturating add
        np.minimum(l_, 255, out=l_)
        np.minimum(r, 255, out=r)
        return NodeTable(u, l_, r, f, self.total_kmers, self.total_reads,
                         counts=c)


def build_from_files(files: list[str], ksize: int, fmt: str = "fq",
                     max_read_len: int = 250) -> NodeTable:
    from ..io import fastq
    gb = GraphBuilder(ksize, max_read_len)
    for path in files:
        batch = fastq.read_batch(path, fmt=fmt, strict_n=False,
                                 keep_heads=False)
        gb.add(batch.codes, batch.lengths)
    return gb.finalize()
