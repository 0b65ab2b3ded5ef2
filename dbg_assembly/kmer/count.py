"""K-mer counting engine — the kmerfreq replacement and benchmark workhorse.

Array design (SURVEY.md section 7 step 2): instead of the reference's
CAS-based shared hash (DBG_contig/DBGgraph.cpp:167-205), counting is a
bulk-synchronous sort + segment-reduce:

  1. chop: rolling canonical k-mer extraction over a [N, L] code batch
     (dna.rolling_kmers — k fused vector ops, no scalar loop),
  2. mask invalid window positions to a sentinel (all-ones uint64),
  3. sort the flat k-mer vector (one single-operand XLA sort),
  4. run-length encode: species boundaries via x[i] != x[i-1],
     counts via index subtraction.

Multi-chip: reads are sharded over the batch dim; each device extracts and
locally sorts, then k-mers are routed to their owner shard by leading bits
with all_to_all and merged (see parallel/alltoall.py).

The k-mer spectrum stat file and the .cz 1-bit table reproduce the external
kmerfreq tool's outputs as specified by their consumers
(correct_error/main.cpp:161-220, main_parallel_senior.cpp:334-408).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .. import dna

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


@functools.partial(jax.jit, static_argnames=("ksize", "sort"))
def chop_canonical(codes: jnp.ndarray, lengths: jnp.ndarray, ksize: int,
                   sort: bool = True):
    """[N, L] codes + [N] lengths -> flat canonical k-mers with invalid
    positions masked to the sentinel (sorted to the end when sort=True).

    Returns (kmers [N*P], n_valid scalar).  sort=False skips the device
    sort for callers that sort downstream themselves — the sort dominates
    this function's cost and must not run twice.
    """
    N, L = codes.shape
    P = L - ksize + 1
    kmers = dna.rolling_kmers(codes, ksize)                # [N, P]
    can, _ = dna.canonical(kmers, ksize)
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    valid = pos < (lengths[:, None] - ksize + 1)
    can = jnp.where(valid, can, SENTINEL)
    flat = can.reshape(-1)
    if sort:
        flat = jnp.sort(flat)
    n_valid = jnp.sum(valid.astype(jnp.int64))
    return flat, n_valid


@functools.partial(jax.jit, static_argnames=("ksize", "max_freq"))
def count_spectrum_fast(codes: jnp.ndarray, lengths: jnp.ndarray,
                        ksize: int, max_freq: int = 255):
    """Single-chip counting fast path: chop + ONE device sort + gather-free
    blocked-window-min stats (kmer.stats.spectrum_sorted).

    This is the benchmark pipeline (BASELINE.json "k-mers counted/sec/chip")
    racing the reference ingest hot loop
    (DBG_contig/DBGgraph.cpp:64-98,167-205).  Returns
    (spectrum [max_freq+1] i64, n_unique i64, n_valid i64).
    """
    from . import stats as _stats
    flat, n_valid = chop_canonical(codes, lengths, ksize, sort=False)
    flat = jnp.sort(flat)
    spectrum, n_unique = _stats.spectrum_sorted(flat, max_freq=max_freq)
    return spectrum, n_unique, n_valid


def _counts_from_first(first: jnp.ndarray, valid: jnp.ndarray):
    """EXACT run lengths at run-start positions, gather-free: a blocked
    reverse cummin of next-boundary indices (stats.rcummin_blocked — the
    flat scan is slower and compiles pathologically).
    Returns (counts_masked [n] i32 with 0 off run starts, n_unique i64).

    Positions are int32: a single batch is capped at 2**31 k-mer slots
    (~2e9 — 86x the production 25M-slot batch; the stream-index bound
    contig/graph.py guards separately is 2**41 ACROSS batches)."""
    from . import stats as _stats
    n = first.shape[0]
    if n >= 2 ** 31:
        raise OverflowError(f"batch of {n} k-mer slots exceeds the int32 "
                            "position index; split the batch")
    # a run also ends where the sentinel tail begins
    to_invalid = jnp.concatenate([jnp.zeros((1,), bool),
                                  valid[:-1] & ~valid[1:]])
    boundary = first | to_invalid
    idx = jnp.arange(n, dtype=jnp.int32)
    BIG = jnp.int32(2 ** 31 - 1)
    fidx = jnp.where(boundary, idx, BIG)
    # next boundary strictly after i
    nxt = _stats.rcummin_blocked(
        jnp.concatenate([fidx[1:], jnp.full((1,), jnp.int32(n))]), BIG)
    nxt = jnp.minimum(nxt, jnp.int32(n))
    counts = jnp.where(first, nxt - idx, 0)
    n_unique = jnp.sum(first.astype(jnp.int64))
    return counts, n_unique


def _runs_masked(sorted_kmers: jnp.ndarray):
    """Run boundaries + EXACT run lengths of a sorted vector, in place.

    Returns (uniq_masked [n] u64 with SENTINEL at non-run-start slots,
    counts_masked [n] i32 with 0 there, n_unique i64).
    """
    x = sorted_kmers
    valid = x != SENTINEL
    first = jnp.concatenate([jnp.ones((1,), bool), x[1:] != x[:-1]]) & valid
    counts, n_unique = _counts_from_first(first, valid)
    uniq = jnp.where(first, x, SENTINEL)
    return uniq, counts, n_unique


@jax.jit
def run_length(sorted_kmers: jnp.ndarray):
    """Run-length encode a sorted vector.

    Returns (unique [M_padded], counts [M_padded], n_unique) where entries
    beyond n_unique hold SENTINEL/0.  M_padded == len(sorted_kmers): XLA
    needs static shapes, so uniques are compacted to the front.

    Gather-free: run lengths come from a blocked reverse cummin and the
    compaction is ONE payload-carrying sort keyed on the sentinel-masked
    k-mer (runs ride to the front in ascending order; counts travel as the
    payload) —
    the same oblivious-compaction trick as contig/graph._aggregate_batch.
    """
    uniq_m, counts_m, n_unique = _runs_masked(sorted_kmers)
    uniq, counts = jax.lax.sort((uniq_m, counts_m), num_keys=1)
    return uniq, counts.astype(jnp.int64), n_unique


@functools.partial(jax.jit, static_argnames=("ksize",))
def count_unique_fast(codes: jnp.ndarray, lengths: jnp.ndarray, ksize: int):
    """PRODUCTION counting kernel: chop + ONE device sort + gather-free
    run-length encode, (unique, counts) left at their sorted positions
    (SENTINEL/0 elsewhere) — no device-side compaction pass.

    This is what KmerCounter/kmerfreq run per batch (the kmerfreq
    replacement for the ingest hot loop DBG_contig/DBGgraph.cpp:167-205 and
    the external counter of correct_error/main.cpp:161-220), and what
    bench.py times.  Host finalize compacts with a boolean mask — a
    memory-bandwidth pass that overlaps the next batch; species order is
    unchanged (masked slots only drop out).
    Returns (uniq_masked [N*P] u64, counts_masked [N*P] i32,
    n_unique i64, n_valid i64).
    """
    flat, n_valid = chop_canonical(codes, lengths, ksize, sort=False)
    flat = jnp.sort(flat)
    uniq_m, counts_m, n_unique = _runs_masked(flat)
    return uniq_m, counts_m, n_unique, n_valid


@functools.partial(jax.jit, static_argnames=("ksize", "row"))
def count_unique_compact(codes: jnp.ndarray, lengths: jnp.ndarray,
                         ksize: int, row: int = 32768):
    """count_unique_fast + device-side compaction by ROW SORT: the masked
    (unique, counts) planes are reshaped to [T, row] and pair-sorted along
    the row axis.  Within a row the masked uniques are already ascending,
    so the row sort is a stable compaction; across rows global order is
    preserved (row r's uniques all precede row r+1's).  A [T,row] sort
    costs less than one monolithic sort.
    Returns (uniq [T,row], counts [T,row], n_per_row [T] i32, n_unique,
    n_valid); host concatenates row prefixes.
    """
    uniq_m, counts_m, n_unique, n_valid = count_unique_fast(
        codes, lengths, ksize)
    n = uniq_m.shape[0]
    pad = (-n) % row
    if pad:
        uniq_m = jnp.concatenate(
            [uniq_m, jnp.full((pad,), SENTINEL, jnp.uint64)])
        counts_m = jnp.concatenate(
            [counts_m, jnp.zeros((pad,), counts_m.dtype)])
    ur = uniq_m.reshape(-1, row)
    cr = counts_m.reshape(-1, row)
    ur, cr = jax.lax.sort((ur, cr), dimension=1, num_keys=1)
    n_per_row = jnp.sum((ur != SENTINEL).astype(jnp.int32), axis=1)
    return ur, cr, n_per_row, n_unique, n_valid


@functools.partial(jax.jit, static_argnames=("max_freq",))
def count_stats(sorted_kmers: jnp.ndarray, max_freq: int = 65535):
    """Spectrum histogram + species count from a sorted k-mer vector,
    WITHOUT compaction (no second sort): run boundaries by neighbor diff,
    run lengths by suffix-min of boundary indices.  This is the fast path
    for counting statistics; run_length() remains for when the compacted
    (unique, counts) arrays themselves are needed.
    """
    x = sorted_kmers
    n = x.shape[0]
    valid = x != SENTINEL
    idx = jnp.arange(n, dtype=jnp.int64)
    first = jnp.concatenate([jnp.ones((1,), bool), x[1:] != x[:-1]]) & valid
    # boundaries: run starts plus the first sentinel position
    to_invalid = jnp.concatenate([jnp.zeros((1,), bool),
                                  valid[:-1] & ~valid[1:]])
    boundary = first | to_invalid
    fidx = jnp.where(boundary, idx, n)
    # next boundary strictly after i: reversed cumulative min of fidx[i+1:]
    nxt = jnp.flip(jax.lax.cummin(jnp.flip(
        jnp.concatenate([fidx[1:], jnp.array([n], jnp.int64)]))))
    counts = jnp.where(first, nxt - idx, 0)
    n_unique = jnp.sum(first.astype(jnp.int64))
    n_valid = jnp.sum(valid.astype(jnp.int64))
    # spectrum histogram WITHOUT scatter-add (a one-element-per-update
    # scatter of the whole k-mer stream): sort the capped run lengths and difference bin edges found by
    # vectorized binary search.  Non-first slots carry count 0 -> bin 0,
    # which the reference spectrum never populates (species counts are >=1),
    # so bin 0 is forced to 0.
    capped = jnp.clip(counts, 0, max_freq).astype(jnp.int32)
    sc = jnp.sort(capped)
    bins = jnp.arange(max_freq + 2, dtype=jnp.int32)
    edges = jnp.searchsorted(sc, bins, side="left")
    spectrum = (edges[1:] - edges[:-1]).astype(jnp.int64)
    spectrum = spectrum.at[0].set(0)
    return spectrum, n_unique, n_valid


def count_batch(codes: np.ndarray, lengths: np.ndarray, ksize: int):
    """Count canonical k-mers of one batch on the default device.

    Device side = count_unique_fast (chop + ONE sort + gather-free RLE);
    the boolean-mask compaction here is a host memory-bandwidth pass, part
    of the same streaming merge KmerCounter already does.
    Returns (unique_sorted np.uint64 [M], counts np.int64 [M], total_kmers).
    """
    uniq_m, counts_m, n_unique, n_valid = count_unique_fast(
        jnp.asarray(codes), jnp.asarray(lengths), ksize)
    uniq_m = np.asarray(uniq_m)
    counts_m = np.asarray(counts_m)
    keep = uniq_m != SENTINEL
    return (uniq_m[keep], counts_m[keep].astype(np.int64), int(n_valid))


def merge_counted(parts: list[tuple[np.ndarray, np.ndarray]]):
    """Merge per-batch (unique, counts) runs on host (streaming reduction)."""
    if len(parts) == 1:
        return parts
    ks = np.concatenate([p[0] for p in parts])
    cs = np.concatenate([p[1] for p in parts])
    order = np.argsort(ks, kind="stable")
    ks, cs = ks[order], cs[order]
    first = np.ones(len(ks), bool)
    first[1:] = ks[1:] != ks[:-1]
    uniq = ks[first]
    csum = np.add.reduceat(cs, np.flatnonzero(first))
    return [(uniq, csum)]


class KmerCounter:
    """Streaming canonical k-mer counter over read batches.

    On a CPU default backend the batches feed the native streaming table
    (native/ingest_engine.cpp, DBG_PY_INGEST=1 reverts to the jax path);
    on device backends the jax chop+sort+run-length kernel counts."""

    def __init__(self, ksize: int, batch_reads: int = 200_000):
        self.ksize = ksize
        self.batch_reads = batch_reads
        self.parts: list[tuple[np.ndarray, np.ndarray]] = []
        self.total_kmers = 0
        self._native = None

    def _use_native(self) -> bool:
        import os
        import jax
        return (jax.default_backend() == "cpu"
                and os.environ.get("DBG_PY_INGEST") != "1")

    def add(self, codes: np.ndarray, lengths: np.ndarray) -> None:
        if self._use_native():
            if self._native is None:
                from .. import native
                self._native = native.NativeIngest(self.ksize)
            for off in range(0, len(codes), self.batch_reads):
                self._native.add(codes[off:off + self.batch_reads],
                                 lengths[off:off + self.batch_reads], 0)
            return
        for off in range(0, len(codes), self.batch_reads):
            u, c, t = count_batch(codes[off:off + self.batch_reads],
                                  lengths[off:off + self.batch_reads],
                                  self.ksize)
            self.parts.append((u, c))
            self.total_kmers += t
            if len(self.parts) >= 8:
                self.parts = merge_counted(self.parts)

    def finalize(self):
        """Returns (unique_sorted, counts, total_kmers)."""
        if self._native is not None:
            u, c, total = self._native.extract_counts()
            self._native.close()
            self._native = None
            return u, c.astype(np.int64), total
        if not self.parts:
            return (np.zeros(0, np.uint64), np.zeros(0, np.int64), 0)
        self.parts = merge_counted(self.parts)
        u, c = self.parts[0]
        return u, c, self.total_kmers


def spectrum(counts: np.ndarray, max_freq: int = 65535) -> np.ndarray:
    """Histogram of species counts, saturated at max_freq (kmerfreq caps its
    16-bit counters at 65535 — clean_reads.lib.kmer.freq.stat:2)."""
    capped = np.minimum(counts, max_freq)
    return np.bincount(capped.astype(np.int64), minlength=max_freq + 1)


def freq_bitmap(unique: np.ndarray, counts: np.ndarray, ksize: int,
                low_freq_cutoff: int = 1) -> np.ndarray:
    """Dense 1-bit-per-kmer high-frequency bitmap over all 4^k indices.

    Bit set at the CANONICAL index iff count > low_freq_cutoff, matching what
    kmerfreq's 1-bit .cz stores before consumers OR in reverse complements
    (main_parallel_senior.cpp:310-329; strict '>' per main.cpp:202).
    """
    total = 1 << (2 * ksize)
    bitmap = np.zeros(total // 8, dtype=np.uint8)
    hi = unique[counts > low_freq_cutoff].astype(np.uint64)
    np.bitwise_or.at(bitmap, (hi // 8).astype(np.int64),
                     (np.uint8(1) << (7 - (hi % 8)).astype(np.uint8)))
    return bitmap


def expand_bitmap_rc(bitmap: np.ndarray, ksize: int) -> np.ndarray:
    """OR reverse-complement bits into the bitmap (consumer-side step,
    main_parallel_senior.cpp:310-329). Returns a new bitmap.

    Only nonzero bytes are expanded (the table is sparse: occupied ratio
    ~1e-3 at k=17), so this stays O(set bits), not O(4^k)."""
    nz = np.flatnonzero(bitmap)
    if len(nz) == 0:
        return bitmap.copy()
    bits = np.unpackbits(bitmap[nz][:, None], axis=1)       # [n, 8] MSB-first
    rows, cols = np.nonzero(bits)
    idx = (nz[rows].astype(np.uint64) << np.uint64(3)) + cols.astype(np.uint64)
    rc = dna.revcomp_kbit(idx, ksize)
    out = bitmap.copy()
    np.bitwise_or.at(out, (rc // 8).astype(np.int64),
                     (np.uint8(1) << (7 - (rc % 8)).astype(np.uint8)))
    return out


def bitmap_get(bitmap: np.ndarray, idx) -> np.ndarray:
    """Query bits (vectorized get_freq, correct_error/seqKmer.cpp:102-106)."""
    idx = np.asarray(idx, dtype=np.uint64)
    return (bitmap[(idx // 8).astype(np.int64)] >>
            (7 - (idx % 8)).astype(np.uint8)) & 1
