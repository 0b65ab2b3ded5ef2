"""Positional unique-k-mer contig index + vectorized seed-and-extend aligner.

Reference: link_scaffold's positional KmerSet maps each canonical contig
k-mer to (contig index, offset, strand, uniqueness) — kmerSet.h:54-61; a
duplicate insert keeps the FIRST payload and clears the uniqueness bit
(add_kmerset, kmerSet.cpp:168-210).  Scaffold inputs are split at N-runs
before chopping (scaffold_to_contig + chop_contig_to_kmerset,
map_func.cpp:119-173,303-324).

Array design: instead of an open-addressing hash, the index is a
k-mer-sorted array searched with vectorized binary search (searchsorted) —
first-inserted payload kept by stable sort, uniqueness = run length 1.

The seed scan (get_align_seed, map_func.cpp:181-237: first position whose
k-mer and the k-mer SeedKmerNum later are both unique, same contig,
consistent spacing) is sequential-with-early-exit in the reference; here
every position's validity is computed in bulk and the winner is the argmax
of the validity mask.  Extension (extend_align_region, map_func.cpp:241-299)
is an ungapped end-to-end comparison — evaluated as one gather + compare
over the full read span per mapped read.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import dna


@dataclass
class ContigIndex:
    kmers: np.ndarray     # [M] uint64 sorted canonical
    ids: np.ndarray       # [M] int32 contig index
    pos: np.ndarray       # [M] int32 offset of k-mer start in contig
    direct: np.ndarray    # [M] uint8 1 = forward canonical
    uniq: np.ndarray      # [M] uint8
    ksize: int
    # concatenated contig bases for extension gathers
    concat: np.ndarray    # [sum len] uint8 ASCII
    offsets: np.ndarray   # [n_contigs + 1] int64
    lengths: np.ndarray   # [n_contigs] int64
    native: object = None  # NativeMapIndex when the native engine is active
    _device: dict = field(default=None, repr=False)  # cached jnp arrays

    def device_arrays(self):
        """Index arrays resident on the default device (cached)."""
        import jax.numpy as jnp
        if self._device is None:
            object.__setattr__(self, "_device", {
                "kmers": jnp.asarray(self.kmers),
                "ids": jnp.asarray(self.ids),
                "pos": jnp.asarray(self.pos),
                "direct": jnp.asarray(self.direct),
                "uniq": jnp.asarray(self.uniq),
                "concat": jnp.asarray(
                    self.concat if len(self.concat)
                    else np.zeros(1, np.uint8)),
                "offsets": jnp.asarray(self.offsets),
                "lengths": jnp.asarray(
                    self.lengths if len(self.lengths)
                    else np.zeros(1, np.int64)),
            })
        return self._device


def _engine() -> str:
    """'py' | 'jax' | 'native' — native on the CPU backend by default,
    the jax device path on accelerators; DBG_PY_MAP / DBG_JAX_MAP force."""
    import os
    if os.environ.get("DBG_PY_MAP") == "1":
        return "py"
    if os.environ.get("DBG_JAX_MAP") == "1":
        return "jax"
    import jax
    return "native" if jax.default_backend() == "cpu" else "jax"


def build(contig_seqs: list[bytes], ksize: int) -> ContigIndex:
    """contig_seqs: raw ASCII per contig slot ('' allowed, skipped)."""
    if _engine() == "native":
        from .. import native
        lengths = np.array([len(s) for s in contig_seqs], dtype=np.int64)
        offsets = np.zeros(len(contig_seqs) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        concat = np.frombuffer(b"".join(contig_seqs), dtype=np.uint8).copy() \
            if contig_seqs else np.zeros(0, np.uint8)
        nmi = native.NativeMapIndex(ksize, concat, offsets)
        z64 = np.zeros(0, np.uint64)
        z32 = np.zeros(0, np.int32)
        z8 = np.zeros(0, np.uint8)
        return ContigIndex(z64, z32, z32, z8, z8, ksize, concat, offsets,
                           lengths, native=nmi)
    return _build_py(contig_seqs, ksize)


def _build_py(contig_seqs: list[bytes], ksize: int) -> ContigIndex:
    all_k, all_id, all_pos, all_dir = [], [], [], []
    lengths = np.array([len(s) for s in contig_seqs], dtype=np.int64)
    offsets = np.zeros(len(contig_seqs) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    concat = np.frombuffer(b"".join(contig_seqs), dtype=np.uint8).copy() \
        if contig_seqs else np.zeros(0, np.uint8)

    for i, seq in enumerate(contig_seqs):
        if len(seq) < ksize:
            continue
        b = np.frombuffer(seq, dtype=np.uint8)
        codes = dna.ascii_to_codes(b, strict_n=False)
        # split at N runs (scaffold_to_contig) — chop each block separately
        isn = (b == ord("N")) | (b == ord("n"))
        if isn.any():
            bounds = np.flatnonzero(np.diff(np.concatenate(
                [[True], isn, [True]]).astype(np.int8)))
            blocks = [(bounds[j], bounds[j + 1])
                      for j in range(0, len(bounds) - 1)
                      if not isn[bounds[j]]]
        else:
            blocks = [(0, len(seq))]
        for s, e in blocks:
            if e - s < ksize:
                continue
            kk = dna.rolling_kmers(codes[s:e], ksize)
            rc = dna.revcomp_kbit(kk, ksize)
            fwd = kk < rc
            can = np.where(fwd, kk, rc)
            all_k.append(can)
            all_id.append(np.full(len(can), i, np.int32))
            all_pos.append((s + np.arange(len(can))).astype(np.int32))
            all_dir.append(fwd.astype(np.uint8))

    if not all_k:
        return ContigIndex(np.zeros(0, np.uint64), np.zeros(0, np.int32),
                           np.zeros(0, np.int32), np.zeros(0, np.uint8),
                           np.zeros(0, np.uint8), ksize, concat, offsets,
                           lengths)
    k = np.concatenate(all_k)
    cid = np.concatenate(all_id)
    cpos = np.concatenate(all_pos)
    cdir = np.concatenate(all_dir)
    order = np.argsort(k, kind="stable")
    k, cid, cpos, cdir = k[order], cid[order], cpos[order], cdir[order]
    first = np.ones(len(k), bool)
    first[1:] = k[1:] != k[:-1]
    starts = np.flatnonzero(first)
    run_len = np.diff(np.concatenate([starts, [len(k)]]))
    uniq_first = (run_len == 1).astype(np.uint8)
    return ContigIndex(k[first], cid[first], cpos[first], cdir[first],
                       uniq_first, ksize, concat, offsets, lengths)


def lookup(ix: ContigIndex, kmers: np.ndarray):
    """Vectorized exist_kmerset: returns (found, ids, pos, direct, uniq)."""
    if ix.native is not None:
        raise RuntimeError(
            "lookup() unavailable on a native index (kmers/ids arrays live "
            "inside the C++ engine) — build with DBG_PY_MAP=1 for array "
            "access")
    loc = np.searchsorted(ix.kmers, kmers)
    loc = np.clip(loc, 0, max(len(ix.kmers) - 1, 0))
    found = (len(ix.kmers) > 0) & (ix.kmers[loc] == kmers)
    return (found, ix.ids[loc], ix.pos[loc], ix.direct[loc], ix.uniq[loc])


@dataclass
class MapResult:
    mapped: np.ndarray            # [N] bool
    contig: np.ndarray            # [N] int32 contig index
    read_start: np.ndarray        # [N] int32 1-based (extended)
    read_end: np.ndarray          # [N]
    contig_start: np.ndarray      # [N]
    contig_end: np.ndarray        # [N]
    direct: np.ndarray            # [N] uint8 1=F
    identity: np.ndarray          # [N] float32


def _identity(has, mm, align_len, min_identity: float):
    """(mapped, identity) from the mismatch count of each alignment.

    Float parity with the reference: identity = float(1.0(double) -
    float(mm/len)), and the cutoff compares float against double, which
    promotes to double (map_pair.cpp:288).  Every engine computes this on
    the host with numpy, so the bytes never depend on a device's division.
    """
    mm = np.asarray(mm)
    align_len = np.asarray(align_len)
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = mm.astype(np.float32) / align_len.astype(np.float32)
    identity = (np.float64(1.0) - frac.astype(np.float64)).astype(np.float32)
    mapped = (np.asarray(has)
              & ~(identity.astype(np.float64) < np.float64(min_identity)))
    return mapped, identity


def map_reads(ix: ContigIndex, codes: np.ndarray, ascii_seq: np.ndarray,
              lengths: np.ndarray, seed_kmer_num: int,
              min_identity: float, search_start=1) -> MapResult:
    """Map each read (first qualifying seed + ungapped extension).

    search_start: scalar or per-read array of 1-based positions to begin the
    seed scan (map_reads' second-alignment pass uses align_read_end+1,
    map_reads.cpp:484)."""
    if ix.native is not None:
        N = codes.shape[0]
        ss = np.asarray(search_start)
        if ss.ndim == 0:
            ss = np.full(N, int(ss), np.int64)
        mapped, cid, rs, re_, cs, ce, dr, ident = ix.native.map(
            codes, ascii_seq, lengths, ss, seed_kmer_num, min_identity)
        return MapResult(mapped=mapped.astype(bool), contig=cid,
                         read_start=rs, read_end=re_, contig_start=cs,
                         contig_end=ce, direct=dr, identity=ident)
    if _engine() == "jax":
        return _map_reads_jax(ix, codes, ascii_seq, lengths, seed_kmer_num,
                              min_identity, search_start)
    k = ix.ksize
    S = seed_kmer_num
    N, L = codes.shape
    P = max(L - k + 1, 0)
    km = dna.rolling_kmers(codes, k)
    rc = dna.revcomp_kbit(km, k)
    read_dir = (km < rc).astype(np.uint8)
    can = np.where(km < rc, km, rc)
    found, cid, cpos, cdir, cuniq = lookup(ix, can.reshape(-1))
    found = found.reshape(N, P)
    cid = cid.reshape(N, P)
    cpos = cpos.reshape(N, P).astype(np.int64)
    cdir = cdir.reshape(N, P)
    cuniq = cuniq.reshape(N, P)

    ok1 = found & (cuniq == 1)
    pos_i = np.arange(P)
    ss = np.asarray(search_start)
    if ss.ndim == 0:
        ss = np.full(N, int(ss), np.int64)
    # i ranges over search_start-1 .. read_len - k - S (inclusive)
    in_range = (pos_i[None, :] >= ss[:, None] - 1) & \
               (pos_i[None, :] <= lengths[:, None].astype(np.int64) - k - S)
    valid_pair = np.zeros((N, P), bool)
    if P > S:
        valid_pair[:, :P - S] = (
            ok1[:, :P - S] & ok1[:, S:]
            & (cid[:, :P - S] == cid[:, S:])
            & (np.abs(cpos[:, S:] - cpos[:, :P - S]) == S))
    valid = valid_pair & in_range
    has = valid.any(axis=1)
    seed_i = np.argmax(valid, axis=1)               # first valid position

    rows = np.arange(N)
    sid = cid[rows, seed_i]
    p1 = cpos[rows, seed_i]
    p2 = cpos[rows, np.minimum(seed_i + S, P - 1)]
    is_f = read_dir[rows, seed_i] == cdir[rows, seed_i]
    seed_contig_start = np.where(is_f, p1 + 1, p2 + 1)
    seed_contig_end = np.where(is_f, p2 + k, p1 + k)
    seed_read_start = seed_i + 1
    seed_read_end = seed_i + S + k

    # ---- extension (vectorized over reads) ----
    Lr = lengths.astype(np.int64)
    clen = ix.lengths[np.clip(sid, 0, max(len(ix.lengths) - 1, 0))] \
        if len(ix.lengths) else np.zeros(N, np.int64)
    coff = ix.offsets[np.clip(sid, 0, max(len(ix.offsets) - 2, 0))] \
        if len(ix.lengths) else np.zeros(N, np.int64)

    # working read coords on the (possibly RC'd) read
    w_start = np.where(is_f, seed_read_start, Lr - seed_read_end + 1)
    w_end = np.where(is_f, seed_read_end, Lr - seed_read_start + 1)
    # extension amounts
    ext_l = np.minimum(w_start - 1, seed_contig_start - 1)
    ext_r = np.minimum(Lr - w_end, clen - seed_contig_end)
    a_read_start = w_start - ext_l
    a_read_end = w_end + ext_r
    a_ctg_start = seed_contig_start - ext_l
    a_ctg_end = seed_contig_end + ext_r
    align_len = a_read_end - a_read_start + 1

    # mismatches: compare read (oriented) to contig over the aligned span
    # contig position of oriented-read position t (1-based):
    #   c = a_ctg_start + (t - a_read_start)
    comp = np.zeros(256, np.uint8)
    for a, b2 in zip(b"ACGTN", b"TGCAN"):
        comp[a] = b2
    # oriented read chars at position t: forward -> ascii[t-1];
    # reverse -> comp[ascii[L - t]]
    # the reference compares ONLY the extension region (seed span assumed
    # exact — extend_align_region starts at the seed edges)
    t = np.arange(1, L + 1)[None, :]                    # [1, L]
    t_in = ((t >= a_read_start[:, None]) & (t <= a_read_end[:, None])
            & ((t < w_start[:, None]) | (t > w_end[:, None])))
    fwd_chars = ascii_seq[:, :L]
    rev_idx = np.clip(Lr[:, None] - t, 0, L - 1)
    rev_chars = comp[np.take_along_axis(ascii_seq, rev_idx, axis=1)]
    oriented = np.where(is_f[:, None], fwd_chars, rev_chars)
    cposx = coff[:, None] + a_ctg_start[:, None] - 1 + (t - a_read_start[:, None])
    cposx = np.clip(cposx, 0, max(len(ix.concat) - 1, 0))
    ctg_chars = ix.concat[cposx] if len(ix.concat) else np.zeros_like(oriented)
    mm = np.sum((oriented != ctg_chars) & t_in, axis=1)
    mapped, identity = _identity(has, mm, align_len, min_identity)

    # map oriented coords back to original read coords for reverse hits
    out_read_start = np.where(is_f, a_read_start, Lr - a_read_end + 1)
    out_read_end = np.where(is_f, a_read_end, Lr - a_read_start + 1)
    return MapResult(mapped=mapped, contig=sid.astype(np.int32),
                     read_start=out_read_start.astype(np.int32),
                     read_end=out_read_end.astype(np.int32),
                     contig_start=a_ctg_start.astype(np.int32),
                     contig_end=a_ctg_end.astype(np.int32),
                     direct=is_f.astype(np.uint8),
                     identity=identity)


# --------------------------------------------------------------------------
# Device (JAX) seed-and-extend path for the positional KmerSet + aligner
# (kmerSet.h:54-61, map_func.cpp:181-299).
#
# The sorted-array index replaces the reference's open-addressing hash with
# vectorized binary search (one jnp.searchsorted gather tree per probe
# batch); the sequential first-qualifying-seed scan (map_func.cpp:185-233)
# becomes an argmax over per-position seed validity (SURVEY.md section 7
# hard part 6); ungapped extension is one gather + compare over the read
# span.  The device returns integer mismatch counts; the float32 identity
# is finished on the host (_identity), bit-exact with the numpy/native
# paths (verified by tests/test_engine_agreement.py).
# --------------------------------------------------------------------------

_COMP_TABLE = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP_TABLE[_a] = _b


def _map_kernel(ixa, codes, ascii_seq, lengths, search_start,
                *, k: int, S: int):
    """Jittable body: ixa = dict of device index arrays.  Returns (has_seed,
    contig, read_start, read_end, contig_start, contig_end, direct,
    mismatches, align_len); _identity turns the last two into the
    alignment identity and the mapped flag."""
    import jax.numpy as jnp

    kmers_ix = ixa["kmers"]
    M = kmers_ix.shape[0]
    N, L = codes.shape
    P = L - k + 1

    km = dna.rolling_kmers(codes, k)
    rc = dna.revcomp_kbit(km, k)
    read_dir = (km < rc).astype(jnp.uint8)
    can = jnp.where(km < rc, km, rc)

    loc = jnp.searchsorted(kmers_ix, can.reshape(-1))
    loc = jnp.clip(loc, 0, max(M - 1, 0))
    found = (M > 0) & (kmers_ix[loc] == can.reshape(-1))
    cid = ixa["ids"][loc].reshape(N, P)
    cpos = ixa["pos"][loc].reshape(N, P).astype(jnp.int64)
    cdir = ixa["direct"][loc].reshape(N, P)
    cuniq = ixa["uniq"][loc].reshape(N, P)
    found = found.reshape(N, P)

    ok1 = found & (cuniq == 1)
    pos_i = jnp.arange(P)
    ss = search_start.astype(jnp.int64)
    Lr = lengths.astype(jnp.int64)
    in_range = (pos_i[None, :] >= ss[:, None] - 1) & \
               (pos_i[None, :] <= Lr[:, None] - k - S)
    if P > S:
        pair = (ok1[:, :P - S] & ok1[:, S:]
                & (cid[:, :P - S] == cid[:, S:])
                & (jnp.abs(cpos[:, S:] - cpos[:, :P - S]) == S))
        valid_pair = jnp.pad(pair, ((0, 0), (0, S)))
    else:
        valid_pair = jnp.zeros((N, P), bool)
    valid = valid_pair & in_range
    has = valid.any(axis=1)
    seed_i = jnp.argmax(valid, axis=1)

    rows = jnp.arange(N)
    sid = cid[rows, seed_i]
    p1 = cpos[rows, seed_i]
    p2 = cpos[rows, jnp.minimum(seed_i + S, P - 1)]
    is_f = read_dir[rows, seed_i] == cdir[rows, seed_i]
    seed_contig_start = jnp.where(is_f, p1 + 1, p2 + 1)
    seed_contig_end = jnp.where(is_f, p2 + k, p1 + k)
    seed_read_start = seed_i + 1
    seed_read_end = seed_i + S + k

    nlen = ixa["lengths"].shape[0]
    clen = ixa["lengths"][jnp.clip(sid, 0, nlen - 1)]
    coff = ixa["offsets"][jnp.clip(sid, 0, max(ixa["offsets"].shape[0] - 2,
                                               0))]

    w_start = jnp.where(is_f, seed_read_start, Lr - seed_read_end + 1)
    w_end = jnp.where(is_f, seed_read_end, Lr - seed_read_start + 1)
    ext_l = jnp.minimum(w_start - 1, seed_contig_start - 1)
    ext_r = jnp.minimum(Lr - w_end, clen - seed_contig_end)
    a_read_start = w_start - ext_l
    a_read_end = w_end + ext_r
    a_ctg_start = seed_contig_start - ext_l
    a_ctg_end = seed_contig_end + ext_r
    align_len = a_read_end - a_read_start + 1

    comp = jnp.asarray(_COMP_TABLE)
    t = jnp.arange(1, L + 1, dtype=jnp.int64)[None, :]
    t_in = ((t >= a_read_start[:, None]) & (t <= a_read_end[:, None])
            & ((t < w_start[:, None]) | (t > w_end[:, None])))
    fwd_chars = ascii_seq[:, :L]
    rev_idx = jnp.clip(Lr[:, None] - t, 0, L - 1)
    rev_chars = comp[jnp.take_along_axis(ascii_seq, rev_idx, axis=1)]
    oriented = jnp.where(is_f[:, None], fwd_chars, rev_chars)
    cposx = coff[:, None] + a_ctg_start[:, None] - 1 + (t - a_read_start[:, None])
    cposx = jnp.clip(cposx, 0, ixa["concat"].shape[0] - 1)
    ctg_chars = ixa["concat"][cposx]
    mm = jnp.sum((oriented != ctg_chars) & t_in, axis=1)

    out_read_start = jnp.where(is_f, a_read_start, Lr - a_read_end + 1)
    out_read_end = jnp.where(is_f, a_read_end, Lr - a_read_start + 1)
    return (has, sid.astype(jnp.int32),
            out_read_start.astype(jnp.int32), out_read_end.astype(jnp.int32),
            a_ctg_start.astype(jnp.int32), a_ctg_end.astype(jnp.int32),
            is_f.astype(jnp.uint8), mm.astype(jnp.int32),
            align_len.astype(jnp.int32))


def map_result(out, min_identity: float, n: int | None = None) -> MapResult:
    """MapResult from _map_kernel's outputs (first n rows)."""
    has, sid, rs, re_, cs, ce, dr, mm, alen = (np.asarray(o)[:n]
                                               for o in out)
    mapped, identity = _identity(has, mm, alen, min_identity)
    return MapResult(mapped=mapped, contig=sid, read_start=rs, read_end=re_,
                     contig_start=cs, contig_end=ce, direct=dr,
                     identity=identity)


_MAP_JIT_CACHE: dict = {}


def _map_reads_jax(ix: ContigIndex, codes, ascii_seq, lengths,
                   seed_kmer_num: int, min_identity: float,
                   search_start=1) -> MapResult:
    import functools
    import jax
    import jax.numpy as jnp

    key = (ix.ksize, seed_kmer_num)
    fn = _MAP_JIT_CACHE.get(key)
    if fn is None:
        fn = jax.jit(functools.partial(_map_kernel, k=ix.ksize,
                                       S=seed_kmer_num))
        _MAP_JIT_CACHE[key] = fn
    N = codes.shape[0]
    ss = np.asarray(search_start)
    if ss.ndim == 0:
        ss = np.full(N, int(ss), np.int64)
    ixa = ix.device_arrays()
    out = fn(ixa, jnp.asarray(codes), jnp.asarray(ascii_seq),
             jnp.asarray(lengths), jnp.asarray(ss))
    return map_result(out, min_identity)
