"""ctypes loader for the native runtime helpers (native/dbg_native.cpp).

Builds the shared library on first use (g++ is part of the baked toolchain).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SO = os.path.join(_ROOT, "native", "build", "libdbg_native.so")
_SRCS = [os.path.join(_ROOT, "native", f)
         for f in ("dbg_native.cpp", "correct_engine.cpp",
                   "assemble_engine.cpp", "ingest_engine.cpp",
                   "map_engine.cpp", "fastq_engine.cpp")]

_lib = None
_lib_lock = threading.Lock()    # callers race here from thread pools
                                # (e.g. map_pair's concurrent pair decode)


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        return _build_and_load()


def _build_and_load() -> ctypes.CDLL:
    global _lib
    # an exclusive file lock makes concurrent processes (test workers, a
    # CPU reference beside a device run) build once and never load a
    # library another process is still writing
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (not os.path.exists(_SO)
                or any(os.path.getmtime(_SO) < os.path.getmtime(s)
                       for s in _SRCS)):
            subprocess.run(["make", "-C", os.path.join(_ROOT, "native")],
                           check=True, capture_output=True)
    # configure signatures on a local before publishing to _lib, so a
    # reader that passes the fast-path None check never sees a
    # half-configured handle
    lo = ctypes.CDLL(_SO)
    _configure(lo)
    _lib = lo
    return _lib


def _configure(_lib: ctypes.CDLL) -> None:
    _lib.jenkins64.restype = ctypes.c_uint64
    _lib.jenkins64.argtypes = [ctypes.c_uint64]
    _lib.find_next_prime.restype = ctypes.c_uint64
    _lib.find_next_prime.argtypes = [ctypes.c_uint64]
    _lib.hash_layout.restype = ctypes.c_int64
    _lib.hash_layout_disp.restype = ctypes.c_int64
    _lib.slot_rank.restype = None
    _lib.seg_argmin.restype = None
    _lib.collect_heads.restype = ctypes.c_int64
    _lib.succ_build.restype = None
    _lib.resolve_chains_host.restype = None
    _lib.madv_huge.restype = None
    _lib.madv_huge.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    _lib.links_pass.restype = None
    _lib.hash_layout_epochs.restype = ctypes.c_int64
    _lib.stdsort_perm_desc.restype = None
    _lib.radix_argsort_u64.restype = None
    _lib.gcc44_sort_perm_desc.restype = None
    _lib.correct_batch.restype = None
    _lib.assemble_run.restype = ctypes.c_int
    _lib.ingest_create.restype = ctypes.c_void_p
    _lib.ingest_create.argtypes = [ctypes.c_int, ctypes.c_uint64]
    _lib.ingest_add.restype = None
    _lib.ingest_add.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint8),
                                ctypes.c_int64, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int32),
                                ctypes.c_int64]
    _lib.ingest_size.restype = ctypes.c_int64
    _lib.ingest_size.argtypes = [ctypes.c_void_p]
    _lib.ingest_reserve.restype = None
    _lib.ingest_reserve.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    _lib.ingest_total.restype = ctypes.c_int64
    _lib.ingest_total.argtypes = [ctypes.c_void_p]
    _lib.ingest_extract.restype = None
    _lib.ingest_extract_full.restype = None
    _lib.ingest_extract_counts.restype = None
    _lib.ingest_free.restype = None
    _lib.ingest_free.argtypes = [ctypes.c_void_p]
    _lib.mapidx_create.restype = ctypes.c_void_p
    _lib.mapidx_create.argtypes = [ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.c_int64]
    _lib.mapidx_free.restype = None
    _lib.mapidx_free.argtypes = [ctypes.c_void_p]
    _lib.mapidx_nkmers.restype = ctypes.c_int64
    _lib.mapidx_nkmers.argtypes = [ctypes.c_void_p]
    _lib.mapidx_map.restype = None
    _lib.fastq_scan.restype = None
    _lib.fastq_fill.restype = None


class NativeIngest:
    """Streaming native chop+aggregate table (native/ingest_engine.cpp)."""

    def __init__(self, ksize: int, capacity_hint: int = 1 << 20):
        self._h = lib().ingest_create(ksize, capacity_hint)

    def add(self, codes: np.ndarray, lengths: np.ndarray,
            base_index: int) -> None:
        c = np.ascontiguousarray(codes, np.uint8)
        ln = np.ascontiguousarray(lengths, np.int32)
        lib().ingest_add(self._h,
                         c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         ctypes.c_int64(c.shape[0]),
                         ctypes.c_int(c.shape[1]),
                         ln.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                         ctypes.c_int64(base_index))

    def n_nodes(self) -> int:
        return int(lib().ingest_size(self._h))

    def reserve(self, expected_nodes: int) -> None:
        """Pre-size the table (one rehash now instead of several doublings
        mid-stream; a large table is harmless — load just drops)."""
        lib().ingest_reserve(self._h, ctypes.c_uint64(expected_nodes))

    def extract(self):
        n = int(lib().ingest_size(self._h))
        total = int(lib().ingest_total(self._h))
        kmers = np.empty(n, np.uint64)
        lcnt = np.empty((n, 4), np.int32)
        rcnt = np.empty((n, 4), np.int32)
        fidx = np.empty(n, np.int64)
        lib().ingest_extract(
            ctypes.c_void_p(self._h),
            kmers.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lcnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            rcnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            fidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return kmers, lcnt, rcnt, fidx, total

    def extract_full(self):
        """One-pass extraction: (kmers, lcnt, rcnt, first_idx, counts,
        total) — single table sort."""
        n = int(lib().ingest_size(self._h))
        total = int(lib().ingest_total(self._h))
        kmers = np.empty(n, np.uint64)
        lcnt = np.empty((n, 4), np.int32)
        rcnt = np.empty((n, 4), np.int32)
        fidx = np.empty(n, np.int64)
        counts = np.empty(n, np.int32)
        lib().ingest_extract_full(
            ctypes.c_void_p(self._h),
            kmers.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lcnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            rcnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            fidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return kmers, lcnt, rcnt, fidx, counts, total

    def extract_counts(self):
        n = int(lib().ingest_size(self._h))
        total = int(lib().ingest_total(self._h))
        kmers = np.empty(n, np.uint64)
        counts = np.empty(n, np.int32)
        lib().ingest_extract_counts(
            ctypes.c_void_p(self._h),
            kmers.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return kmers, counts, total

    def close(self):
        if self._h:
            lib().ingest_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeMapIndex:
    """Positional contig index + seed-and-extend mapper
    (native/map_engine.cpp)."""

    def __init__(self, ksize: int, concat: np.ndarray, offsets: np.ndarray):
        c = np.ascontiguousarray(concat, np.uint8)
        off = np.ascontiguousarray(offsets, np.int64)
        self._h = lib().mapidx_create(
            ksize,
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(len(off) - 1))

    def map(self, codes: np.ndarray, ascii_seq: np.ndarray,
            lengths: np.ndarray, search_start: np.ndarray,
            seed_kmer_num: int, min_identity: float):
        c = np.ascontiguousarray(codes, np.uint8)
        a = np.ascontiguousarray(ascii_seq, np.uint8)
        ln = np.ascontiguousarray(lengths, np.int32)
        ss = np.ascontiguousarray(search_start, np.int64)
        N, L = c.shape
        mapped = np.zeros(N, np.uint8)
        cid = np.zeros(N, np.int32)
        rs = np.zeros(N, np.int32)
        re_ = np.zeros(N, np.int32)
        cs = np.zeros(N, np.int32)
        ce = np.zeros(N, np.int32)
        dr = np.zeros(N, np.uint8)
        ident = np.zeros(N, np.float32)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        i32 = ctypes.POINTER(ctypes.c_int32)
        lib().mapidx_map(
            ctypes.c_void_p(self._h), c.ctypes.data_as(u8),
            a.ctypes.data_as(u8), ctypes.c_int64(N), ctypes.c_int(L),
            ln.ctypes.data_as(i32),
            ss.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int(seed_kmer_num), ctypes.c_double(min_identity),
            mapped.ctypes.data_as(u8), cid.ctypes.data_as(i32),
            rs.ctypes.data_as(i32), re_.ctypes.data_as(i32),
            cs.ctypes.data_as(i32), ce.ctypes.data_as(i32),
            dr.ctypes.data_as(u8),
            ident.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return mapped, cid, rs, re_, cs, ce, dr, ident

    def close(self):
        if self._h:
            lib().mapidx_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def fastq_parse(data: bytes, fq: bool, strict_n: bool = False,
                max_len: int | None = None, keep_ascii: bool = False):
    """Parse a decompressed one-line FASTQ/FASTA buffer into padded
    arrays (native/fastq_engine.cpp; record-selection parity with
    io/fastq.py:_records_from_lines).  Returns (codes, quals, lengths,
    head_off, head_len, ascii_or_None)."""
    buf = np.frombuffer(data, np.uint8)
    p = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    n_rec = ctypes.c_int64()
    mx = ctypes.c_int64()
    lib().fastq_scan(p, ctypes.c_int64(len(buf)), ctypes.c_int(int(fq)),
                     ctypes.byref(n_rec), ctypes.byref(mx))
    n, Lmax = n_rec.value, mx.value
    if max_len is not None:
        Lmax = min(Lmax, max_len)
    codes = np.empty((n, Lmax), np.uint8)
    quals = np.empty((n, Lmax), np.uint8) if fq else np.zeros(
        (n, Lmax), np.uint8)
    aarr = np.empty((n, Lmax), np.uint8) if keep_ascii else None
    lengths = np.empty(n, np.int32)
    hoff = np.empty(n, np.int64)
    hlen = np.empty(n, np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib().fastq_fill(
        p, ctypes.c_int64(len(buf)), ctypes.c_int(int(fq)),
        ctypes.c_int64(Lmax), ctypes.c_int(int(strict_n)),
        codes.ctypes.data_as(u8p),
        quals.ctypes.data_as(u8p) if fq else None,
        aarr.ctypes.data_as(u8p) if aarr is not None else None,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        hoff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        hlen.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return codes, quals, lengths, hoff, hlen, aarr


def jenkins64(x) -> np.ndarray:
    """Vectorized Jenkins 64-bit hash (numpy; parity kmerSet.h:105-116).

    Two allocations total (out + one temp): first-touch page faults on
    fresh buffers cost ~12 us/page on this host, so the naive 8-temporary
    form spent more time faulting than hashing at multi-million scale."""
    with np.errstate(over="ignore"):
        k = np.asarray(x, dtype=np.uint64).copy()
        t = np.empty_like(k)
        for sh, op, inv in ((32, "add", True), (22, "xor", False),
                            (13, "add", True), (8, "xor", False),
                            (3, "add", False), (15, "xor", False),
                            (27, "add", True), (31, "xor", False)):
            if op == "add":
                np.left_shift(k, np.uint64(sh), out=t)
                if inv:
                    np.invert(t, out=t)
                np.add(k, t, out=k)
            else:
                np.right_shift(k, np.uint64(sh), out=t)
                np.bitwise_xor(k, t, out=k)
        return k


def find_next_prime(n: int) -> int:
    return int(lib().find_next_prime(ctypes.c_uint64(n)))


def hash_layout(kmers_in_order: np.ndarray, size: int):
    """Slot assignment for keys inserted in the given order.
    Returns (slots int64 [n], conflicts)."""
    km = np.ascontiguousarray(kmers_in_order, dtype=np.uint64)
    occ = _huge_zeros(size)        # random jenkins probes: see _huge_empty
    out = np.empty(len(km), dtype=np.int64)
    conflicts = lib().hash_layout(
        km.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(len(km)), ctypes.c_uint64(size),
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out, int(conflicts)


def slot_rank(slot_of: np.ndarray, size: int) -> np.ndarray:
    """node -> iteration rank by ascending slot (dense O(size) pass).
    Output hugepaged: the readout's seed pass gathers it at random."""
    so = np.ascontiguousarray(slot_of, dtype=np.int64)
    out = _huge_empty(len(so), np.int64)
    lib().slot_rank(
        so.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(so)), ctypes.c_uint64(size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def succ_build(kmers: np.ndarray, l_base: np.ndarray, r_base: np.ndarray,
               alive: np.ndarray, k: int) -> np.ndarray:
    """Directed successor function over 2M interleaved states (native
    hash-lookup pass; exact twin of pointer_doubling._succ_resolve's
    succ construction)."""
    km = np.ascontiguousarray(kmers, np.uint64)
    lb = np.ascontiguousarray(l_base, np.int32)
    rb = np.ascontiguousarray(r_base, np.int32)
    al = np.ascontiguousarray(alive, np.uint8)
    # huge-paged so resolve_chains_host's random succ[s] chases stay
    # TLB-resident (first touch is succ_build's sequential write)
    out = _huge_empty(2 * len(km), np.int64)
    lib().succ_build(
        km.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(len(km)),
        lb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        al.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(k),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def _huge_empty(n: int, dtype) -> np.ndarray:
    """np.empty marked MADV_HUGEPAGE before first touch: buffers the
    native passes access at random (succ, e, dist) otherwise take a TLB
    miss — which also drops the software prefetch — on nearly every
    probe on this 4K-page host."""
    a = np.empty(n, dtype)
    lib().madv_huge(ctypes.c_void_p(a.ctypes.data), a.nbytes)
    return a


def _huge_zeros(n: int) -> np.ndarray:
    """np.zeros marked MADV_HUGEPAGE before first touch (np.zeros maps
    untouched zero pages, so the mark applies to every later fault)."""
    a = np.zeros(n, np.uint8)
    lib().madv_huge(ctypes.c_void_p(a.ctypes.data), a.nbytes)
    return a


def resolve_chains_host(succ: np.ndarray):
    """Chain resolution over the directed-state successor function — the
    host twin of pointer_doubling._resolve_chains (same (end, dist,
    cyclic) for every non-cyclic state; cyclic states carry only the
    flag).  O(n) chase-from-sources with backfill vs the XLA program's
    O(n log n) doubling gathers."""
    sc = np.ascontiguousarray(succ, np.int64)
    n = len(sc)
    e = _huge_empty(n, np.int64)
    dist = _huge_empty(n, np.int64)
    cyc = _huge_empty(n, np.uint8)
    lib().resolve_chains_host(
        sc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dist.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cyc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return e, dist, cyc.astype(bool)


def collect_heads(alive: np.ndarray, succ: np.ndarray,
                  cyclic: np.ndarray):
    """One-pass chain-head + cyclic-fallback-node collection (native twin
    of the readout's five full-width boolean temporaries).  Returns
    (head_states int64[nh], fallback_nodes int64[nf])."""
    al = np.ascontiguousarray(alive, np.uint8)
    sc = np.ascontiguousarray(succ, np.int64)
    cy = np.ascontiguousarray(cyclic, np.uint8)
    n = len(sc)
    heads = np.empty(n, np.int64)          # virtual until touched
    fb = np.empty(n // 2 + 1, np.int64)
    fbc = ctypes.c_int64(0)
    nh = lib().collect_heads(
        al.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cy.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n),
        heads.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        fb.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(fbc))
    return heads[:nh].copy(), fb[:fbc.value].copy()


def seg_argmin(cid: np.ndarray, key: np.ndarray, n_groups: int):
    """Per-group argmin over (key, index) — native twin of
    lexsort((key, cid)) + unique(cid)[1] first-in-group extraction."""
    ci = np.ascontiguousarray(cid, np.int64)
    ke = np.ascontiguousarray(key, np.int64)
    out = np.empty(n_groups, np.int64)
    lib().seg_argmin(
        ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ke.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(ci)), ctypes.c_int64(n_groups),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def links_pass(lcnt: np.ndarray, rcnt: np.ndarray, cut: int):
    """One-pass link counts / first-strict-max bases / 256-bin depth
    histogram (native twin of pointer_doubling._Graph._links_bulk)."""
    lc = np.ascontiguousarray(lcnt, np.int32)
    rc = np.ascontiguousarray(rcnt, np.int32)
    M = len(lc)
    l_num = np.empty(M, np.int32)
    r_num = np.empty(M, np.int32)
    l_base = np.empty(M, np.int32)
    r_base = np.empty(M, np.int32)
    hist = np.empty(256, np.int64)
    lib().links_pass(
        lc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(M), ctypes.c_int32(cut),
        l_num.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        r_num.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        l_base.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        r_base.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        hist.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return l_num, r_num, l_base, r_base, hist


def hash_layout_disp(kmers_in_order: np.ndarray, size: int):
    """hash_layout + per-node insert displacement (slot - home mod size).
    Returns (slots int64 [n], disp int64 [n], conflicts)."""
    km = np.ascontiguousarray(kmers_in_order, dtype=np.uint64)
    occ = _huge_zeros(size)        # random jenkins probes: see _huge_empty
    out = np.empty(len(km), dtype=np.int64)
    disp = np.empty(len(km), dtype=np.int64)
    conflicts = lib().hash_layout_disp(
        km.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(len(km)), ctypes.c_uint64(size),
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        disp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out, disp, int(conflicts)


def hash_layout_epochs(kmers_in_order: np.ndarray, sizes: list[int],
                       ends: list[int], want_snapshots: bool = True):
    """Slot assignment with hash enlargement (kmerSet.cpp:132-189).

    sizes: [size0, size_after_1st_enlarge, ...]; ends[e] = node count at
    which enlargement e fires (between ingest buffers).  Returns
    (slots int64 [n], insert_conflicts, snapshots int64 [E+1, n] or None)
    where snapshots row e holds each node's slot during epoch e (-1 before
    insertion)."""
    km = np.ascontiguousarray(kmers_in_order, dtype=np.uint64)
    n = len(km)
    n_enl = len(sizes) - 1
    sz = np.asarray(sizes, dtype=np.uint64)
    en = np.asarray(list(ends) + [0], dtype=np.int64)   # never empty
    out = np.empty(n, dtype=np.int64)
    snaps = np.empty((n_enl + 1, n), dtype=np.int64) if want_snapshots \
        else None
    conflicts = lib().hash_layout_epochs(
        km.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(n),
        sz.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        en.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n_enl),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        snaps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)) if snaps
        is not None else None)
    return out, int(conflicts), snaps


def correct_batch(reads: np.ndarray, offsets: np.ndarray, lens: np.ndarray,
                  bits: np.ndarray, bitmap: np.ndarray, params) -> tuple:
    """Native 5-phase correction of a read batch IN PLACE.

    reads: uint8 concatenated read bytes (modified in place);
    offsets/lens per read; bits: [n, P] phase-1 flags (uint8, row stride =
    bits.shape[1]); params: resolved CorrectParams.
    Returns (one_score, multi_score, deleted, trim_left, trim_right).
    """
    n = len(lens)
    one = np.zeros(n, np.int32)
    multi = np.zeros(n, np.int32)
    deleted = np.zeros(n, np.int32)
    tl = np.zeros(n, np.int32)
    tr = np.zeros(n, np.int32)
    L = lib()
    L.correct_batch(
        reads.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.ascontiguousarray(offsets, np.int64).ctypes
        .data_as(ctypes.POINTER(ctypes.c_int64)),
        np.ascontiguousarray(lens, np.int32).ctypes
        .data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(n),
        np.ascontiguousarray(bits, np.uint8).ctypes
        .data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(bits.shape[1] if bits.ndim == 2 else 0),
        bitmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(params.ksize), ctypes.c_int(params.high_freq_reg_len),
        ctypes.c_int(params.max_change), ctypes.c_int(params.further_trim),
        ctypes.c_int64(params.max_bbt_nodes),
        ctypes.c_int(params.min_read_len),
        one.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        multi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        deleted.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        tl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        tr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return one, multi, deleted, tl, tr


def assemble_run(kmer: np.ndarray, lcnt: np.ndarray, rcnt: np.ndarray,
                 n_nodes: int, slot_of: np.ndarray, hash_size: int,
                 slot_order: np.ndarray, prefix: str, params) -> np.ndarray:
    """Full native pruning+readout (native/assemble_engine.cpp); writes the
    eight .contig.* artifacts and returns the int64[15] stats vector.
    lcnt/rcnt are mutated in place (dangling counters zeroed), matching the
    Python path."""
    p = params
    stats = np.zeros(15, np.int64)
    L = lib()
    rc = L.assemble_run(
        np.ascontiguousarray(kmer, np.uint64).ctypes
        .data_as(ctypes.POINTER(ctypes.c_uint64)),
        lcnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rcnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(n_nodes),
        np.ascontiguousarray(slot_of, np.int64).ctypes
        .data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_uint64(hash_size),
        np.ascontiguousarray(slot_order, np.int64).ctypes
        .data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int(p.ksize), ctypes.c_int(p.kmer_freq_cutoff),
        ctypes.c_int(int(p.is_remove_tip)),
        ctypes.c_int(p.tip_len_cutoff),
        ctypes.c_double(p.tip_depth_cutoff),
        ctypes.c_int(int(p.is_remove_lowedge)),
        ctypes.c_int(p.lowedge_len_cutoff),
        ctypes.c_double(p.lowedge_depth_cutoff),
        ctypes.c_int(int(p.is_remove_bubble)),
        ctypes.c_int(p.bubble_len_cutoff),
        ctypes.c_double(p.bubble_len_diff_rate),
        ctypes.c_double(p.bubble_base_diff_rate),
        ctypes.c_int(p.contig_len_cutoff),
        prefix.encode(),
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise OSError(f"assemble_engine could not open an output file "
                      f"under prefix {prefix!r} (see stderr)")
    return stats


def radix_argsort_u64(keys: np.ndarray) -> np.ndarray:
    """Ascending argsort of uint64/int64 keys via native LSD radix
    (stable; ~8x numpy's comparison argsort at the 5M-node scale of
    RefAssembler._build_hash)."""
    k = np.ascontiguousarray(keys, np.uint64)
    out = np.empty(len(k), np.int64)
    lib().radix_argsort_u64(
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(len(k)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def stdsort_perm_desc(lens: np.ndarray) -> np.ndarray:
    """Index permutation of the HOST libstdc++ std::sort, descending by len."""
    ln = np.ascontiguousarray(lens, dtype=np.uint64)
    out = np.empty(len(ln), dtype=np.int64)
    lib().stdsort_perm_desc(
        ln.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(len(ln)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def gcc44_sort_perm_desc(lens: np.ndarray) -> np.ndarray:
    """Index permutation of GCC 4.4's std::sort (the reference binaries'
    compiler), descending by len — reproduces the reference's unstable tie
    order exactly."""
    ln = np.ascontiguousarray(lens, dtype=np.uint64)
    out = np.empty(len(ln), dtype=np.int64)
    lib().gcc44_sort_perm_desc(
        ln.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(len(ln)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out
