"""Device (JAX) error-correction engine — the accelerator path.

The reference corrector (correct_error/correct.cpp:146-635) is a per-read
sequential recipe; this module re-expresses it as bulk-synchronous batched
array programs so the whole stage runs on the accelerator:

  stage A (one jit):  phase 1 bitmap classification as dense gathers over
      the HBM-resident 1-bit table; region extraction as vectorized
      run-length over k-mer positions; phase 2 fast correction as a
      3-candidate x k-probe tensor op with the sequential change budget
      replayed by a cumulative-sum rule; phase 3 region merge/filter/shave
      as segment ops over fixed region slots.

  stage B (wave loop): phase 4/5 branch-and-bound trees become a
      fixed-width masked BEAM SEARCH (correct.cpp:380-635): a beam lane is
      one alive tree path, carrying its k-mer and its <=2 explicit
      (position, base) changes — no parent-pointer tree or k-mer
      reconstruction walk is needed because a path's change budget is
      bounded.  One wave = the i-th BBT call of every read, so the
      reference's strict per-read sequencing (budget accounting, read
      mutation between calls) is preserved exactly while thousands of
      reads' searches run in lockstep on the device.

Exactness: a read is flagged for HOST FALLBACK when it exceeds the fixed
slot shapes (region/candidate/high-region slots) or a beam overflows W
alive paths.  Beams that never exceed W are provably identical to the
reference BFS (the reference's 5M node cap cannot trigger on a tree whose
level width stays <= W), so non-flagged reads are byte-exact; flagged ones
are re-run on the host engine (correct/engine.py).  On real data overflow
is vanishingly rare (beams hold the few <=2-change paths whose k-mers are
all in the spectrum).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .. import dna

R_MAX = 24    # low/high region slots per read
C_MAX = 6     # phase-2 candidate slots per read
H_MAX = 12    # merged high-region slots per read
BEAM_W = 8    # BBT beam width (alive paths per search).  8 halves the
# per-lane table gathers vs 16; beams that would exceed W overflow to the
# exact host engine, so width is a speed/fallback-rate knob, never a
# correctness one.

_CODE_NP = np.zeros(256, np.uint8)
for _c, _v in zip(b"ACGTNacgtn", (0, 1, 2, 3, 0, 0, 1, 2, 3, 0)):
    _CODE_NP[_c] = _v
_BASES_NP = np.frombuffer(b"ACGT", np.uint8)

BIG = np.int32(1 << 20)


def bitmap_device(bitmap: np.ndarray):
    """Upload the packed 1-bit table as LITTLE-ENDIAN u32 words — the
    layout _probe gathers from.  At k=17 the byte axis is exactly 2^31,
    one past what XLA's x64-index-rewrite pass accepts for a gather
    dimension, and a device-side u8->u32 bitcast would materialize a
    [N,4] intermediate; viewing on the host costs nothing."""
    import jax.numpy as jnp
    return jnp.asarray(np.ascontiguousarray(bitmap).view(np.uint32))


def _probe(bitmap, idx):
    """Vectorized 1-bit table lookup (get_freq, correct_error/seqKmer.cpp:
    102-106).  idx: uint64 k-mer values; returns bool.

    bitmap: u32 words (bitmap_device) or the raw u8 table (bitcast on
    the fly — CPU/test path only).  Bit order: byte b of a little-endian
    word w is (w >> 8b) & 0xFF; bits within a byte are MSB-first
    (seqKmer.cpp:104)."""
    if bitmap.dtype == jnp.uint32:
        words = bitmap
    else:
        words = jax.lax.bitcast_convert_type(bitmap.reshape(-1, 4),
                                             jnp.uint32)
    w = words[(idx >> jnp.uint64(5)).astype(jnp.int64)]
    shift = (jnp.uint64(8) * ((idx >> jnp.uint64(3)) & jnp.uint64(3))
             + (jnp.uint64(7) - (idx & jnp.uint64(7)))).astype(jnp.uint32)
    return ((w >> shift) & jnp.uint32(1)).astype(jnp.bool_)


# ===========================================================================
# Stage A: classification + regions + phase 2 + phase 3
# ===========================================================================

@functools.partial(jax.jit, static_argnames=("k", "m", "max_change"))
def _stage_a(ascii_seq, codes, lengths, bitmap, *, k: int, m: int,
             max_change: int):
    return _stage_a_impl(ascii_seq, codes, lengths,
                         lambda idx: _probe(bitmap, idx),
                         k=k, m=m, max_change=max_change)


def _stage_a_impl(ascii_seq, codes, lengths, probe, *, k: int, m: int,
                  max_change: int):
    """Stage A body with the table lookup abstracted as probe(idx)->bool:
    the single-device path closes over an HBM-resident bitmap (_probe);
    correct/sharded.py passes a collective probe over a mesh-sharded
    table (SURVEY P4: the 4^k-bit table lives sharded in HBM)."""
    N, L = codes.shape
    P = L - k + 1
    Lr = lengths.astype(jnp.int32)
    kn = Lr - k + 1                                    # valid k-mer count

    codes_sq = jnp.where(codes > 3, 0, codes)
    kmers = dna.rolling_kmers(codes_sq, k)             # [N, P] uint64
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    valid = pos < kn[:, None]
    bits = probe(kmers) & valid                        # [N, P] phase 1

    # ---- region extraction (get_cont_kmerfreq_region, correct.cpp:16-69)
    prev = jnp.concatenate([~bits[:, :1], bits[:, :-1]], axis=1)
    first = valid & ((pos == 0) | (bits != prev))
    num_c = jnp.sum(first, axis=1).astype(jnp.int32)
    order = jnp.argsort(~first, axis=1, stable=True)   # firsts to the front
    starts0 = jnp.take_along_axis(
        jnp.broadcast_to(pos, (N, P)), order, axis=1)[:, :R_MAX] \
        .astype(jnp.int32)                             # 0-based kmer index
    r_i = jnp.arange(R_MAX, dtype=jnp.int32)[None, :]
    reg_valid = r_i < num_c[:, None]
    nxt = jnp.concatenate(
        [starts0[:, 1:], jnp.broadcast_to(kn[:, None], (N, 1))], axis=1)
    ends0 = jnp.where(r_i == num_c[:, None] - 1, kn[:, None] - 1, nxt - 1)
    ends0 = jnp.where(reg_valid, ends0, 0).astype(jnp.int32)
    starts0 = jnp.where(reg_valid, starts0, 0)
    status = jnp.take_along_axis(bits, starts0.astype(jnp.int64), axis=1)
    status = (status & reg_valid).astype(jnp.int8)
    fallback = num_c > R_MAX

    # ---- phase 2: fast single-base correction (correct.cpp:74-107,171-192)
    cand = (reg_valid & (r_i >= 1) & (r_i <= num_c[:, None] - 2)
            & (status == 0) & (ends0 - starts0 + 1 == k))
    fallback = fallback | (jnp.sum(cand, axis=1) > C_MAX)
    corder = jnp.argsort(~cand, axis=1, stable=True)[:, :C_MAX]
    c_has = jnp.take_along_axis(cand, corder, axis=1)          # [N, C]
    c_s0 = jnp.take_along_axis(starts0, corder, axis=1)
    c_e0 = jnp.take_along_axis(ends0, corder, axis=1)          # = s0 + k - 1
    err_col = jnp.clip(c_e0.astype(jnp.int64), 0, L - 1)
    orig_ascii = jnp.take_along_axis(ascii_seq, err_col, axis=1)  # [N, C]

    j0 = jnp.arange(k, dtype=jnp.int64)[None, None, :]         # [1,1,k]
    kcol = jnp.clip(c_s0[:, :, None].astype(jnp.int64) + j0, 0, P - 1)
    km = kmers[jnp.arange(N)[:, None, None], kcol]             # [N,C,k]
    shift = (jnp.uint64(2) * j0.astype(jnp.uint64))
    cleared = km & ~(jnp.uint64(3) << shift)
    bases = jnp.arange(4, dtype=jnp.uint64)[None, None, :, None]
    kmod = cleared[:, :, None, :] | (bases << shift[:, :, None, :])
    hits = probe(kmod)                                         # [N,C,4,k]
    bases_ascii = jnp.asarray(_BASES_NP)
    diff = bases_ascii[None, None, :] != orig_ascii[:, :, None]
    succ_b = jnp.all(hits, axis=3) & diff                      # [N,C,4]
    succ = jnp.any(succ_b, axis=2) & c_has
    first_b = jnp.argmax(succ_b, axis=2).astype(jnp.uint8)     # first base
    before = jnp.cumsum(succ, axis=1) - succ.astype(jnp.int32)
    accepted = succ & (before < max_change)
    one_score = jnp.sum(accepted, axis=1).astype(jnp.int32)

    # write accepted bases into the read
    rows = jnp.broadcast_to(jnp.arange(N)[:, None], (N, C_MAX))
    wrow = jnp.where(accepted, rows, N)                        # drop inactive
    new_ascii = ascii_seq.at[wrow, err_col].set(
        bases_ascii[first_b.astype(jnp.int32)], mode="drop")
    # mark corrected regions high
    srow = jnp.where(accepted, rows, N)
    status = status.at[srow, corder].set(1, mode="drop")

    # ---- phase 3: merge + filter + shave (correct.cpp:112-142,201-211)
    s1 = (status == 1) & reg_valid
    s1_prev = jnp.concatenate([jnp.zeros((N, 1), bool), s1[:, :-1]], axis=1)
    s1_next = jnp.concatenate([s1[:, 1:], jnp.zeros((N, 1), bool)], axis=1)
    hfirst = s1 & ~s1_prev
    hlast = s1 & ~s1_next
    forder = jnp.argsort(~hfirst, axis=1, stable=True)
    lorder = jnp.argsort(~hlast, axis=1, stable=True)
    n_runs = jnp.sum(hfirst, axis=1).astype(jnp.int32)
    run_s0 = jnp.take_along_axis(starts0, forder, axis=1)      # [N, R]
    run_e0 = jnp.take_along_axis(ends0, lorder, axis=1)
    run_ok = (r_i < n_runs[:, None]) & (run_e0 - run_s0 + 1 >= m)
    fallback = fallback | (jnp.sum(run_ok, axis=1) > H_MAX)
    qorder = jnp.argsort(~run_ok, axis=1, stable=True)[:, :H_MAX]
    num_h = jnp.sum(run_ok, axis=1).astype(jnp.int32)
    hs1 = jnp.take_along_axis(run_s0, qorder, axis=1) + 1      # 1-based kmer
    he1 = jnp.take_along_axis(run_e0, qorder, axis=1) + 1
    ec = m // 3
    hs1 = jnp.where(hs1 != 1, hs1 + ec, hs1)
    he1 = jnp.where(he1 != kn[:, None], he1 - ec, he1)
    h_i = jnp.arange(H_MAX, dtype=jnp.int32)[None, :]
    h_ok = h_i < num_h[:, None]
    hs1 = jnp.where(h_ok, hs1, 0).astype(jnp.int32)
    he1 = jnp.where(h_ok, he1, 0).astype(jnp.int32)

    return (new_ascii, one_score, hs1, he1, num_h, fallback)


# ===========================================================================
# Stage B: the fixed-width beam-search BBT
# (correct_multi_bases_rightward/leftward, correct.cpp:380-635)
# ===========================================================================

@functools.partial(jax.jit,
                   static_argnames=("k", "rightward", "is_modify_trimmed",
                                    "unroll"))
def _bbt_batch(ascii_seq, lengths, bitmap, active, check_start, check_end,
               max_allowed, last_change_init, *, k: int, rightward: bool,
               is_modify_trimmed: bool, unroll: int = 1):
    """One batched BBT call against an HBM-resident full table."""
    if bitmap.dtype == jnp.uint32:
        words = bitmap
    else:
        words = jax.lax.bitcast_convert_type(bitmap.reshape(-1, 4),
                                             jnp.uint32)
    return _bbt_impl(ascii_seq, lengths, lambda idx: _probe(bitmap, idx),
                     active, check_start, check_end, max_allowed,
                     last_change_init, k=k, rightward=rightward,
                     is_modify_trimmed=is_modify_trimmed, unroll=unroll,
                     probe_word=lambda widx: words[widx])


def _bbt_impl(ascii_seq, lengths, probe, active, check_start, check_end,
              max_allowed, last_change_init, *, k: int, rightward: bool,
              is_modify_trimmed: bool, global_any=None, vary=None,
              unroll: int = 1, probe_word=None):
    """One batched BBT call (every active read searches in lockstep), with
    the table lookup abstracted as probe(idx)->bool — the sharded-table
    corrector (correct/sharded.py) passes the collective probe.

    probe_word(word_idx)->u32, when given, enables the ONE-WORD fast
    path: a lane's 4 rightward children are consecutive k-mer values
    sharing a single u32 table word, and because every correction table
    is RC-CLOSED (the loaders OR in reverse-complement bits,
    main_parallel_senior.cpp:310-329; kmer.count.expand_bitmap_rc), the 4
    leftward children equal rc-space values (rc_kmer<<2 | comp(j)) that
    also share one word — so each lane costs ONE random gather instead
    of four.  The random table gather dominates per-trip device time, so
    this cuts the trip's table traffic 4x.

    check_start/check_end: 1-based base positions (reference cycle range).
    Returns (new_ascii, num_corrected, len_need_trim, last_change, overflow).
    """
    N, L = ascii_seq.shape
    if L > 1022:
        raise ValueError(f"read length {L} exceeds the 10-bit change-slot "
                         "position packing (max 1022)")
    W = BEAM_W
    mask = jnp.uint64((1 << (2 * k)) - 1)
    code_tab = jnp.asarray(_CODE_NP)
    bases_ascii = jnp.asarray(_BASES_NP)
    Lr = lengths.astype(jnp.int32)
    cs = check_start.astype(jnp.int32)
    ce = check_end.astype(jnp.int32)
    ma = jnp.clip(max_allowed, 0, 2).astype(jnp.int32)[:, None, None]

    # anchor: the k-1 bases flanking the walk start (correct.cpp:383,517)
    if rightward:
        a0 = cs - k            # 0-based index of first anchor base
    else:
        a0 = cs                # 0-based: bases cs+1..cs+k-1 (1-based)
    anchor = jnp.zeros((N,), jnp.uint64)
    for t in range(k - 1):
        col = jnp.clip((a0 + t).astype(jnp.int64), 0, L - 1)
        b = code_tab[jnp.take_along_axis(ascii_seq, col[:, None],
                                         axis=1)[:, 0]]
        anchor = (anchor << jnp.uint64(2)) | b.astype(jnp.uint64)
    root = anchor if rightward else (anchor << jnp.uint64(2))

    lane = jnp.arange(W, dtype=jnp.int32)[None, :]
    kmer0 = jnp.broadcast_to(root[:, None], (N, W))
    rkmer0 = jnp.broadcast_to(dna.revcomp_kbit(root, k)[:, None], (N, W)) \
        if probe_word is not None else None
    change0 = jnp.broadcast_to(
        jnp.where(lane == 0, 0, BIG).astype(jnp.int32), (N, W))
    alive0 = (lane == 0) & active[:, None]
    # the <=2 explicit changes of a path ride in ONE packed int32 per lane
    # (pos 10 bits + base 2 bits per slot) instead of [N, W, 2] arrays
    chg0 = jnp.zeros((N, W), jnp.int32)
    cp0 = cs
    span_empty = (cs > ce) if rightward else (cs < ce)
    done0 = ~active | span_empty
    ovf0 = jnp.zeros((N,), bool)

    jj = jnp.arange(4, dtype=jnp.uint64)[None, None, :]

    def cond(st):
        # under shard_map the trip decision must be GLOBALLY uniform (the
        # collective probe inside the body would deadlock if shards exited
        # at different trips): global_any ORs across the mesh
        more = jnp.any(~st[-2])
        return more if global_any is None else global_any(more)

    def one_step(st):
        if probe_word is not None:
            kmer, rkmer, change, alive, chg, cp, done, ovf = st
        else:
            kmer, change, alive, chg, cp, done, ovf = st
            rkmer = None
        running = ~done
        col = jnp.clip((cp - 1).astype(jnp.int64), 0, L - 1)
        rchar = jnp.take_along_axis(ascii_seq, col[:, None], axis=1)[:, 0]

        if rightward:
            ck = ((kmer[:, :, None] << jnp.uint64(2)) | jj) & mask
        else:
            ck = (kmer[:, :, None] >> jnp.uint64(2)) | \
                (jj << jnp.uint64(2 * (k - 1)))
        same = bases_ascii[None, None, :] == rchar[:, None, None]
        cchange = change[:, :, None] + (~same).astype(jnp.int32)
        if probe_word is not None:
            # one gather per lane: the word holding all 4 children
            wkey = ((kmer if rightward else rkmer) << jnp.uint64(2)) & mask
            w = probe_word((wkey >> jnp.uint64(5)).astype(jnp.int64))
            jc = jj if rightward else (jnp.uint64(3) - jj)
            shift = (jnp.uint64(8)
                     * ((wkey[:, :, None] >> jnp.uint64(3)) & jnp.uint64(3))
                     + jnp.uint64(7)
                     - ((wkey[:, :, None] & jnp.uint64(7)) | jc))
            hits = ((w[:, :, None] >> shift.astype(jnp.uint32))
                    & jnp.uint32(1)).astype(jnp.bool_)
        else:
            hits = probe(ck)
        calive = (alive[:, :, None] & (cchange <= ma) & hits
                  & running[:, None, None])
        any_child = jnp.any(calive, axis=(1, 2))
        n_alive = jnp.sum(calive, axis=(1, 2))
        ovf = ovf | (running & (n_alive > W))
        progress = running & any_child

        # compact alive children into W lanes GATHER-FREE: candidate c's
        # destination lane is its alive-prefix rank; every "select by
        # index" becomes a one-hot masked sum over the 4*W candidates
        # (exactly one term survives per lane), so the selection depends
        # on no sort or tie order.
        fa = calive.reshape(N, 4 * W)
        tgt = jnp.cumsum(fa.astype(jnp.int32), axis=1) - 1     # dest lane
        lane_w = jnp.arange(W, dtype=jnp.int32)[None, :, None]
        selm = fa[:, None, :] & (tgt[:, None, :] == lane_w)    # [N,W,64]

        def pick(vals):
            v = vals.reshape(N, 1, 4 * W)
            return jnp.sum(jnp.where(selm, v, 0), axis=2, dtype=v.dtype)

        new_alive = jnp.any(selm, axis=2)
        new_kmer = pick(ck.astype(jnp.int64)).astype(jnp.uint64)
        if probe_word is not None:
            jr = jnp.uint64(3) - jj       # complement of the added base
            if rightward:
                rk = (rkmer[:, :, None] >> jnp.uint64(2)) | \
                    (jr << jnp.uint64(2 * (k - 1)))
            else:
                rk = ((rkmer[:, :, None] << jnp.uint64(2)) | jr) & mask
            new_rkmer = pick(rk.astype(jnp.int64)).astype(jnp.uint64)
        new_change = pick(cchange)
        new_change = jnp.where(new_alive, new_change, BIG)
        pj = pick(jnp.broadcast_to(
            jnp.arange(4, dtype=jnp.int32)[None, None, :], (N, W, 4)))
        rep4 = jnp.broadcast_to(change[:, :, None], (N, W, 4))
        p_change = pick(rep4)
        p_chg = pick(jnp.broadcast_to(chg[:, :, None], (N, W, 4)))
        was_same = pick(jnp.broadcast_to(same, (N, W, 4)).astype(
            jnp.int32)) > 0
        slot = jnp.clip(p_change, 0, 1)                        # 0 or 1
        wr = (~was_same)
        rec = cp[:, None] | (pj << 10)                         # pos|base
        lo = jnp.where(wr & (slot == 0), rec, p_chg & 0xFFF)
        hi = jnp.where(wr & (slot == 1), rec, (p_chg >> 12) & 0xFFF)
        new_chg = lo | (hi << 12)

        pm = progress[:, None]
        kmer = jnp.where(pm, new_kmer, kmer)
        change = jnp.where(pm, new_change, change)
        alive = jnp.where(pm, new_alive, alive)
        chg = jnp.where(pm, new_chg, chg)

        step = 1 if rightward else -1
        cp_next = jnp.where(progress, cp + step, cp)
        out_of_span = (cp_next > ce) if rightward else (cp_next < ce)
        done = done | (running & ~any_child) | (progress & out_of_span)
        if probe_word is not None:
            rkmer = jnp.where(pm, new_rkmer, rkmer)
            return (kmer, rkmer, change, alive, chg, cp_next, done, ovf)
        return (kmer, change, alive, chg, cp_next, done, ovf)

    def body(st):
        # unroll amortizes the while loop's per-iteration fixed cost; the
        # extra steps past a read's end are masked no-ops (done freezes
        # its state), so any unroll factor is semantics-preserving
        for _ in range(unroll):
            st = one_step(st)
        return st

    if probe_word is not None:
        carry0 = (kmer0, rkmer0, change0, alive0, chg0, cp0, done0, ovf0)
    else:
        carry0 = (kmer0, change0, alive0, chg0, cp0, done0, ovf0)
    if global_any is not None:
        # under shard_map some initial carries are REPLICATED constants
        # while the body makes them device-varying; normalize the varying
        # manual axes up front (vary is supplied with the mesh axis)
        carry0 = vary(carry0)
    st = jax.lax.while_loop(cond, body, carry0)
    if probe_word is not None:
        kmer, _rk, change, alive, chg, cp, done, ovf = st
    else:
        kmer, change, alive, chg, cp, done, ovf = st

    ch = jnp.where(alive, change, BIG)
    min_change = jnp.min(ch, axis=1)
    min_path = jnp.sum((ch == min_change[:, None]) & alive, axis=1)
    sel_lane = jnp.argmax((ch == min_change[:, None]) & alive, axis=1)
    lnt = (ce - cp + 1) if rightward else (cp - ce + 1)
    lnt = jnp.where(active, jnp.maximum(lnt, 0), 0)
    ok_trim = (lnt == 0) if not is_modify_trimmed else jnp.ones_like(
        lnt, dtype=bool)
    applied = active & (min_path == 1) & ok_trim & (min_change < BIG)
    num = jnp.where(applied, min_change, 0).astype(jnp.int32)

    rows = jnp.arange(N)
    sel_chg = chg[rows, sel_lane]
    sp = jnp.stack([sel_chg & 1023, (sel_chg >> 12) & 1023], axis=1)
    sb = jnp.stack([(sel_chg >> 10) & 3, (sel_chg >> 22) & 3],
                   axis=1).astype(jnp.uint8)
    used = jnp.arange(2)[None, :] < num[:, None]
    wrow = jnp.where(applied[:, None] & used, rows[:, None], N)
    wcol = jnp.clip((sp - 1).astype(jnp.int64), 0, L - 1)
    new_ascii = ascii_seq.at[wrow, wcol].set(
        bases_ascii[sb.astype(jnp.int32)], mode="drop")

    # last_change bookkeeping (correct.cpp:471-477,599-607): only updated
    # while it still equals the caller's sentinel (read_len+1 rightward /
    # 0 leftward); back-walk order makes it the extreme change position.
    wrote = applied & (num > 0)
    if rightward:
        extreme = jnp.max(jnp.where(used, sp, -BIG), axis=1)
        upd = wrote & (last_change_init == Lr + 1)
    else:
        extreme = jnp.min(jnp.where(used, sp, BIG), axis=1)
        upd = wrote & (last_change_init == 0)
    last_change = jnp.where(upd, extreme, last_change_init).astype(jnp.int32)
    return new_ascii, num, lnt, last_change, ovf


def _bbt_compact(ascii_seq, lengths, probe, active, check_start, check_end,
                 max_allowed, last_change_init, *, k: int, rightward: bool,
                 is_modify_trimmed: bool, compact_c: int, probe_word=None):
    """Active-row compaction around _bbt_impl: gather the (typically few)
    active reads into a fixed compact_c-row batch, run the beam loop
    there, scatter results back.  At k=17 on PE250 only ~16% of reads
    enter gap wave 0 and ~0.6% wave 1 — the while loop's per-trip cost
    drops by N/compact_c for everyone.  Rows beyond compact_c (can only
    happen on pathological inputs) are flagged for HOST FALLBACK, which
    preserves byte-exactness by re-running them from the original read.
    Single-device path only (the sharded corrector keeps full-width calls
    — its trip decision is a mesh collective)."""
    N, L = ascii_seq.shape
    C = min(compact_c, N)
    # the first C active rows, in row order, by prefix count: active row i
    # goes to slot rank(i); each slot receives at most one row, so the
    # scatter has no duplicate indices and no tie order to depend on.
    # Unfilled slots keep row 0 and are inactive (act_c False).
    rank = jnp.cumsum(active.astype(jnp.int32)) - 1
    slot = jnp.where(active & (rank < C), rank, C)
    rows_sel = jnp.zeros((C,), jnp.int32).at[slot].set(
        jnp.arange(N, dtype=jnp.int32), mode="drop")
    act_c = jnp.arange(C, dtype=jnp.int32) < jnp.sum(
        active.astype(jnp.int32))
    dropped = active & (rank >= C)

    asc_c = jnp.take(ascii_seq, rows_sel, axis=0)
    out = _bbt_impl(
        asc_c, jnp.take(lengths, rows_sel), probe, act_c,
        jnp.take(check_start, rows_sel), jnp.take(check_end, rows_sel),
        jnp.take(max_allowed, rows_sel),
        jnp.take(last_change_init, rows_sel),
        k=k, rightward=rightward, is_modify_trimmed=is_modify_trimmed,
        probe_word=probe_word)
    asc_o, num_c, lnt_c, lch_c, ovf_c = out

    wrow = jnp.where(act_c, rows_sel, N)
    new_ascii = ascii_seq.at[wrow].set(asc_o, mode="drop")
    num = jnp.zeros((N,), jnp.int32).at[wrow].set(num_c, mode="drop")
    lnt = jnp.zeros((N,), jnp.int32).at[wrow].set(lnt_c, mode="drop")
    lch = last_change_init.astype(jnp.int32).at[wrow].set(lch_c,
                                                          mode="drop")
    ovf = jnp.zeros((N,), bool).at[wrow].set(ovf_c, mode="drop")
    ovf = ovf | dropped
    return new_ascii, num, lnt, lch, ovf


# ===========================================================================
# Phase 5 region selection (get_max_highFreq_region, correct.cpp:338-374)
# ===========================================================================

@jax.jit
def _max_combined(hs1, he1, num_h, fail):
    """fail: [N, H_MAX] — True at high-region index h if the gap AFTER
    region h failed (phase 4); index num_h-1 is forced failed."""
    N = hs1.shape[0]
    h_i = jnp.arange(H_MAX, dtype=jnp.int32)[None, :]
    h_ok = h_i < num_h[:, None]
    fail = (fail | (h_i == num_h[:, None] - 1)) & h_ok
    # segment start: region 0 or right after a failed region
    prev_fail = jnp.concatenate(
        [jnp.ones((N, 1), bool), fail[:, :-1]], axis=1)
    seg_first = h_ok & prev_fail
    # start position of the segment containing h: cummax of start markers
    seg_start = jax.lax.cummax(
        jnp.where(seg_first, hs1, -BIG), axis=1)
    comb_len = jnp.where(fail, he1 - seg_start + 1, -BIG)
    best = jnp.argmax(comb_len, axis=1)          # first strict max
    rows = jnp.arange(N)
    return seg_start[rows, best], he1[rows, best]


# ===========================================================================
# Driver
# ===========================================================================

def correct_batch_device(ascii_np, codes_np, lengths_np, bitmap_dev, params):
    """Run the full 5-phase recipe on device for one read batch.

    Returns numpy (one, multi, deleted, trim_left, trim_right, ascii_mod,
    fallback) — fallback rows must be re-run on the host engine from the
    ORIGINAL read.
    """
    p = params.resolved()
    k = p.ksize
    m = p.high_freq_reg_len
    mc = p.max_change

    ascii_seq = jnp.asarray(ascii_np)
    codes = jnp.asarray(codes_np)
    lengths = jnp.asarray(lengths_np.astype(np.int32))
    N, L = ascii_np.shape
    Lr = lengths

    ascii_seq, one, hs1, he1, num_h, fallback = _stage_a(
        ascii_seq, codes, lengths, bitmap_dev, k=k, m=m, max_change=mc)

    accum = one
    multi = jnp.zeros((N,), jnp.int32)
    fail = jnp.zeros((N, H_MAX), bool)

    # active-row compaction widths: at k=17 on PE250 ~16% of reads enter
    # gap wave 0 (then ~0.6%), ~2% the phase-5 head walk and ~33% the
    # tail walk; overflow beyond the compact width falls back to the host
    # engine, preserving byte-exactness
    wave_c = max(N // 4, 256)
    p5_c = max(N // 2, 256)

    # ---- phase 4 waves: gap i between high regions i and i+1
    # (one host sync to learn the wave count; the wave itself is one jit)
    n_waves = max(int(jnp.max(num_h)) - 1, 0)
    for i in range(n_waves):
        (ascii_seq, accum, multi, fail, fallback) = _wave_step(
            ascii_seq, lengths, bitmap_dev, hs1, he1, num_h, accum, multi,
            fail, fallback, jnp.int32(i), jnp.int32(mc), k=k,
            compact_c=wave_c)

    # ---- phase 5 (one jit)
    (ascii_seq, multi, deleted, trim_left, trim_right,
     fallback) = _phase5(ascii_seq, lengths, bitmap_dev, hs1, he1, num_h,
                         accum, multi, fail, fallback, k=k, mc=mc,
                         ft=p.further_trim, min_len=p.min_read_len,
                         compact_c=p5_c)

    return (np.asarray(one), np.asarray(multi), np.asarray(deleted),
            np.asarray(trim_left), np.asarray(trim_right),
            np.asarray(ascii_seq), np.asarray(fallback))


@functools.partial(jax.jit,
                   static_argnames=("k", "mc", "ft", "min_len",
                                    "compact_c"))
def _phase5(ascii_seq, lengths, bitmap, hs1, he1, num_h, accum, multi,
            fail, fallback, *, k: int, mc: int, ft: int, min_len: int,
            compact_c: int | None = None):
    """Phase 5 against an HBM-resident full table."""
    words = bitmap if bitmap.dtype == jnp.uint32 else \
        jax.lax.bitcast_convert_type(bitmap.reshape(-1, 4), jnp.uint32)
    return _phase5_impl(ascii_seq, lengths,
                        lambda idx: _probe(bitmap, idx), hs1, he1, num_h,
                        accum, multi, fail, fallback, k=k, mc=mc, ft=ft,
                        min_len=min_len, compact_c=compact_c,
                        probe_word=lambda widx: words[widx])


def _phase5_impl(ascii_seq, lengths, probe, hs1, he1, num_h, accum, multi,
                 fail, fallback, *, k: int, mc: int, ft: int, min_len: int,
                 global_any=None, vary=None, compact_c=None,
                 probe_word=None):
    """Phase 5 (correct.cpp:273-334) as one jitted program: head/tail BBT
    from the max combined high region + Further_trim_len end safety.
    compact_c: active-row compaction width for the head/tail beam calls
    (single-device only)."""
    N = ascii_seq.shape[0]

    def bbt(a, act, cs, ce, ma, lci, rightward):
        if compact_c is not None and global_any is None:
            return _bbt_compact(a, lengths, probe, act, cs, ce, ma, lci,
                                k=k, rightward=rightward,
                                is_modify_trimmed=True,
                                compact_c=compact_c,
                                probe_word=probe_word)
        return _bbt_impl(a, lengths, probe, act, cs, ce, ma, lci,
                         k=k, rightward=rightward, is_modify_trimmed=True,
                         global_any=global_any, vary=vary,
                         probe_word=probe_word if global_any is None
                         else None)
    Lr = lengths
    max_s1, max_e1 = _max_combined(hs1, he1, num_h, fail)
    ok = ~fallback & (num_h > 0)

    # head (correct.cpp:273-290)
    act_h = ok & (max_s1 > 1)
    can_h = act_h & (accum < mc)
    ascii_seq, numh, tl_bbt, left_last, ovf = bbt(
        ascii_seq, can_h, jnp.maximum(max_s1 - 1, 1),
        jnp.ones_like(max_s1), mc - accum, jnp.zeros((N,), jnp.int32),
        rightward=False)
    fallback = fallback | ovf
    got_h = can_h & (numh > 0)
    multi = multi + jnp.where(got_h, numh, 0)
    accum = accum + jnp.where(got_h, numh, 0)
    trim_left = jnp.where(got_h, tl_bbt,
                          jnp.where(act_h, max_s1 - 1, 0)).astype(jnp.int32)
    left_last = jnp.where(got_h, left_last, 0)

    # tail (correct.cpp:292-312)
    high_end = max_e1 + k - 1
    act_t = ok & (high_end < Lr)
    can_t = act_t & (accum < mc)
    ascii_seq, numt, tr_bbt, right_last, ovf = bbt(
        ascii_seq, can_t, jnp.minimum(high_end + 1, Lr), Lr,
        mc - accum, Lr + 1, rightward=True)
    fallback = fallback | ovf
    got_t = can_t & (numt > 0)
    multi = multi + jnp.where(got_t, numt, 0)
    accum = accum + jnp.where(got_t, numt, 0)
    trim_right = jnp.where(got_t, tr_bbt,
                           jnp.where(act_t, Lr - high_end, 0)) \
        .astype(jnp.int32)
    right_last = jnp.where(got_t, right_last, Lr + 1)

    # further end trimming (correct.cpp:317-328)
    tl_more = (trim_left > 0) | ((left_last > 0) & (left_last <= ft))
    trim_left = jnp.where(tl_more & ok, jnp.minimum(trim_left + ft, Lr),
                          trim_left)
    tr_more = (trim_right > 0) | ((right_last < Lr + 1)
                                  & (right_last >= Lr - ft + 1))
    trim_right = jnp.where(tr_more & ok, jnp.minimum(trim_right + ft, Lr),
                           trim_right)

    trim_left = jnp.where(ok, trim_left, 0)
    trim_right = jnp.where(ok, trim_right, 0)
    deleted = jnp.where(
        num_h == 0, 1,
        (Lr - trim_left - trim_right < min_len).astype(jnp.int32))

    return ascii_seq, multi, deleted, trim_left, trim_right, fallback


@functools.partial(jax.jit, static_argnames=("k", "compact_c"))
def _wave_step(ascii_seq, lengths, bitmap, hs1, he1, num_h, accum, multi,
               fail, fallback, i, mc, *, k: int,
               compact_c: int | None = None):
    """Gap wave i against an HBM-resident full table."""
    words = bitmap if bitmap.dtype == jnp.uint32 else \
        jax.lax.bitcast_convert_type(bitmap.reshape(-1, 4), jnp.uint32)
    return _wave_impl(ascii_seq, lengths,
                      lambda idx: _probe(bitmap, idx), hs1, he1, num_h,
                      accum, multi, fail, fallback, i, mc, k=k,
                      compact_c=compact_c,
                      probe_word=lambda widx: words[widx])


def _wave_impl(ascii_seq, lengths, probe, hs1, he1, num_h, accum, multi,
               fail, fallback, i, mc, *, k: int, global_any=None,
               vary=None, compact_c=None, probe_word=None):
    """Gap wave i: rightward BBT, then leftward for the failures
    (correct.cpp:222-263).  compact_c: active-row compaction width
    (single-device only)."""
    N = ascii_seq.shape[0]

    def bbt(a, act, cs, ce, ma, lci, rightward):
        if compact_c is not None and global_any is None:
            return _bbt_compact(a, lengths, probe, act, cs, ce, ma, lci,
                                k=k, rightward=rightward,
                                is_modify_trimmed=False,
                                compact_c=compact_c,
                                probe_word=probe_word)
        return _bbt_impl(a, lengths, probe, act, cs, ce, ma, lci,
                         k=k, rightward=rightward,
                         is_modify_trimmed=False,
                         global_any=global_any, vary=vary,
                         probe_word=probe_word if global_any is None
                         else None)
    rows = jnp.arange(N)
    gap_exists = (i <= num_h - 2)
    budget_ok = accum < mc
    act = gap_exists & budget_ok & ~fallback
    he_i = he1[rows, jnp.clip(i, 0, H_MAX - 1)]
    hs_n = hs1[rows, jnp.clip(i + 1, 0, H_MAX - 1)]

    cs_r = he_i + k                    # high_end+1 where high_end=he1+k-1
    ce_r = hs_n + k - 2                # low region's last base
    ascii_seq, numr, lntr, _, ovf = bbt(
        ascii_seq, act, cs_r, ce_r, mc - accum,
        jnp.full((N,), -1, jnp.int32), rightward=True)
    fallback = fallback | ovf
    ok_r = act & (lntr == 0) & (numr > 0)
    multi = multi + jnp.where(ok_r, numr, 0)
    accum = accum + jnp.where(ok_r, numr, 0)

    act_l = act & ~ok_r
    cs_l = hs_n - 1
    ce_l = he_i + 1
    ascii_seq, numl, lntl, _, ovf = bbt(
        ascii_seq, act_l, cs_l, ce_l, mc - accum,
        jnp.full((N,), -1, jnp.int32), rightward=False)
    fallback = fallback | ovf
    ok_l = act_l & (lntl == 0) & (numl > 0)
    multi = multi + jnp.where(ok_l, numl, 0)
    accum = accum + jnp.where(ok_l, numl, 0)

    failed = gap_exists & ((~budget_ok) | (act_l & ~ok_l))
    col = jnp.full((N,), 0, jnp.int32) + jnp.clip(i, 0, H_MAX - 1)
    fail = fail.at[rows, col].set(fail[rows, col] | failed)
    return ascii_seq, accum, multi, fail, fallback
