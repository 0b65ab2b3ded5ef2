"""clean_lowqual — quality-block read trimming, vectorized.

Reference semantics (clean_illumina/clean_lowqual.cpp):
  * Qual2Err[q + shift] = 10^(-q/10) for q in 0..99, all other bytes 0.0
    (:219-222).
  * 'N' bases get their quality byte set to the shift value, i.e. error
    probability 1.0 (:90-93); the modified quality IS written out.
  * whole-read error = sequential sum of per-base error (:89-95); reads with
    error <= cutoff*len pass through untouched (:102).
  * otherwise a greedy breakpoint scan (:116-148): accumulate (err, len) from
    the last breakpoint; when accum_err > cutoff*accum_len the current base
    (1-based j+1) is a breakpoint, the block strictly between breakpoints
    [last_break+1, j] is a candidate, and the accumulators reset; the longest
    block (strict >) wins, plus a final block to the read end (:139-148).
  * reads shorter than min_len after trimming are emptied but still written
    (:168-176); header annotations "    RQ: <pct>%", "  TrimLowQual",
    "  FilterShort" (:97,151,172).

The per-base recurrence is sequential in C++; here it runs as ONE lax.scan
over the L read positions with all N reads as vector lanes — identical
left-to-right float64 accumulation order (bit-exact comparisons), L steps
total instead of N*L.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..io import stat as statio


def qual2err_table(quality_shift: int = 33) -> np.ndarray:
    t = np.zeros(256, dtype=np.float64)
    for q in range(100):
        t[q + quality_shift] = 10.0 ** (-q / 10.0)
    return t


@functools.partial(jax.jit, static_argnames=("quality_shift",))
def _lowqual_scan(quals: jnp.ndarray, lengths: jnp.ndarray,
                  err_cutoff: float, quality_shift: int = 33):
    """Vectorized greedy breakpoint scan.

    quals: [N, L] uint8 ASCII qualities with N-positions already replaced by
    the shift byte.  Returns (total_err [N] f64, best_start [N] 1-based,
    best_len [N]) for the longest clean block (final block included).
    """
    table = jnp.asarray(qual2err_table(quality_shift))
    err = table[quals.astype(jnp.int32)]          # [N, L] f64
    N, L = err.shape
    jlen = lengths.astype(jnp.int32)

    def step(carry, e):
        (accum_err, accum_len, breakpos_last, best_len, best_start,
         total_err, j) = carry                     # j is 0-based position
        in_read = j < jlen
        total_err = jnp.where(in_read, total_err + e, total_err)
        accum_err2 = accum_err + e
        accum_len2 = accum_len + 1
        is_break = in_read & (accum_err2 > err_cutoff * accum_len2)
        # C++ 1-based: breakpos = j+1, block = [breakpos_last+1, breakpos-1]
        start_in_block = breakpos_last + 1
        end_in_block = j                           # == breakpos - 1, 1-based
        length_block = end_in_block - start_in_block + 1
        better = is_break & (length_block > best_len)
        best_len = jnp.where(better, length_block, best_len)
        best_start = jnp.where(better, start_in_block, best_start)
        accum_err = jnp.where(is_break, 0.0,
                              jnp.where(in_read, accum_err2, accum_err))
        accum_len = jnp.where(is_break, 0,
                              jnp.where(in_read, accum_len2, accum_len))
        breakpos_last = jnp.where(is_break, j + 1, breakpos_last)
        return (accum_err, accum_len, breakpos_last, best_len, best_start,
                total_err, j + 1), None

    init = (jnp.zeros(N), jnp.zeros(N, jnp.int32), jnp.zeros(N, jnp.int32),
            jnp.zeros(N, jnp.int32), jnp.zeros(N, jnp.int32),
            jnp.zeros(N), jnp.int32(0))
    (accum_err, accum_len, breakpos_last, best_len, best_start,
     total_err, _), _ = jax.lax.scan(step, init, jnp.swapaxes(err, 0, 1))

    # final block: breakpos = len+1 -> [breakpos_last+1, len]
    start_in_block = breakpos_last + 1
    length_block = jlen - start_in_block + 1
    better = length_block > best_len
    best_len = jnp.where(better, length_block, best_len)
    best_start = jnp.where(better, start_in_block, best_start)
    return total_err, best_start, best_len


@dataclass
class LowqualResult:
    keep_start: np.ndarray       # [N] 0-based trim start (0 if untrimmed)
    keep_len_pre: np.ndarray     # [N] length after trim, BEFORE short filter
    final_len: np.ndarray        # [N] length after short filter (0 if dropped)
    total_err: np.ndarray        # [N] f64 whole-read error sum
    trimmed: np.ndarray          # [N] bool TrimLowQual applied
    short: np.ndarray            # [N] bool FilterShort applied


def clean_lowqual_arrays(quals_in: np.ndarray, seq_ascii: np.ndarray,
                         lengths: np.ndarray, err_cutoff: float,
                         min_read_len: int, quality_shift: int = 33):
    """Trimming decisions for a batch.  Returns (LowqualResult, quals_out)
    where quals_out has 'N' positions replaced by the shift byte."""
    N_mask = (seq_ascii == ord("N")) & \
        (np.arange(quals_in.shape[1])[None, :] < lengths[:, None])
    quals = np.where(N_mask, np.uint8(quality_shift), quals_in)

    total_err, best_start, best_len = _lowqual_scan(
        jnp.asarray(quals), jnp.asarray(lengths), err_cutoff, quality_shift)
    total_err = np.asarray(total_err)
    best_start = np.asarray(best_start).astype(np.int64)
    best_len = np.asarray(best_len).astype(np.int64)

    lengths = lengths.astype(np.int64)
    needs_trim = total_err > err_cutoff * lengths
    valid = (best_start >= 1) & (best_start <= lengths)
    keep_start = np.where(needs_trim & valid, best_start - 1, 0)
    keep_len_pre = np.where(needs_trim,
                            np.where(valid, best_len, 0), lengths)
    keep_len_pre = np.maximum(keep_len_pre, 0)
    short = keep_len_pre < min_read_len
    final_len = np.where(short, 0, keep_len_pre)
    return LowqualResult(keep_start, keep_len_pre, final_len, total_err,
                         needs_trim, short), quals


def run_file(in_path: str, out_path: str, stat_path: str,
             err_cutoff: float = 0.001, min_read_len: int = 75,
             quality_shift: int = 33) -> dict:
    """File-level driver (CLI parity: clean_lowqual <in> <out> <stat>)."""

    from ..io import fastq

    batch = fastq.read_batch(in_path, fmt="fq", strict_n=True,
                             keep_ascii=True)
    seq = batch.seqs_ascii
    res, quals = clean_lowqual_arrays(batch.quals, seq, batch.lengths,
                                      err_cutoff, min_read_len, quality_shift)
    lengths = batch.lengths.astype(np.int64)
    n = batch.n_reads

    raw_reads = n
    raw_bases = int(lengths.sum())
    lowqual_reads = int(res.trimmed.sum())
    lowqual_bases = int((lengths - res.keep_len_pre)[res.trimmed].sum())
    short_reads = int(res.short.sum())
    short_bases = int(res.keep_len_pre[res.short].sum())
    clean_reads = int((res.final_len > 0).sum())
    clean_bases = int(res.final_len.sum())

    out = bytearray()
    for i in range(n):
        head = batch.heads[i]
        L = int(lengths[i])
        rq = statio.fmt_lexical(res.total_err[i] / L * 100) if L else "nan"
        head = head + b"    RQ: " + rq.encode() + b"%"
        if res.trimmed[i]:
            head += b"  TrimLowQual"
        if res.short[i]:
            head += b"  FilterShort"
        s = int(res.keep_start[i])
        l_ = int(res.final_len[i])
        out += head + b"\n" + seq[i, s:s + l_].tobytes() + b"\n+\n" \
            + quals[i, s:s + l_].tobytes() + b"\n"
    fastq.gz_write_bytes(out_path, bytes(out))

    statio.write_clean_lowqual_stat(stat_path, raw_reads, raw_bases,
                                    lowqual_reads, lowqual_bases,
                                    short_reads, short_bases,
                                    clean_reads, clean_bases)
    return dict(raw_reads=raw_reads, raw_bases=raw_bases,
                clean_reads=clean_reads, clean_bases=clean_bases)
