"""Gather-free counting statistics over a sorted k-mer vector.

count_stats' spectrum tail is a SECOND full sort of the capped run lengths
plus a searchsorted.  This module computes the identical spectrum with one
reverse-cummin pass (run lengths) and a fused compare-reduce histogram (no
sort, no gather, no scatter): the histogram is O(N * nbins) elementwise
compares, which XLA fuses into the reduction.

Reference semantics matched: spectrum bin f = number of k-mer species whose
count (saturated at max_freq) equals f; bin 0 is always zero (species counts
are >= 1) — kmerfreq's 255-cap .cz table as consumed by
correct_error/main.cpp:187-215.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)

_CHUNK = 1 << 20


def rcummin_blocked(x: jnp.ndarray, fill, block: int = 4096) -> jnp.ndarray:
    """Exact reverse cumulative min along axis 0, two-level blocked.

    A flat lax.cummin over tens of millions of elements compiles
    pathologically; block-local scans along a
    short axis plus a cross-block carry scan run at memory bandwidth.
    Accepts [n] or [n, k]."""
    n = x.shape[0]
    rest = x.shape[1:]
    nb = -(-n // block)
    pad = nb * block - n
    xp = jnp.concatenate(
        [x, jnp.full((pad,) + rest, fill, x.dtype)]) if pad else x
    blk = xp.reshape((nb, block) + rest)
    within = jax.lax.cummin(blk, axis=1, reverse=True)
    bmin = within[:, 0]                                   # [nb, ...]
    nxt = jnp.concatenate([bmin[1:], jnp.full((1,) + rest, fill, x.dtype)])
    carry = jax.lax.cummin(nxt, axis=0, reverse=True)     # short scan
    out = jnp.minimum(within, jnp.expand_dims(carry, 1))
    return out.reshape((nb * block,) + rest)[:n]


def cumsum_blocked(x: jnp.ndarray, block: int = 4096) -> jnp.ndarray:
    """Exact INCLUSIVE cumulative sum along axis 0, two-level blocked
    (same rationale as rcummin_blocked).  Accepts [n] or [n, k]."""
    n = x.shape[0]
    rest = x.shape[1:]
    nb = -(-n // block)
    pad = nb * block - n
    xp = jnp.concatenate(
        [x, jnp.zeros((pad,) + rest, x.dtype)]) if pad else x
    blk = xp.reshape((nb, block) + rest)
    within = jnp.cumsum(blk, axis=1)
    btot = within[:, -1]                                  # [nb, ...]
    carry = jnp.cumsum(btot, axis=0) - btot               # exclusive
    out = within + jnp.expand_dims(carry, 1)
    return out.reshape((nb * block,) + rest)[:n]


@functools.partial(jax.jit, static_argnames=("nbins",))
def histogram_small(v: jnp.ndarray, nbins: int = 256) -> jnp.ndarray:
    """Histogram of int32 values into [0, nbins); out-of-range values are
    dropped.  Scatter-free: a chunked compare-reduce that runs at
    elementwise speed, with no update order to depend on."""
    n = v.shape[0]
    pad = (-n) % _CHUNK
    if pad:
        v = jnp.concatenate([v, jnp.full((pad,), -1, v.dtype)])
    vc = v.reshape(-1, _CHUNK)
    bins = jnp.arange(nbins, dtype=v.dtype)

    def body(acc, row):
        h = jnp.sum((row[:, None] == bins[None, :]).astype(jnp.int32),
                    axis=0)
        return acc + h.astype(jnp.int64), None

    out, _ = jax.lax.scan(body, jnp.zeros((nbins,), jnp.int64), vc)
    return out


def histogram256(v: jnp.ndarray) -> jnp.ndarray:
    return histogram_small(v, 256)


@functools.partial(jax.jit, static_argnames=("max_freq",))
def spectrum_sorted(sorted_kmers: jnp.ndarray, max_freq: int = 255):
    """Spectrum histogram + species count from a sorted k-mer vector.

    Identical contract to kmer.count.count_stats' (spectrum, n_unique) but
    without the second sort OR a global scan: because species counts
    saturate at max_freq, the next-run-boundary after position i only needs
    to be found within a max_freq-wide window, so run lengths come from a
    BLOCKED sliding-window min (per-block prefix/suffix mins along a short
    axis — a handful of fused elementwise passes) instead of a full-length
    reverse cummin (a log-step scan over the whole stream).
    Returns (spectrum [max_freq+1] int64, spectrum[0] == 0; n_unique i64).
    """
    x = sorted_kmers
    valid = x != SENTINEL
    first = jnp.concatenate([jnp.ones((1,), bool), x[1:] != x[:-1]]) & valid
    return _spectrum_from_boundaries(first, valid, max_freq)


@functools.partial(jax.jit, static_argnames=("max_freq",))
def spectrum_sorted_pair(hi: jnp.ndarray, lo: jnp.ndarray,
                         max_freq: int = 255):
    """spectrum_sorted for k-mers kept as (hi, lo) uint32 planes (the
    Pallas chop kernel's native output; pair-sorted with
    lax.sort(num_keys=2), which orders identically to the u64 view)."""
    U32M = jnp.uint32(0xFFFFFFFF)
    valid = ~((hi == U32M) & (lo == U32M))
    diff = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    first = jnp.concatenate([jnp.ones((1,), bool), diff]) & valid
    return _spectrum_from_boundaries(first, valid, max_freq)


def _spectrum_from_boundaries(first, valid, max_freq: int):
    n = first.shape[0]
    to_invalid = jnp.concatenate([jnp.zeros((1,), bool),
                                  valid[:-1] & ~valid[1:]])
    boundary = first | to_invalid
    n_unique = jnp.sum(first.astype(jnp.int64))

    # nxt[i] = index of the first boundary in (i, i + max_freq]; runs longer
    # than that cap to max_freq anyway.  Blocked window-min: W >= max_freq,
    # window (i, i+w] spans suffix of block b from j+1 and prefix of block
    # b+1 through j+w-W.
    w = max_freq
    W = max(w, 256)
    idx32 = jnp.arange(n, dtype=jnp.int32)
    BIG = jnp.int32(2 ** 31 - 1)
    fidx = jnp.where(boundary, idx32, BIG)
    pad = (-n) % W
    nb = (n + pad) // W
    fpad = jnp.concatenate([fidx, jnp.full((pad,), BIG, jnp.int32)]) \
        if pad else fidx
    blocks = fpad.reshape(nb, W)
    suf = jax.lax.cummin(blocks, axis=1, reverse=True)       # [nb, W]
    pre = jax.lax.cummin(blocks, axis=1)
    # suffix part: min(block[b, j+1:]) = suf[b, j+1] (BIG when j == W-1)
    suf_part = jnp.concatenate(
        [suf[:, 1:], jnp.full((nb, 1), BIG, jnp.int32)], axis=1)
    # prefix part: min(block[b+1, :j+w-W+1]) — empty (BIG) when j + w < W
    nxt_block_pre = jnp.concatenate(
        [pre[1:], jnp.full((1, W), BIG, jnp.int32)], axis=0)  # [nb, W]
    jj = jnp.arange(W, dtype=jnp.int32)
    take = jj + w - W                                         # prefix end
    pre_part = jnp.where(
        take[None, :] >= 0,
        nxt_block_pre[:, jnp.clip(take, 0, W - 1)], BIG)
    nxt = jnp.minimum(suf_part, pre_part).reshape(-1)[:n]
    counts = jnp.where(nxt == BIG, jnp.int32(max_freq),
                       jnp.minimum(nxt - idx32, max_freq))
    capped = jnp.where(first, jnp.maximum(counts, 1), -1)
    spectrum = histogram_small(capped, max_freq + 1)
    return spectrum, n_unique
