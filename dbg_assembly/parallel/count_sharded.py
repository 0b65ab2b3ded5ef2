"""Distributed k-mer counting: prefix-sharded table with all_to_all routing.

This is the device-mesh equivalent of the reference's key-space sharded hash
update (`kmer % threadNum == threadId`, DBGgraph.cpp:148-150, SURVEY.md P2),
lifted from threads+CAS to a device mesh + collectives:

  1. each device chops canonical k-mers from its batch shard (dp),
  2. owner shard = k-mer mod n_devices (matching the reference's ownership
     rule; high bits would equally work for a sorted-table layout),
  3. k-mers are bucketed per destination into equal-capacity buffers and
     exchanged with jax.lax.all_to_all between devices,
  4. the owner locally sorts + run-length-reduces its shard of k-mer space,
  5. global statistics (total/unique counts) via psum.

Everything runs under one jit(shard_map(...)) — no host round-trips between
the phases.  Bucket overflow is surfaced via a per-device dropped-k-mer
counter (capacity slack is configurable; with mod-sharding of random k-mers
the load imbalance is tiny).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from .. import dna

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def _local_chop(codes, lengths, ksize):
    kmers = dna.rolling_kmers(codes, ksize)
    can, _ = dna.canonical(kmers, ksize)
    Pn = codes.shape[1] - ksize + 1
    pos = jnp.arange(Pn, dtype=jnp.int32)[None, :]
    valid = pos < (lengths[:, None] - ksize + 1)
    can = jnp.where(valid, can, SENTINEL)
    return can.reshape(-1), valid


def _bucketize(flat, n_dev, capacity):
    """Sort local k-mers by owner and pack into [n_dev, capacity] buffers
    (SENTINEL-padded).  Returns (buffers, dropped_count)."""
    owner = (flat % jnp.uint64(n_dev)).astype(jnp.int32)
    owner = jnp.where(flat == SENTINEL, n_dev, owner)   # invalid to the end
    order = jnp.argsort(owner, stable=True)
    sk = flat[order]
    so = owner[order]
    seg_start = jnp.searchsorted(so, jnp.arange(n_dev, dtype=jnp.int32))
    seg_end = jnp.searchsorted(so, jnp.arange(1, n_dev + 1, dtype=jnp.int32))
    seg_cnt = seg_end - seg_start
    slot = jnp.arange(capacity, dtype=jnp.int64)[None, :]
    idx = seg_start[:, None] + slot                     # [n_dev, capacity]
    take = slot < seg_cnt[:, None]
    idx = jnp.clip(idx, 0, sk.shape[0] - 1)
    buf = jnp.where(take, sk[idx], SENTINEL)
    dropped = jnp.sum(jnp.maximum(seg_cnt - capacity, 0))
    return buf, dropped


@functools.partial(jax.jit, static_argnames=("ksize", "mesh", "capacity"))
def count_step(codes, lengths, *, ksize: int, mesh, capacity: int):
    """One distributed counting step over reads sharded on the batch dim.

    Returns per-device-sharded (unique_kmers [D, capacity*D],
    counts [D, capacity*D], n_unique [D], stats dict of global scalars);
    per-shard records are MASKED at their sorted positions (SENTINEL/0
    at non-run-start slots) — compact by mask on host.
    """
    n_dev = mesh.shape["d"]

    def shard_fn(codes, lengths):
        flat, valid = _local_chop(codes, lengths, ksize)
        n_valid = jnp.sum(valid.astype(jnp.int64))
        buf, dropped = _bucketize(flat, n_dev, capacity)
        # exchange: row i of buf goes to device i
        recv = jax.lax.all_to_all(buf[None], "d", split_axis=1,
                                  concat_axis=1, tiled=False)[0]
        mine = recv.reshape(-1)                         # [n_dev * capacity]
        sk = jnp.sort(mine)
        # gather-free masked run-length encode (the shipped production
        # form, kmer/count._runs_masked)
        from ..kmer.count import _runs_masked
        uniq, counts, n_unique = _runs_masked(sk)
        g_total = jax.lax.psum(n_valid, "d")
        g_unique = jax.lax.psum(n_unique, "d")
        g_dropped = jax.lax.psum(dropped, "d")
        return (uniq[None], counts[None], n_unique[None],
                g_total[None], g_unique[None], g_dropped[None])

    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("d", None), P("d")),
        out_specs=(P("d", None), P("d", None), P("d"),
                   P("d"), P("d"), P("d")))
    uniq, counts, n_unique, g_total, g_unique, g_dropped = fn(codes, lengths)
    stats = {"total_kmers": g_total[0], "unique_kmers": g_unique[0],
             "dropped": g_dropped[0]}
    return uniq, counts, n_unique, stats


def default_capacity(n_reads: int, read_len: int, ksize: int,
                     n_dev: int, slack: float = 1.25) -> int:
    """Per-destination bucket capacity for a balanced k-mer route.

    Expected load per (source device, owner) pair is kmers/device/n_dev;
    mod-sharding of canonical k-mers is near-uniform, so a 25% slack
    absorbs normal skew.  exact_* wrappers below double on overflow."""
    per_dev = -(-n_reads // n_dev) * max(read_len - ksize + 1, 1)
    return int(per_dev / n_dev * slack) + 64


def _run_exact(step_fn, codes, lengths, *, ksize, mesh, capacity,
               max_doublings, stats_index):
    """Retry-on-overflow driver shared by the exact_* wrappers.

    The reference degrades by IGNORING input once its hash fills
    (DBGgraph.cpp:337-351, policy documented in main.cpp:66-70) and at
    least alerts; silent undercounting is worse than either, so here a
    step whose psum'd dropped counter is nonzero is re-run at doubled
    (static) capacity until exact.  Each doubling recompiles once; the
    compiled steps are cached per capacity for subsequent batches."""
    for attempt in range(max_doublings + 1):
        out = step_fn(codes, lengths, ksize=ksize, mesh=mesh,
                      capacity=capacity)
        stats = out[stats_index]
        dropped = int(stats["dropped"])
        stats["capacity"] = capacity
        stats["capacity_doublings"] = attempt
        if dropped == 0:
            return out
        capacity *= 2
    raise RuntimeError(
        f"k-mer route still overflowing after {max_doublings} capacity "
        f"doublings (capacity={capacity}, dropped={dropped}); input is "
        "pathologically skewed — shard by hashed key instead of raw mod")


def count_step_exact(codes, lengths, *, ksize: int, mesh,
                     capacity: int | None = None, max_doublings: int = 6):
    """count_step with the production drop policy: never undercount.

    Returns the same tuple as count_step; stats additionally carries the
    final 'capacity' and how many 'capacity_doublings' were needed."""
    if capacity is None:
        capacity = default_capacity(codes.shape[0], codes.shape[1], ksize,
                                    mesh.shape["d"])
    return _run_exact(count_step, codes, lengths, ksize=ksize, mesh=mesh,
                      capacity=capacity, max_doublings=max_doublings,
                      stats_index=3)


def graph_ingest_step_exact(codes, lengths, base_index=0, *, ksize: int,
                            mesh, capacity: int | None = None,
                            max_doublings: int = 6):
    """graph_ingest_step with the production drop policy (see count_step_exact)."""
    if capacity is None:
        capacity = default_capacity(codes.shape[0], codes.shape[1], ksize,
                                    mesh.shape["d"])

    def step(codes, lengths, **kw):
        return graph_ingest_step(codes, lengths, base_index, **kw)

    return _run_exact(step, codes, lengths, ksize=ksize,
                      mesh=mesh, capacity=capacity,
                      max_doublings=max_doublings, stats_index=6)


def _bucketize_with_payload(flat, payload, n_dev, capacity):
    """Like _bucketize but carries an integer payload alongside each k-mer."""
    owner = (flat % jnp.uint64(n_dev)).astype(jnp.int32)
    owner = jnp.where(flat == SENTINEL, n_dev, owner)
    order = jnp.argsort(owner, stable=True)
    sk = flat[order]
    sp = payload[order]
    so = owner[order]
    seg_start = jnp.searchsorted(so, jnp.arange(n_dev, dtype=jnp.int32))
    seg_end = jnp.searchsorted(so, jnp.arange(1, n_dev + 1, dtype=jnp.int32))
    seg_cnt = seg_end - seg_start
    slot = jnp.arange(capacity, dtype=jnp.int64)[None, :]
    idx = jnp.clip(seg_start[:, None] + slot, 0, sk.shape[0] - 1)
    take = slot < seg_cnt[:, None]
    buf_k = jnp.where(take, sk[idx], SENTINEL)
    buf_p = jnp.where(take, sp[idx], 0)
    dropped = jnp.sum(jnp.maximum(seg_cnt - capacity, 0))
    return buf_k, buf_p, dropped


@functools.partial(jax.jit, static_argnames=("ksize", "mesh", "capacity"))
def graph_ingest_step(codes, lengths, base_index=0, *, ksize: int, mesh,
                      capacity: int):
    """Distributed de Bruijn graph ingest: the multi-chip version of the
    contig stage's node-table build (SURVEY.md P2, the BASELINE north star).

    Each device chops canonical k-mers WITH strand-adjusted neighbor bases
    (DBGgraph.cpp:76-89 semantics), routes (kmer, payload = stream position
    << 6 | left*8 + right) to the k-mer's owner shard with all_to_all, and
    the owner segment-sums the eight 8-bit edge counters and segment-mins
    the first-occurrence stream position for its k-mer species.  base_index
    is the global stream position of this batch's first window, so the
    merged table is bit-identical to the single-device builder's, including
    the insertion-order field the hash-layout emulation depends on.

    Returns per-device (uniq [D,n], lcnt [D,n,4], rcnt [D,n,4],
    first_idx [D,n], n_unique [D]) and global stats; per-shard records
    are MASKED at their sorted positions (SENTINEL rows) — compact by
    mask on host (GraphBuilder._add_mesh does).
    """
    from ..contig.graph import _chop_with_edges
    n_dev = mesh.shape["d"]
    NO_IDX = jnp.int64(2 ** 62)

    def shard_fn(codes, lengths):
        can, left, right, valid = _chop_with_edges(codes, lengths, ksize)
        flat = can.reshape(-1)
        n_local = flat.shape[0]
        # global stream position of each window: rows are contiguous
        # per-device blocks of the batch
        dev = jax.lax.axis_index("d").astype(jnp.int64)
        pos = (jnp.int64(base_index) + dev * n_local
               + jnp.arange(n_local, dtype=jnp.int64))
        payload = (pos << 6) | (left.reshape(-1) * 8
                                + right.reshape(-1)).astype(jnp.int64)
        n_valid = jnp.sum(valid.astype(jnp.int64))
        buf_k, buf_p, dropped = _bucketize_with_payload(
            flat, payload, n_dev, capacity)
        recv_k = jax.lax.all_to_all(buf_k[None], "d", split_axis=1,
                                    concat_axis=1, tiled=False)[0].reshape(-1)
        recv_p = jax.lax.all_to_all(buf_p[None], "d", split_axis=1,
                                    concat_axis=1, tiled=False)[0].reshape(-1)
        # gather-free merge mirroring contig.graph._aggregate_batch: ONE
        # payload-carrying stable sort instead of argsort + gathers or
        # scatter-add segment sums, then blocked two-level scans.  Sources
        # arrive in device order and bucketize is stable, so stream
        # positions ascend within each run: the run head's payload holds
        # the min position.
        from ..kmer import stats as _stats
        from ..kmer.count import _counts_from_first
        sk, sp = jax.lax.sort((recv_k, recv_p), num_keys=1, is_stable=True)
        n = sk.shape[0]
        first = jnp.concatenate([jnp.ones((1,), bool), sk[1:] != sk[:-1]])
        first = first & (sk != SENTINEL)
        is_valid = sk != SENTINEL
        edges = (sp & jnp.int64(63)).astype(jnp.int32)
        lbase = edges // 8
        rbase = edges % 8
        lhot = ((lbase[:, None] == jnp.arange(4)[None, :])
                & is_valid[:, None]).astype(jnp.int32)
        rhot = ((rbase[:, None] == jnp.arange(4)[None, :])
                & is_valid[:, None]).astype(jnp.int32)
        last = jnp.concatenate([sk[1:] != sk[:-1], jnp.ones((1,), bool)])
        last = last & is_valid
        cum_l = _stats.cumsum_blocked(lhot)
        cum_r = _stats.cumsum_blocked(rhot)
        BIGI = jnp.int32(2 ** 31 - 1)
        end_l = _stats.rcummin_blocked(
            jnp.where(last[:, None], cum_l, BIGI), BIGI)
        end_r = _stats.rcummin_blocked(
            jnp.where(last[:, None], cum_r, BIGI), BIGI)
        lcnt = jnp.where(first[:, None], end_l - (cum_l - lhot), 0)
        rcnt = jnp.where(first[:, None], end_r - (cum_r - rhot), 0)
        counts, n_unique = _counts_from_first(first, is_valid)
        uniq = jnp.where(first, sk, SENTINEL)
        first_idx = jnp.where(first, sp >> 6, NO_IDX)
        g_total = jax.lax.psum(n_valid, "d")
        g_unique = jax.lax.psum(n_unique, "d")
        g_dropped = jax.lax.psum(dropped, "d")
        return (uniq[None], lcnt[None], rcnt[None], first_idx[None],
                counts[None], n_unique[None], g_total[None],
                g_unique[None], g_dropped[None])

    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("d", None), P("d")),
        out_specs=(P("d", None), P("d", None, None), P("d", None, None),
                   P("d", None), P("d", None), P("d"), P("d"), P("d"),
                   P("d")))
    (uniq, lcnt, rcnt, first_idx, counts, n_unique, g_total, g_unique,
     g_dropped) = fn(codes, lengths)
    stats = {"total_kmers": g_total[0], "unique_kmers": g_unique[0],
             "dropped": g_dropped[0]}
    return uniq, lcnt, rcnt, first_idx, counts, n_unique, stats
