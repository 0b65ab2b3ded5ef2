"""Sequence-axis sharding with (k-1)-base halo exchange.

The reference never parallelizes WITHIN a sequence — its longest unit is one
read (<= maxReadLen, hard-truncated at DBGgraph.cpp:63) and contigs are built
incrementally.  The device build's "CP/ring-like" analog (SURVEY.md §2.5 P8):
sequences longer than a per-chip tile — multi-megabase contigs/scaffolds
being re-indexed for later scaffolding rounds, or very long PacBio reads —
are sharded along the BASE axis over the device mesh, and k-mer windows that
straddle a tile boundary are completed by fetching the next tile's leading
(k-1) bases from the ring neighbor with `jax.lax.ppermute` (one device hop, no
host round-trip, no overlap materialized in HBM beyond k-1 columns).

The chopped canonical k-mers come out sharded on the same axis, so they feed
straight into the prefix-routed distributed counter (count_sharded.py) — the
combined `count_halo_sharded` keeps chop + route + reduce inside ONE
jit(shard_map) program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from .. import dna
from .count_sharded import SENTINEL, _bucketize


def _halo_extend(tile, ksize, axis_name, n_dev):
    """Append the ring-next device's first (k-1) columns to this tile."""
    if tile.shape[1] < ksize - 1:
        raise ValueError(
            f"per-device tile of {tile.shape[1]} bases is narrower than the "
            f"k-1={ksize - 1} halo; a window could straddle >2 tiles.  Pad "
            f"sequences so L/n_devices >= k-1 (pad_seqs_for_mesh does).")
    halo = jax.lax.ppermute(
        tile[:, :ksize - 1], axis_name,
        perm=[((j + 1) % n_dev, j) for j in range(n_dev)])
    return jnp.concatenate([tile, halo], axis=1)


@functools.partial(jax.jit, static_argnames=("ksize", "mesh"))
def halo_chop(codes, lengths, *, ksize: int, mesh):
    """Canonical k-mer chop of base-axis-sharded sequences.

    codes   [B, L] 2-bit codes, L divisible by the mesh size; sharded
            along axis 1 (the base axis).
    lengths [B] true sequence lengths (replicated).

    Returns [B, L] uint64 canonical k-mers, where slot (b, p) is the k-mer
    starting at base p of sequence b (SENTINEL where p > lengths[b]-k),
    sharded along axis 1 — ready for owner-routing without reshuffling.
    """
    n_dev = mesh.shape["d"]

    def shard_fn(tile, lengths):
        i = jax.lax.axis_index("d")
        T = tile.shape[1]
        ext = _halo_extend(tile, ksize, "d", n_dev)
        kmers = dna.rolling_kmers(ext, ksize)            # [B, T]
        can, _ = dna.canonical(kmers, ksize)
        start = i * T + jnp.arange(T, dtype=jnp.int32)
        valid = start[None, :] <= (lengths[:, None] - ksize)
        return jnp.where(valid, can, SENTINEL)

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=(P(None, "d"), P()),
                   out_specs=P(None, "d"))
    return fn(codes, lengths)


@functools.partial(jax.jit, static_argnames=("ksize", "mesh", "capacity"))
def count_halo_sharded(codes, lengths, *, ksize: int, mesh, capacity: int):
    """Distributed counting of base-axis-sharded long sequences: halo chop,
    mod-n owner routing via all_to_all, sort + run-length reduce per owner —
    all inside one jit(shard_map).  Mirrors count_sharded.count_step, which
    shards over READS (dp); this shards over BASES of few long sequences.

    Returns per-device-sharded (uniq [D, n], counts [D, n], n_unique [D])
    and a dict of global scalars (psum'd): total/unique/dropped; per-shard
    records are MASKED at their sorted positions (SENTINEL/0 slots).
    """
    n_dev = mesh.shape["d"]

    def shard_fn(tile, lengths):
        i = jax.lax.axis_index("d")
        T = tile.shape[1]
        ext = _halo_extend(tile, ksize, "d", n_dev)
        kmers = dna.rolling_kmers(ext, ksize)
        can, _ = dna.canonical(kmers, ksize)
        start = i * T + jnp.arange(T, dtype=jnp.int32)
        valid = start[None, :] <= (lengths[:, None] - ksize)
        flat = jnp.where(valid, can, SENTINEL).reshape(-1)
        n_valid = jnp.sum(valid.astype(jnp.int64))
        buf, dropped = _bucketize(flat, n_dev, capacity)
        recv = jax.lax.all_to_all(buf[None], "d", split_axis=1,
                                  concat_axis=1, tiled=False)[0]
        sk = jnp.sort(recv.reshape(-1))
        # gather-free masked run-length encode (kmer/count._runs_masked)
        from ..kmer.count import _runs_masked
        uniq, counts, n_unique = _runs_masked(sk)
        g_total = jax.lax.psum(n_valid, "d")
        g_unique = jax.lax.psum(n_unique, "d")
        g_dropped = jax.lax.psum(dropped, "d")
        return (uniq[None], counts[None], n_unique[None],
                g_total[None], g_unique[None], g_dropped[None])

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=(P(None, "d"), P()),
                   out_specs=(P("d", None), P("d", None), P("d"),
                              P("d"), P("d"), P("d")))
    uniq, counts, n_unique, g_total, g_unique, g_dropped = fn(codes, lengths)
    stats = {"total_kmers": g_total[0], "unique_kmers": g_unique[0],
             "dropped": g_dropped[0]}
    return uniq, counts, n_unique, stats


def pad_seqs_for_mesh(seqs: list[np.ndarray], n_dev: int,
                      ksize: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-length code vectors into [B, L] with L a multiple of
    n_dev (padding base 0 = 'A'; masked out by `lengths`)."""
    lengths = np.array([len(s) for s in seqs], np.int32)
    # each tile must hold >= k-1 bases so one ring-neighbor halo completes
    # every straddling window
    L = int(max(lengths.max(), ksize, n_dev * (ksize - 1)))
    L = -(-L // n_dev) * n_dev
    out = np.zeros((len(seqs), L), np.uint8)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out, lengths
