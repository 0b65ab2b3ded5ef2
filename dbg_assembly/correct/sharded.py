"""Mesh-sharded residency for the correction k-mer table (SURVEY P4).

The reference loads the whole 1-bit frequency table into one host's RAM
(correct_error/main.cpp:163-173 — 2 GiB at k=17) and every worker thread
probes it.  At k>17 a single device's HBM cannot hold the 4^k-bit table,
so the device design shards it: the table's BYTE axis is partitioned
over the mesh 'd' axis, giving device d the contiguous canonical-index
range [d*4^k/D, (d+1)*4^k/D).

Lookups use the embedding-table pattern (shard the table, replicate the
queries, reduce the answers): each device all_gathers the flat query
batch (queries are tiny next to the table), answers only the indices it
owns (zero elsewhere), and a psum_scatter returns to every device the
bits for its own reads.  Collective traffic is O(batch * D) uint64s per
probe call, independent of table size — the 2 GiB table never moves.

stage_a_sharded runs the device corrector's stage A (classification +
regions + fast phase 2 + phase 3, correct/device.py:_stage_a_impl)
data-parallel over reads with the table sharded, producing bit-identical
outputs to the single-device path (tests/test_sharded_bitmap.py).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import device as dev


def _pvary_if_replicated(x, axis: str):
    """pcast to 'varying' only when x is still replicated over axis —
    pcast rejects already-varying operands, and loop carries under
    shard_map arrive in a mix of both."""
    try:
        vma = jax.typeof(x).vma
    except Exception:
        vma = frozenset()
    if axis in vma:
        return x
    return jax.lax.pcast(x, (axis,), to="varying")


def shard_bitmap(mesh: Mesh, bitmap: np.ndarray, axis: str = "d"):
    """Place the packed 1-bit table sharded along its byte axis.

    Pads to a multiple of the mesh axis size (padding bytes are zero =
    absent k-mers, and canonical k-mer indices never reach them).
    Returns a jax array with NamedSharding P(axis).
    """
    d = mesh.shape[axis]
    n = len(bitmap)
    pad = (-n) % (4 * d)      # word-aligned shards (probe gathers u32)
    if pad:
        bitmap = np.concatenate([bitmap, np.zeros(pad, np.uint8)])
    words = np.ascontiguousarray(bitmap).view(np.uint32)
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(words, sharding)


def probe_collective(bm_shard: jnp.ndarray, idx: jnp.ndarray,
                     axis: str = "d"):
    """Sharded-table probe, for use INSIDE shard_map.

    bm_shard: this device's [words/D] slice of the u32-word table
    (shard_bitmap).
    idx: this device's uint64 k-mer indices, any shape (same shape on
    every device).  Returns bool of idx.shape — the same bits _probe
    would return against the full table.
    """
    shape = idx.shape
    flat = idx.reshape(-1)
    q = flat.shape[0]
    allq = jax.lax.all_gather(flat, axis, tiled=True)          # [D*q]
    bits_here = jnp.uint64(32 * bm_shard.shape[0])   # shard is u32 words
    base = jax.lax.axis_index(axis).astype(jnp.uint64) * bits_here
    rel = allq - base
    mine = (allq >= base) & (rel < bits_here)
    rel = jnp.where(mine, rel, 0)
    # u32-word gather, same layout as device._probe/bitmap_device
    w = bm_shard[(rel >> jnp.uint64(5)).astype(jnp.int64)]
    shift = (jnp.uint64(8) * ((rel >> jnp.uint64(3)) & jnp.uint64(3))
             + (jnp.uint64(7) - (rel & jnp.uint64(7)))).astype(jnp.uint32)
    bit = ((w >> shift) & jnp.uint32(1)).astype(jnp.int32)
    bit = jnp.where(mine, bit, 0)
    # [D*q] partial answers -> own [q] slice, summed across devices
    out = jax.lax.psum_scatter(bit, axis, scatter_dimension=0, tiled=True)
    del q
    return out.astype(jnp.bool_).reshape(shape)


@functools.partial(jax.jit,
                   static_argnames=("k", "m", "max_change", "mesh", "axis"))
def _stage_a_sharded_jit(ascii_seq, codes, lengths, bm_shard, *, k, m,
                         max_change, mesh, axis):
    from jax import shard_map

    def body(a, c, ln, bm):
        probe = lambda idx: probe_collective(bm, idx, axis=axis)  # noqa: E731
        return dev._stage_a_impl(a, c, ln, probe, k=k, m=m,
                                 max_change=max_change)

    spec = P(axis)
    return shard_map(body, mesh=mesh,
                     in_specs=(spec, spec, spec, spec),
                     out_specs=tuple([spec] * 6))(
        ascii_seq, codes, lengths, bm_shard)


@functools.partial(jax.jit,
                   static_argnames=("k", "mesh", "axis"))
def _wave_sharded_jit(ascii_seq, lengths, bm_shard, hs1, he1, num_h, accum,
                      multi, fail, fallback, i, mc, *, k, mesh, axis):
    from jax import shard_map

    def body(a, ln, bm, hs1, he1, num_h, accum, multi, fail, fb):
        probe = lambda idx: probe_collective(bm, idx, axis=axis)  # noqa: E731
        gany = lambda x: jax.lax.pmax(x.astype(jnp.int32),          # noqa: E731
                                      axis) > 0
        vary = lambda t: jax.tree.map(                               # noqa: E731
            lambda x: _pvary_if_replicated(x, axis), t)
        return dev._wave_impl(a, ln, probe, hs1, he1, num_h, accum, multi,
                              fail, fb, i, mc, k=k, global_any=gany,
                              vary=vary)

    spec = P(axis)
    return shard_map(body, mesh=mesh,
                     in_specs=tuple([spec] * 10),
                     out_specs=tuple([spec] * 5))(
        ascii_seq, lengths, bm_shard, hs1, he1, num_h, accum, multi, fail,
        fallback)


@functools.partial(jax.jit,
                   static_argnames=("k", "mc", "ft", "min_len", "mesh",
                                    "axis"))
def _phase5_sharded_jit(ascii_seq, lengths, bm_shard, hs1, he1, num_h,
                        accum, multi, fail, fallback, *, k, mc, ft, min_len,
                        mesh, axis):
    from jax import shard_map

    def body(a, ln, bm, hs1, he1, num_h, accum, multi, fail, fb):
        probe = lambda idx: probe_collective(bm, idx, axis=axis)  # noqa: E731
        gany = lambda x: jax.lax.pmax(x.astype(jnp.int32),          # noqa: E731
                                      axis) > 0
        vary = lambda t: jax.tree.map(                               # noqa: E731
            lambda x: _pvary_if_replicated(x, axis), t)
        return dev._phase5_impl(a, ln, probe, hs1, he1, num_h, accum,
                                multi, fail, fb, k=k, mc=mc, ft=ft,
                                min_len=min_len, global_any=gany,
                                vary=vary)

    spec = P(axis)
    return shard_map(body, mesh=mesh,
                     in_specs=tuple([spec] * 10),
                     out_specs=tuple([spec] * 6))(
        ascii_seq, lengths, bm_shard, hs1, he1, num_h, accum, multi, fail,
        fallback)


def correct_batch_sharded(mesh: Mesh, ascii_np, codes_np, lengths_np,
                          bm_shard, params, axis: str = "d"):
    """The FULL 5-phase device corrector with reads data-parallel over the
    mesh and the 1-bit table sharded — stage A (classification + regions +
    fast phase 2 + phase 3) AND stage B (the phase-4 BBT gap waves +
    phase-5 head/tail trimming, correct.cpp:222-334), every table probe a
    collective against the distributed table.  At k=19 the 4^k table is
    32 GiB (correct_error/main.cpp:163-173) — 4 GiB/device on 8, which is
    exactly why the waves must run where the table lives.

    Output-identical to dev.correct_batch_device on the same batch
    (tests/test_sharded_bitmap.py).  Returns (one, multi, deleted,
    trim_left, trim_right, ascii_mod, fallback) numpy arrays.
    """
    p = params.resolved()
    k, m, mc = p.ksize, p.high_freq_reg_len, p.max_change
    d = mesh.shape[axis]
    n = len(lengths_np)
    pad = (-n) % d
    if pad:
        ascii_np = np.concatenate(
            [ascii_np, np.zeros((pad, ascii_np.shape[1]), ascii_np.dtype)])
        codes_np = np.concatenate(
            [codes_np, np.full((pad, codes_np.shape[1]), 4, codes_np.dtype)])
        lengths_np = np.concatenate(
            [lengths_np, np.zeros(pad, lengths_np.dtype)])
    spec = NamedSharding(mesh, P(axis))
    a = jax.device_put(jnp.asarray(ascii_np), spec)
    c = jax.device_put(jnp.asarray(codes_np), spec)
    ln = jax.device_put(jnp.asarray(lengths_np.astype(np.int32)), spec)

    a, one, hs1, he1, num_h, fallback = _stage_a_sharded_jit(
        a, c, ln, bm_shard, k=k, m=m, max_change=mc, mesh=mesh, axis=axis)

    accum = one
    multi = jnp.zeros_like(one)
    fail = jnp.zeros(hs1.shape, bool)
    # one host sync for the GLOBAL wave count (same sync the single-device
    # driver does, correct_batch_device)
    n_waves = max(int(jnp.max(num_h)) - 1, 0)
    for i in range(n_waves):
        a, accum, multi, fail, fallback = _wave_sharded_jit(
            a, ln, bm_shard, hs1, he1, num_h, accum, multi, fail, fallback,
            jnp.int32(i), jnp.int32(mc), k=k, mesh=mesh, axis=axis)

    a, multi, deleted, trim_left, trim_right, fallback = _phase5_sharded_jit(
        a, ln, bm_shard, hs1, he1, num_h, accum, multi, fail, fallback,
        k=k, mc=mc, ft=p.further_trim, min_len=p.min_read_len,
        mesh=mesh, axis=axis)
    outs = (one, multi, deleted, trim_left, trim_right, a, fallback)
    return tuple(np.asarray(o)[:n] for o in outs)


def stage_a_sharded(mesh: Mesh, ascii_np, codes_np, lengths_np, bm_shard,
                    *, k: int, m: int, max_change: int, axis: str = "d"):
    """Stage A of the device corrector with reads data-parallel over the
    mesh and the 1-bit table sharded (never replicated).  Pads the read
    batch to a multiple of the axis size; returns numpy outputs trimmed
    back to the original batch.  Output-identical to dev._stage_a."""
    d = mesh.shape[axis]
    n = len(lengths_np)
    pad = (-n) % d
    if pad:
        ascii_np = np.concatenate(
            [ascii_np, np.zeros((pad, ascii_np.shape[1]), ascii_np.dtype)])
        codes_np = np.concatenate(
            [codes_np, np.full((pad, codes_np.shape[1]), 4, codes_np.dtype)])
        lengths = np.concatenate([lengths_np, np.zeros(pad, np.int32)])
    else:
        lengths = lengths_np
    spec = NamedSharding(mesh, P(axis))
    a = jax.device_put(jnp.asarray(ascii_np), spec)
    c = jax.device_put(jnp.asarray(codes_np), spec)
    ln = jax.device_put(jnp.asarray(lengths.astype(np.int32)), spec)
    outs = _stage_a_sharded_jit(a, c, ln, bm_shard, k=k, m=m,
                                max_change=max_change, mesh=mesh, axis=axis)
    return tuple(np.asarray(o)[:n] for o in outs)
