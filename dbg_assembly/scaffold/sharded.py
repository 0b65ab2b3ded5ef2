"""Mesh-sharded read mapping: the seed-and-extend aligner data-parallel
over the mesh with the positional contig index replicated per device.

The reference maps reads single-threaded (map_pair.cpp:152-354) or with a
round-robin pthread pool (map_reads.cpp:408-519); the device kernel
(scaffold/index._map_kernel) already vectorizes one batch — this wrapper
shards the read batch over the 'd' axis (SURVEY P1 for the mapping stage).
The index is replicated: at reference scales it is small next to device
memory
(E. coli: ~9M k-mers x ~18 B = 160 MB; the positional payload of a contig
set is O(genome)).  For genomes where the index itself outgrows a device,
the ownership-sharded collective-probe layout used by the correction table
(correct/sharded.py) applies unchanged — the lookup is the same
embedding-table pattern; that variant is not needed at any BASELINE.json
config and is left to the capacity table in BASELINE.md.

Output-identical to the single-device kernel (tests/test_mesh_map.py).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import index as six


@functools.partial(jax.jit,
                   static_argnames=("k", "S", "mesh", "axis"))
def _map_sharded_jit(ixa, codes, ascii_seq, lengths, search_start,
                     *, k, S, mesh, axis):
    def body(ixa, c, a, ln, ss):
        return six._map_kernel(ixa, c, a, ln, ss, k=k, S=S)

    spec = P(axis)
    rep = P()
    ix_specs = {kk: rep for kk in ixa}
    return shard_map(
        body, mesh=mesh,
        in_specs=(ix_specs, spec, spec, spec, spec),
        out_specs=tuple([spec] * 9))(
        ixa, codes, ascii_seq, lengths, search_start)


def map_reads_sharded(mesh: Mesh, ix: six.ContigIndex, codes, ascii_seq,
                      lengths, seed_kmer_num: int, min_identity: float,
                      search_start=1, axis: str = "d") -> six.MapResult:
    """map_reads with the read batch sharded over the mesh.  Pads to a
    multiple of the axis size; returns a MapResult trimmed to the batch."""
    if len(ix.kmers) == 0 and ix.native is not None:
        # the CPU default engine keeps the payload in the native table;
        # the mesh path needs the array-backed index (DBG_JAX_MAP=1 or
        # _build_py)
        raise ValueError("map_reads_sharded needs an array-backed index; "
                         "build it with DBG_JAX_MAP=1 or index._build_py")
    d = mesh.shape[axis]
    n = len(lengths)
    pad = (-n) % d
    if pad:
        codes = np.concatenate(
            [codes, np.full((pad, codes.shape[1]), 4, codes.dtype)])
        ascii_seq = np.concatenate(
            [ascii_seq, np.zeros((pad, ascii_seq.shape[1]),
                                 ascii_seq.dtype)])
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    ss = np.asarray(search_start)
    if ss.ndim == 0:
        ss = np.full(len(lengths), int(ss), np.int64)
    elif pad:
        ss = np.concatenate([ss, np.ones(pad, ss.dtype)])
    spec = NamedSharding(mesh, P(axis))
    ixa = {kk: jax.device_put(v, NamedSharding(mesh, P()))
           for kk, v in ix.device_arrays().items()}
    c = jax.device_put(jnp.asarray(codes), spec)
    a = jax.device_put(jnp.asarray(ascii_seq), spec)
    ln = jax.device_put(jnp.asarray(lengths.astype(np.int32)), spec)
    sss = jax.device_put(jnp.asarray(ss.astype(np.int64)), spec)
    out = _map_sharded_jit(ixa, c, a, ln, sss, k=ix.ksize,
                           S=seed_kmer_num, mesh=mesh, axis=axis)
    return six.map_result(out, min_identity, n)
