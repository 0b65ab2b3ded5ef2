"""Mesh-sharded contig stage (contig/mesh_assemble.py) must produce
byte-identical artifacts to the single-device scalable path: MeshGraph
overrides only HOW the bulk phases execute (sharded table search, sharded
link pass, sharded pointer doubling on an 8-device CPU mesh), never a
decision."""

import os

import numpy as np
import pytest

import jax

from dbg_assembly.contig.graph import GraphBuilder
from dbg_assembly.contig.mesh_assemble import (MeshGraph,
                                                   assemble_doubling_mesh)
from dbg_assembly.contig.pointer_doubling import assemble_doubling
from dbg_assembly.contig.refassemble import AssembleParams
from dbg_assembly.parallel import mesh as meshmod

ARTIFACTS = (".contig.seq.fa", ".contig.seq.depth", ".contig.small.fa",
             ".contig.small.depth", ".contig.tip.fa", ".contig.lowedge.fa",
             ".contig.bubble.fa", ".contig.kmer.freq")


def _build_table(seed=5, n_reads=3000, L=100, glen=20_000, err=0.01, k=21):
    """Reads over a small genome with enough errors to create tips and
    bubbles, so every pruning phase has work to do."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=glen).astype(np.uint8)
    starts = rng.integers(0, glen - L, size=n_reads)
    reads = np.stack([genome[s:s + L] for s in starts])
    errs = rng.random(reads.shape) < err
    reads = np.where(errs, (reads + rng.integers(1, 4, reads.shape)) % 4,
                     reads).astype(np.uint8)
    lengths = np.full(n_reads, L, np.int32)
    gb = GraphBuilder(k)
    gb.add(reads, lengths)
    return gb.finalize(), k


@pytest.fixture(scope="module")
def table_k():
    return _build_table()


def _params(k):
    return AssembleParams(ksize=k, init_hash_size=0.001,
                          contig_len_cutoff=125)


def test_mesh_assemble_byte_identical(table_k, tmp_path):
    table, k = table_k
    p = _params(k)
    single = str(tmp_path / "single")
    meshp = str(tmp_path / "mesh")
    st1 = assemble_doubling(table, p, single)
    m = meshmod.data_mesh(8)
    st2 = assemble_doubling_mesh(table, p, meshp, m)
    assert st1.contig_num == st2.contig_num
    assert st1.contig_len == st2.contig_len
    for suf in ARTIFACTS:
        a = open(single + suf, "rb").read()
        b = open(meshp + suf, "rb").read()
        assert a == b, f"artifact {suf} differs on the mesh path"
    # the pruning phases actually ran on something
    assert os.path.getsize(single + ".contig.tip.fa") > 0


def test_mesh_search_matches_host(table_k):
    table, k = table_k
    p = _params(k)
    m = meshmod.data_mesh(8)
    g = MeshGraph(table, p, m)
    g.host_search_max = 0           # every search takes the collective
    q = _probe(g, k, 257, 131)
    assert np.array_equal(g._search(q), _host_answer(g, q))


def test_mesh_small_search_stays_on_host(table_k, monkeypatch):
    """Probes up to host_search_max k-mers are answered from the host copy
    without a collective; larger ones go to the mesh; both agree."""
    from dbg_assembly.contig import mesh_assemble as ma
    table, k = table_k
    g = MeshGraph(table, _params(k), meshmod.data_mesh(8))
    calls = []
    real = ma._search_sharded
    monkeypatch.setattr(ma, "_search_sharded",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    small = _probe(g, k, 3, 2)
    assert np.array_equal(g._search(small), _host_answer(g, small))
    assert calls == []
    big = _probe(g, k, g.host_search_max, 1)
    assert np.array_equal(g._search(big), _host_answer(g, big))
    assert calls == [1]


def _probe(g, k, n_present, n_absent):
    rng = np.random.default_rng(n_present + n_absent)
    present = g.kmers[rng.integers(0, g.M, size=n_present)]
    absent = rng.integers(0, 1 << (2 * k), size=n_absent).astype(np.uint64)
    return np.concatenate([present, absent])


def _host_answer(g, q):
    idx = np.minimum(np.searchsorted(g.kmers, q), g.M - 1)
    return np.where(g.kmers[idx] == q, idx, -1)


def test_mesh_resolve_matches_host(table_k):
    table, k = table_k
    p = _params(k)
    m = meshmod.data_mesh(8)
    g = MeshGraph(table, p, m)
    rng = np.random.default_rng(1)
    n = 1000
    # random functional graph with stops and a planted cycle
    succ = rng.integers(0, n + 1, size=n).astype(np.int64)
    succ[10] = 11
    succ[11] = 12
    succ[12] = 10
    from dbg_assembly.contig import pointer_doubling as pd
    import jax.numpy as jnp
    e1, d1, c1 = (np.asarray(x) for x in
                  pd._resolve_chains(jnp.asarray(succ)))
    e2, d2, c2 = g.resolve_chains(succ)
    assert np.array_equal(c1, c2)
    nc = ~c1
    assert np.array_equal(e1[nc], e2[nc])
    assert np.array_equal(d1[nc], d2[nc])
