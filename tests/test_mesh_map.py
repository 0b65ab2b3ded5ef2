"""Mesh-sharded read mapping (scaffold/sharded.py) must be bit-identical
to the single-device seed-and-extend kernel on the 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from dbg_assembly import dna
from dbg_assembly.parallel import mesh as meshmod
from dbg_assembly.scaffold import index as six
from dbg_assembly.scaffold import sharded as msh


def test_mesh_map_matches_single_device():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    rng = np.random.default_rng(4)
    k, S = 21, 3
    glen = 20_000
    genome = rng.integers(0, 4, size=glen).astype(np.uint8)
    ctgs = [np.frombuffer(b"ACGT", np.uint8)[genome[o:o + 4000]].tobytes()
            for o in range(0, glen - 4000, 4000)]
    ix = six._build_py(ctgs, k)   # array-backed index (the CPU
    # default engine keeps payloads in the native table)

    n, L = 203, 120                       # not divisible by 8
    starts = rng.integers(0, glen - L, size=n)
    codes = np.stack([genome[s:s + L] for s in starts])
    errs = rng.random(codes.shape) < 0.01
    codes = np.where(errs, (codes + rng.integers(1, 4, codes.shape)) % 4,
                     codes).astype(np.uint8)
    # reverse-complement half the reads so strand handling is exercised
    for i in range(0, n, 2):
        codes[i] = 3 - codes[i][::-1]
    ascii_seq = np.frombuffer(b"ACGT", np.uint8)[codes].copy()
    lengths = np.full(n, L, np.int32)

    single = six._map_reads_jax(ix, codes, ascii_seq, lengths, S, 0.95)
    m = meshmod.data_mesh(8)
    multi = msh.map_reads_sharded(m, ix, codes, ascii_seq, lengths, S, 0.95)
    for f in ("mapped", "contig", "read_start", "read_end", "contig_start",
              "contig_end", "direct", "identity"):
        np.testing.assert_array_equal(getattr(single, f), getattr(multi, f),
                                      err_msg=f)
    assert single.mapped.sum() > n // 2   # the batch actually maps
