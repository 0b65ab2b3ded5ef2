"""k=19 sharded-correction capacity demonstration.

The k=19 1-bit table is 4^19 bits = 32 GiB (correct_error/main.cpp:163-173)
— more than a small device's memory, which is why the corrector can run
where the table lives: sharded, 4 GiB/device on 8.  This test
builds the real 32 GiB table, shards it over the 8-device CPU mesh, runs
the COMPLETE 5-phase corrector on it, and checks bit-equality against the
host parity engine.

Gated behind DBG_SLOW_TESTS=1 (allocates ~70 GiB of host RAM transiently;
this box has 125 GiB).
"""

import os

import numpy as np
import pytest

import jax

pytestmark = pytest.mark.skipif(
    os.environ.get("DBG_SLOW_TESTS") != "1",
    reason="32 GiB k=19 table; set DBG_SLOW_TESTS=1")

K = 19


def test_k19_sharded_correction_matches_host_engine():
    from dbg_assembly.correct import sharded
    from dbg_assembly.correct.engine import (CorrectParams,
                                                 ReadCorrector,
                                                 classify_regions_batch)
    from dbg_assembly.kmer import count as kc
    from jax.sharding import Mesh

    devs = jax.devices()
    assert len(devs) >= 8, "needs the 8-device CPU mesh"
    mesh = Mesh(np.array(devs[:8]), ("d",))

    rng = np.random.default_rng(19)
    glen, L, n = 3_000, 150, 256     # ~12.8x coverage: genomic
    # k-mers land high-freq, planted errors low-freq
    genome = rng.integers(0, 4, size=glen).astype(np.uint8)
    starts = rng.integers(0, glen - L, size=n)
    codes = np.stack([genome[s:s + L] for s in starts])
    errs = rng.random(codes.shape) < 0.01
    codes = np.where(errs, (codes + rng.integers(1, 4, codes.shape)) % 4,
                     codes).astype(np.uint8)
    ascii_seq = np.frombuffer(b"ACGT", np.uint8)[codes].copy()
    lengths = np.full(n, L, np.int32)

    counter = kc.KmerCounter(K)
    counter.add(codes, lengths)
    uniq, counts, _ = counter.finalize()
    bm = kc.freq_bitmap(uniq, counts, K, 1)          # 32 GiB
    bm = kc.expand_bitmap_rc(bm, K)
    assert bm.nbytes == (1 << (2 * K)) // 8

    p = CorrectParams(ksize=K, max_change=2)
    bm_shard = sharded.shard_bitmap(mesh, bm)
    got = sharded.correct_batch_sharded(mesh, ascii_seq, codes, lengths,
                                        bm_shard, p)
    one, multi, deleted, tl, tr, am, fb = got

    # host parity engine on the same reads/table
    pr = p.resolved()
    bits = classify_regions_batch(codes, lengths, bm, pr.ksize)
    n_checked = 0
    for i in range(n):
        if fb[i]:
            continue                    # fallback rows re-run on host anyway
        L = int(lengths[i])
        read = bytearray(ascii_seq[i, :L].tobytes())
        corr = ReadCorrector(bm, pr)
        ho, hm, hd, htl, htr = corr.correct_one_read(
            read, bits[i, :L - pr.ksize + 1])
        assert ho == int(one[i]), i
        assert hm == int(multi[i]), i
        assert hd == int(deleted[i]), i
        assert htl == int(tl[i]), i
        assert htr == int(tr[i]), i
        assert bytes(read) == am[i, :L].tobytes(), i
        n_checked += 1
    assert n_checked > n // 2
    assert int(one.sum() + multi.sum()) > 0        # real work happened
