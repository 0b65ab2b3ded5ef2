"""Iteration harness for the doubling-path readout (round 5).

Builds the validate_doubling_scale node table ONCE (cached as npz in
/tmp), then runs assemble_doubling under DBG_PD_PROFILE so the per-phase
and per-readout-substage walls print without re-paying simulation.

Run:  DBG_PD_PROFILE=1 python -u tools/profile_doubling_readout.py [mb]
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def get_table(genome_mb: float):
    from dbg_assembly.contig.graph import GraphBuilder, NodeTable
    from tools.simulate_reads import make_genome, simulate_pe
    from dbg_assembly import dna

    cache = f"/tmp/dbl_table_{genome_mb}.npz"
    if os.path.exists(cache):
        z = np.load(cache)
        return NodeTable(kmers=z["kmers"], lcnt=z["lcnt"], rcnt=z["rcnt"],
                         first_idx=z["first_idx"],
                         total_kmers=int(z["total_kmers"]),
                         total_reads=int(z["total_reads"]),
                         counts=z["counts"] if "counts" in z else None)
    K = 31
    genome = make_genome(int(genome_mb * 1e6), seed=11)
    gb = GraphBuilder(K, max_read_len=250)
    for ins, seed in ((400, 21), (800, 22)):
        r1, q1, r2, q2 = simulate_pe(genome, 250, ins, 20.0, seed=seed,
                                     err_start=0.001, err_end=0.001)
        for r in (r1, r2):
            codes = dna.ascii_to_codes(r)
            gb.add(codes, np.full(len(codes), 250, np.int32))
    t = gb.finalize()
    kw = dict(kmers=t.kmers, lcnt=t.lcnt, rcnt=t.rcnt,
              first_idx=t.first_idx, total_kmers=t.total_kmers,
              total_reads=t.total_reads)
    if t.counts is not None:
        kw["counts"] = t.counts
    np.savez(cache, **kw)
    return t


def main(genome_mb=4.6):
    os.environ.setdefault("DBG_PD_PROFILE", "1")
    from dbg_assembly.contig.refassemble import AssembleParams
    from dbg_assembly.contig import pointer_doubling as pd

    t0 = time.time()
    table = get_table(genome_mb)
    print(f"table: {len(table.kmers)} nodes ({time.time() - t0:.1f}s)",
          flush=True)
    init_g = max(0.02, len(table.kmers) / 0.7 / 1e9 * 1.15)
    params = AssembleParams(ksize=31, init_hash_size=init_g)
    t0 = time.time()
    st = pd.assemble_doubling(table, params, "/tmp/dbl_prof")
    print(f"doubling total: {time.time() - t0:.1f}s  "
          f"(contigs {st.contig_num})", flush=True)


if __name__ == "__main__":
    mb = float(sys.argv[1]) if len(sys.argv) > 1 else 4.6
    main(mb)
