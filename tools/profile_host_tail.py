"""Host-tail stage breakdown at E. coli scale.

Times each sub-stage of the contig and scaffold pipelines separately so
the deficit vs the reference single-thread binaries can be attributed.
Requires a populated /tmp/ecoli_scale workdir (tools/run_ecoli_scale.py).

Run:  python -u tools/profile_host_tail.py [workdir] [contig|scaffold|all]
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


def t(msg, t0):
    print(f"  {msg:38s} {time.perf_counter() - t0:7.2f}s", flush=True)
    return time.perf_counter()


def profile_contig(workdir):
    from dbg_assembly.contig.graph import GraphBuilder
    from dbg_assembly.contig.refassemble import (AssembleParams,
                                                     RefAssembler)
    from dbg_assembly.contig import pipeline as ctg
    from dbg_assembly.io import fastq

    corr_lib = os.path.join(workdir, "corr.lib")
    files = ctg.read_file_list(corr_lib)
    print("contig breakdown:", flush=True)
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    gb = GraphBuilder(31, 250)
    batches = []
    for path in files:
        batches.append(fastq.read_batch(path, fmt="fa", strict_n=False,
                                        keep_heads=False))
    t0 = t("fastq read (serial, x%d)" % len(files), t0)
    for b in batches:
        gb.add(b.codes, b.lengths)
    t0 = t("GraphBuilder.add (native ingest)", t0)
    table = gb.finalize()
    t0 = t("finalize/extract", t0)
    params = AssembleParams(ksize=31, init_hash_size=0.01)
    asm = RefAssembler(table, params)
    t0 = t("RefAssembler._build_hash", t0)
    prefix = os.path.join(workdir, "prof_asm")
    asm.run(prefix)
    t0 = t("assemble run (native)", t0)
    print(f"  {'TOTAL':38s} {time.perf_counter() - t_all:7.2f}s",
          flush=True)


def profile_scaffold(workdir, ins=400):
    from dbg_assembly.scaffold import map_pair, scaffold

    ours_prefix = os.path.join(workdir, "ours_asm")
    ctg_ours = ours_prefix + ".contig.seq.fa"
    plib = os.path.join(workdir, f"pair{ins}.lib")
    mo = os.path.join(workdir, f"prof_map{ins}")
    print(f"scaffold insert{ins} breakdown:", flush=True)
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    map_pair.run(ctg_ours, plib, mo, ksize=31, seed_kmer_num=5,
                 min_ctg_len=125, min_read_len=250, min_identity=0.97,
                 fmt=1)
    t0 = t("map_pair.run", t0)
    with open(plib) as f:
        first = f.readline().strip()
    base = os.path.basename(first)
    two = os.path.join(workdir, f"prof_two{ins}.lib")
    with open(two, "w") as f:
        f.write(f"{mo}/{base}.map_pair.2ctg.gz\n")
    scaffold.run(ctg_ours, two, ctg_ours, insert_size=ins, pair_num_cut=3)
    t0 = t("scaffold.run (link+layout)", t0)
    print(f"  {'TOTAL':38s} {time.perf_counter() - t_all:7.2f}s",
          flush=True)


if __name__ == "__main__":
    wd = sys.argv[1] if len(sys.argv) > 1 else "/tmp/ecoli_scale"
    which = sys.argv[2] if len(sys.argv) > 2 else "all"
    if which in ("contig", "all"):
        profile_contig(wd)
    if which in ("scaffold", "all"):
        profile_scaffold(wd, 400)
