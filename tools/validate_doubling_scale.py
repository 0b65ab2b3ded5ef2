"""E. coli-scale validation of the pointer-doubling assembler.

Builds a 4.6 Mb-genome node table (PE250 2x20X with raw sequencing errors,
so tips/low-edges/bubbles are exercised in volume), runs BOTH the exact
serial replay (refassemble, native engine) and the scalable bulk path
(pointer_doubling.assemble_doubling), and checks:

  * per-record byte equality of the contig/small fasta+depth multisets
    (the doubling path reproduces the serial path's records exactly;
    only length-sort tie order may differ),
  * pruning statistics equality (tips/lowedges/bubbles removed),
  * N50 / total-length equality,
  * wall-clock of both paths.

Run:  python tools/validate_doubling_scale.py [genome_mb=4.6]
Appends a summary block to SCALE_VALIDATION.md.
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


def record_multiset(prefix, kind):
    headers, seqs = [], []
    with open(prefix + f".contig.{kind}.fa", "rb") as f:
        for line in f:
            if line.startswith(b">"):
                headers.append(line.split(b"\t", 1)[1])
            else:
                seqs.append(line.strip())
    deps = []
    with open(prefix + f".contig.{kind}.depth", "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        j = data.index(b"\n", i)
        e = data.index(b"\n", j + 1)
        deps.append(data[j + 1:e])
        i = e + 1
    assert len(seqs) == len(deps) == len(headers)
    return sorted(zip(headers, seqs, deps))


def n50(lens):
    lens = sorted(lens, reverse=True)
    total = sum(lens)
    acc = 0
    for x in lens:
        acc += x
        if acc * 2 >= total:
            return x
    return 0


def main(genome_mb=4.6):
    from tools.simulate_reads import make_genome, simulate_pe
    from dbg_assembly import dna
    from dbg_assembly.contig.graph import GraphBuilder
    from dbg_assembly.contig.refassemble import (AssembleParams,
                                                     RefAssembler)
    from dbg_assembly.contig import pointer_doubling as pd

    t_all = time.time()

    def note(msg):
        print(f"[{time.time() - t_all:7.1f}s] {msg}", flush=True)

    K = 31
    glen = int(genome_mb * 1e6)
    note(f"simulating {genome_mb} Mb genome, PE250 2x20X, err 0.1%")
    genome = make_genome(glen, seed=11)
    gb = GraphBuilder(K, max_read_len=250)
    n_reads = 0
    for ins, seed in ((400, 21), (800, 22)):
        r1, q1, r2, q2 = simulate_pe(genome, 250, ins, 20.0, seed=seed,
                                     err_start=0.001, err_end=0.001)
        for r in (r1, r2):
            codes = dna.ascii_to_codes(r)
            gb.add(codes, np.full(len(codes), 250, np.int32))
            n_reads += len(codes)
    table = gb.finalize()
    note(f"table built: {len(table.kmers)} nodes from {n_reads} reads")

    workdir = "/tmp/doubling_scale"
    os.makedirs(workdir, exist_ok=True)

    # hash sized to the node count (the reference would -e enlarge; the
    # emulation pre-sizes instead): nodes/0.7 capacity with headroom
    init_g = max(0.02, len(table.kmers) / 0.7 / 1e9 * 1.15)
    params = AssembleParams(ksize=K, init_hash_size=init_g)
    hp = os.path.join(workdir, "exact")
    t0 = time.time()
    hs = RefAssembler(table, params).run(hp)
    t_exact = time.time() - t0
    note(f"exact serial path: {t_exact:.1f}s  "
         f"(tips {hs.tips_removed}, lowedges {hs.lowedges_removed}, "
         f"bubbles {hs.bubbles_removed}, contigs {hs.contig_num})")

    params2 = AssembleParams(ksize=K, init_hash_size=init_g)
    dp = os.path.join(workdir, "dbl")
    t0 = time.time()
    ds = pd.assemble_doubling(table, params2, dp)
    t_dbl = time.time() - t0
    note(f"doubling path: {t_dbl:.1f}s  "
         f"(tips {ds.tips_removed}, lowedges {ds.lowedges_removed}, "
         f"bubbles {ds.bubbles_removed}, contigs {ds.contig_num})")

    ok_stats = (
        (hs.tips_removed, hs.tip_len_removed, hs.lowedges_removed,
         hs.lowedge_len_removed, hs.bubbles_removed, hs.bubble_len_removed,
         hs.contig_num, hs.contig_len, hs.small_num, hs.small_len)
        == (ds.tips_removed, ds.tip_len_removed, ds.lowedges_removed,
            ds.lowedge_len_removed, ds.bubbles_removed,
            ds.bubble_len_removed, ds.contig_num, ds.contig_len,
            ds.small_num, ds.small_len))
    note(f"stats equal: {ok_stats}")

    ok_rec = True
    for kind in ("seq", "small"):
        h = record_multiset(hp, kind)
        d = record_multiset(dp, kind)
        same = h == d
        ok_rec &= same
        note(f"contig.{kind} record multiset equal: {same} "
             f"({len(h)} vs {len(d)} records)")

    h_lens = [len(s) for _, s, _ in record_multiset(hp, "seq")]
    d_lens = [len(s) for _, s, _ in record_multiset(dp, "seq")]
    note(f"N50 exact={n50(h_lens)} doubling={n50(d_lens)} "
         f"total={sum(h_lens)}/{sum(d_lens)}")

    ok = ok_stats and ok_rec and n50(h_lens) == n50(d_lens)
    with open(os.path.join(ROOT, "SCALE_VALIDATION.md"), "a") as f:
        f.write(
            f"\n## Pointer-doubling assembler at {genome_mb} Mb "
            f"(validate_doubling_scale.py)\n\n"
            f"- node table: {len(table.kmers)} nodes ({n_reads} PE250 "
            f"reads, err 0.1%)\n"
            f"- pruning decisions equal: {ok_stats} (tips "
            f"{hs.tips_removed}, lowedges {hs.lowedges_removed}, bubbles "
            f"{hs.bubbles_removed})\n"
            f"- record multisets byte-equal: {ok_rec} "
            f"({hs.contig_num} contigs + {hs.small_num} small)\n"
            f"- N50: {n50(h_lens)} (both paths)\n"
            f"- wall: exact(native) {t_exact:.1f}s, doubling bulk path "
            f"{t_dbl:.1f}s\n")
    print("OVERALL:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    mb = float(sys.argv[1]) if len(sys.argv) > 1 else 4.6
    raise SystemExit(main(mb))
