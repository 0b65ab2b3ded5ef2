"""E. coli-scale validation: the full pipeline at the reference test/
workflow's scale (4.6 Mb genome, PE250 2 libraries x 20X, insert 400+800,
correction k=17, contigs k=31), our framework vs the reference binaries,
byte-compared at every stage boundary.  Writes a summary to
SCALE_VALIDATION.md.

Run:  python tools/run_ecoli_scale.py [workdir]
"""

from __future__ import annotations

import gzip
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import golden  # noqa: E402
from tools.simulate_reads import (make_genome, simulate_pe,  # noqa: E402
                                  write_fq_gz)


def gz_eq(a, b):
    with gzip.open(a, "rb") as fa, gzip.open(b, "rb") as fb:
        while True:
            ba = fa.read(1 << 20)
            bb = fb.read(1 << 20)
            if ba != bb:
                return False
            if not ba:
                return True


def f_eq(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def main(workdir="/tmp/ecoli_scale"):
    os.makedirs(workdir, exist_ok=True)
    t_all = time.time()
    log = []

    def note(msg):
        line = f"[{time.time() - t_all:8.1f}s] {msg}"
        print(line, flush=True)
        log.append(line)

    # ---- data ----
    genome_len = 4_600_000
    note(f"simulating {genome_len/1e6:.1f} Mb genome, PE250 2x20X")
    genome = make_genome(genome_len, seed=11)
    libs = []
    for ins in (400, 800):
        p1 = os.path.join(workdir, f"ecoli_ins{ins}_1.fq.gz")
        p2 = os.path.join(workdir, f"ecoli_ins{ins}_2.fq.gz")
        if not os.path.exists(p2):
            r1, q1, r2, q2 = simulate_pe(genome, 250, ins, 20.0,
                                         seed=100 + ins)
            write_fq_gz(p1, f"read_{ins}", r1, q1, 1)
            write_fq_gz(p2, f"read_{ins}", r2, q2, 2)
        libs.append((p1, p2, ins))
    note("reads ready")

    results = {}

    # ---- stage 1: cleaning (resumable) ----
    from dbg_assembly.clean import lowqual, adapter
    ours_clean, ref_clean = [], []
    t0 = time.time()
    fresh = 0
    for p1, p2, ins in libs:
        for p in (p1, p2):
            b = os.path.basename(p)
            lq = os.path.join(workdir, b + ".nonLowQual.gz")
            ad = os.path.join(workdir, b + ".nonAdapter.gz")
            if not os.path.exists(ad):
                fresh += 1
                lowqual.run_file(p, lq, lq[:-3] + ".stat", err_cutoff=0.01,
                                 min_read_len=75)
                adapter.run_file(lq, ad, ad[:-3] + ".stat",
                                 adapter_file="Both-adapter",
                                 score_cutoff=12, min_read_len=75)
            ours_clean.append(ad)
    ours_t = time.time() - t0
    if fresh < 2 * len(libs):
        # resumed run: the skipped files would bias ours_t to ~0 the same
        # way the cached reference goldens biased ref_t; re-time one full
        # fresh pass into throwaway outputs
        t0 = time.time()
        for p1, p2, ins in libs:
            for p in (p1, p2):
                b = os.path.basename(p)
                tlq = os.path.join(workdir, b + ".ourstime.lq.gz")
                tad = os.path.join(workdir, b + ".ourstime.ad.gz")
                lowqual.run_file(p, tlq, tlq + ".stat", err_cutoff=0.01,
                                 min_read_len=75)
                adapter.run_file(tlq, tad, tad + ".stat",
                                 adapter_file="Both-adapter",
                                 score_cutoff=12, min_read_len=75)
                for f in (tlq, tad, tlq + ".stat", tad + ".stat"):
                    os.unlink(f)
        ours_t = time.time() - t0
    # golden.ref_clean_* CACHE their outputs; timing the cached lookup
    # would report "ref=0.0s" while our
    # side was timed for real.  Time fresh single-thread reference runs
    # into the workdir, keep the cached outputs for the byte compare.
    import subprocess
    t0 = time.time()
    for p1, p2, ins in libs:
        for p in (p1, p2):
            b = os.path.basename(p)
            tlq = os.path.join(workdir, b + ".reftime.lq.gz")
            tad = os.path.join(workdir, b + ".reftime.ad.gz")
            subprocess.run(
                ["/root/reference/clean_illumina/clean_lowqual", "-e",
                 "0.01", "-r", "75", "-t", "1", p, tlq, tlq + ".stat"],
                check=True, capture_output=True)
            subprocess.run(
                ["/root/reference/clean_illumina/clean_adapter", "-a",
                 "/root/reference/clean_illumina/illumina_NEB_adapter.fa",
                 "-r", "75", "-s", "12", "-t", "1", tlq, tad,
                 tad + ".stat"],
                check=True, capture_output=True)
            for f in (tlq, tad, tlq + ".stat", tad + ".stat"):
                os.unlink(f)
    ref_t = time.time() - t0
    for p1, p2, ins in libs:
        for p in (p1, p2):
            r_lq = golden.ref_clean_lowqual(p, err=0.01, min_len=75)
            r_ad = golden.ref_clean_adapter(r_lq["out"], score=12,
                                            min_len=75)
            ref_clean.append(r_ad["out"])
    ok = all(gz_eq(a, b) for a, b in zip(ref_clean, ours_clean))
    results["clean"] = (ok, ours_t, ref_t)
    note(f"cleaning: match={ok} ours={ours_t:.1f}s ref={ref_t:.1f}s")

    # ---- stage 2: kmerfreq k=17 ----
    from dbg_assembly.kmer import kmerfreq
    lib = os.path.join(workdir, "clean.lib")
    with open(lib, "w") as f:
        f.write("".join(p + "\n" for p in ours_clean))
    t0 = time.time()
    if not os.path.exists(lib + ".kmer.freq.cz.len"):
        kf = kmerfreq.run(lib, ksize=17, low_freq_cutoff=1)
        note(f"kmerfreq k=17: {time.time()-t0:.1f}s "
             f"({kf['species']} species, {kf['individuals']} kmers)")
    else:
        kf = {"cz": lib + ".kmer.freq.cz"}
        note("kmerfreq: reusing cached table")

    # ---- stage 3: correction k=17 ----
    from dbg_assembly.correct import pipeline as corr
    from dbg_assembly.correct.engine import CorrectParams
    t0 = time.time()
    if not os.path.exists(ours_clean[-1] + ".correct.fa.gz.ref"):
        golden.ref_correct(kf["cz"], lib, k=17, c=2, workdir=workdir)
        for p in ours_clean:
            os.rename(p + ".correct.fa.gz", p + ".correct.fa.gz.ref")
            os.rename(p + ".correct.stat", p + ".correct.stat.ref")
    ref_t = time.time() - t0
    t0 = time.time()
    if not all(os.path.exists(p + ".correct.fa.gz") for p in ours_clean):
        corr.run(kf["cz"], lib, CorrectParams(ksize=17, max_change=2),
                 fmt=1)
    ours_t = time.time() - t0
    ok = all(gz_eq(p + ".correct.fa.gz.ref", p + ".correct.fa.gz")
             for p in ours_clean)
    ok = ok and all(f_eq(p + ".correct.stat.ref", p + ".correct.stat")
                    for p in ours_clean)
    results["correct"] = (ok, ours_t, ref_t)
    note(f"correction k=17: match={ok} ours={ours_t:.1f}s ref={ref_t:.1f}s")

    # ---- stage 4: contigs k=31 ----
    from dbg_assembly.contig import pipeline as ctg
    from dbg_assembly.contig.refassemble import AssembleParams
    corr_lib = os.path.join(workdir, "corr.lib")
    with open(corr_lib, "w") as f:
        f.write("".join(p + ".correct.fa.gz\n" for p in ours_clean))
    ref_prefix = os.path.join(workdir, "ref_asm")
    t0 = time.time()
    golden.ref_debruijn_contig(corr_lib, ref_prefix, k=31, fmt=2,
                               max_read_len=250, min_ctg=125)
    ref_t = time.time() - t0
    ours_prefix = os.path.join(workdir, "ours_asm")
    t0 = time.time()
    # init_hash_size must match golden.ref_debruijn_contig's -i 0.01 —
    # the hash size shapes slot ordering and thus every order-dependent
    # output
    ctg.run(corr_lib, ours_prefix, ksize=31, fmt=2, max_read_len=250,
            params=AssembleParams(ksize=31, init_hash_size=0.01))
    ours_t = time.time() - t0
    ok = all(f_eq(ref_prefix + s, ours_prefix + s) for s in
             (".contig.seq.fa", ".contig.seq.depth", ".contig.small.fa",
              ".contig.small.depth", ".contig.tip.fa", ".contig.bubble.fa",
              ".contig.lowedge.fa", ".contig.kmer.freq"))
    results["contig"] = (ok, ours_t, ref_t)
    note(f"contigs k=31: match={ok} ours={ours_t:.1f}s ref={ref_t:.1f}s")

    # ---- stage 5: two scaffold rounds ----
    from dbg_assembly.scaffold import map_pair, scaffold
    ctg_ours = ours_prefix + ".contig.seq.fa"
    ctg_ref = ref_prefix + ".contig.seq.fa"
    for rnd, ins in enumerate((400, 800)):
        i0 = 0 if ins == 400 else 2
        plib = os.path.join(workdir, f"pair{ins}.lib")
        with open(plib, "w") as f:
            f.write(ours_clean[i0] + "\n" + ours_clean[i0 + 1] + "\n")
        mo = os.path.join(workdir, f"ours_map{ins}")
        t0 = time.time()
        map_pair.run(ctg_ours, plib, mo, ksize=31, seed_kmer_num=5,
                     min_ctg_len=125, min_read_len=250, min_identity=0.97,
                     fmt=1)
        two = os.path.join(workdir, f"ours_two{ins}.lib")
        base = os.path.basename(ours_clean[i0])
        with open(two, "w") as f:
            f.write(f"{mo}/{base}.map_pair.2ctg.gz\n")
        scaffold.run(ctg_ours, two, ctg_ours, insert_size=ins,
                     pair_num_cut=3)
        ours_t = time.time() - t0
        mr = os.path.join(workdir, f"ref_map{ins}")
        rlib = os.path.join(workdir, f"refpair{ins}.lib")
        with open(rlib, "w") as f:
            f.write(ref_clean[i0] + "\n" + ref_clean[i0 + 1] + "\n")
        t0 = time.time()
        golden.ref_map_pair(ctg_ref, rlib, mr, min_ctg=125, min_read=250,
                            workdir=workdir)
        rtwo = os.path.join(workdir, f"ref_two{ins}.lib")
        rbase = os.path.basename(ref_clean[i0])
        with open(rtwo, "w") as f:
            f.write(f"{mr}/{rbase}.map_pair.2ctg.gz\n")
        golden.ref_link_scaffold(ctg_ref, rtwo, ctg_ref, insert=ins,
                                 pair_cut=3, workdir=workdir)
        ref_t = time.time() - t0
        ok = all(f_eq(ctg_ref + s, ctg_ours + s) for s in
                 (f".insert{ins}.scaffold.seq.fa",
                  f".insert{ins}.scaffold.pos.tab",
                  f".insert{ins}.scaffold.links.uniq"))
        results[f"scaffold{ins}"] = (ok, ours_t, ref_t)
        note(f"scaffold insert{ins}: match={ok} ours={ours_t:.1f}s "
             f"ref={ref_t:.1f}s")
        ctg_ours += f".insert{ins}.scaffold.seq.fa"
        ctg_ref += f".insert{ins}.scaffold.seq.fa"

    # ---- summary ----
    from dbg_assembly.utils import nstat
    ctg_lens = [ln for _, ln in nstat.fasta_lengths(
        ours_prefix + ".contig.seq.fa")]
    scf_lens = [ln for _, ln in nstat.fasta_lengths(ctg_ours)]
    c = nstat.seqlen_stat(ctg_lens)
    s = nstat.seqlen_stat(scf_lens)
    note(f"contigs: n={c['total_num']} len={c['total_len']} "
         f"N50={c['N50'][1]} max={c['max']}")
    note(f"scaffolds: n={s['total_num']} len={s['total_len']} "
         f"N50={s['N50'][1]} max={s['max']}")

    with open(os.path.join(ROOT, "SCALE_VALIDATION.md"), "w") as f:
        f.write("# SCALE_VALIDATION — E. coli-scale run "
                "(4.6 Mb, PE250 2x20X, k17/k31)\n\n")
        f.write("Byte-identical at every stage boundary vs the reference "
                "binaries; wall times below (reference is single-thread "
                "-t 1; ours runs the JAX compute on the CPU backend; "
                "the GPU run of the same workflow is chip_smoke.py).\n\n")
        f.write("| stage | byte-identical | ours (s) | reference (s) |\n")
        f.write("|---|---|---|---|\n")
        for k, (ok, ot, rt) in results.items():
            f.write(f"| {k} | {'yes' if ok else 'NO'} | {ot:.1f} | "
                    f"{rt:.1f} |\n")
        f.write(f"\nContigs: n={c['total_num']}, {c['total_len']} bp, "
                f"N50={c['N50'][1]}, max={c['max']}\n")
        f.write(f"\nScaffolds (after insert-800 round): n={s['total_num']}, "
                f"{s['total_len']} bp, N50={s['N50'][1]}, max={s['max']}\n")
        f.write("\nLog:\n```\n" + "\n".join(log) + "\n```\n")
    note("wrote SCALE_VALIDATION.md")


if __name__ == "__main__":
    main(*(sys.argv[1:2] or ["/tmp/ecoli_scale"]))
