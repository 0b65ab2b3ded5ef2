"""Golden-output harness: runs the shipped reference binaries (prebuilt x86,
CPU-runnable — SURVEY.md section 4) on locally simulated reads and caches the
results for byte-level comparison against this framework.

All reference invocations use -t 1 where a thread count exists, so outputs are
deterministic (hash insertion order and branch-processing order depend on it).
Comparisons are on DECOMPRESSED bytes for .gz artifacts (gzip container bytes
differ by compressor).
"""

from __future__ import annotations

import gzip
import os
import subprocess

REF = "/root/reference"
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "_golden_cache")


def run(cmd, cwd=None, timeout=600):
    r = subprocess.run(cmd, cwd=cwd, capture_output=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"{cmd} failed rc={r.returncode}\n"
                           f"stderr: {r.stderr[-2000:].decode(errors='replace')}")
    return r


def gunzip_bytes(path: str) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def ensure_dir(p):
    os.makedirs(p, exist_ok=True)
    return p


def sim_dataset(genome_len=200_000, read_len=150, depth=20.0,
                inserts=(400, 800), seed=7) -> dict:
    """Simulated dataset cached on disk (shared with the ref binaries)."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tools.simulate_reads import generate_dataset
    key = f"g{genome_len}_l{read_len}_d{depth}_s{seed}"
    outdir = os.path.join(CACHE, "sim", key)
    marker = os.path.join(outdir, "DONE")
    if not os.path.exists(marker):
        ensure_dir(outdir)
        generate_dataset(outdir, genome_len, read_len, depth, inserts, seed)
        open(marker, "w").close()
    libs = []
    for ins in inserts:
        libs.append((os.path.join(outdir, f"sim_insert{ins}_1.fq.gz"),
                     os.path.join(outdir, f"sim_insert{ins}_2.fq.gz"), ins))
    return {"genome": os.path.join(outdir, "sim_genome.fa"), "libs": libs,
            "dir": outdir}


def ref_clean_lowqual(fq_path: str, err=0.01, min_len=75) -> dict:
    """Run reference clean_lowqual; returns output paths (cached)."""
    outdir = ensure_dir(os.path.join(CACHE, "clean_lowqual"))
    base = os.path.basename(fq_path)
    out = os.path.join(outdir, base + f".e{err}.nonLowQual.gz")
    stat = out[:-3] + ".stat"
    if not os.path.exists(stat):
        run([f"{REF}/clean_illumina/clean_lowqual", "-e", str(err),
             "-r", str(min_len), "-t", "1", fq_path, out, stat])
    return {"out": out, "stat": stat}


def ref_clean_adapter(fq_path: str, score=12, min_len=75) -> dict:
    outdir = ensure_dir(os.path.join(CACHE, "clean_adapter"))
    base = os.path.basename(fq_path)
    out = os.path.join(outdir, base + ".nonAdapter.gz")
    stat = out[:-3] + ".stat"
    if not os.path.exists(stat):
        run([f"{REF}/clean_illumina/clean_adapter", "-a",
             f"{REF}/clean_illumina/illumina_NEB_adapter.fa",
             "-r", str(min_len), "-s", str(score), "-t", "1",
             fq_path, out, stat])
    return {"out": out, "stat": stat}


def ref_correct(cz_path: str, lib_path: str, k=17, c=2, workdir=None) -> dict:
    """Run reference correct_error_reads (1-bit table).  Outputs land next to
    the read files listed in lib_path."""
    run([f"{REF}/correct_error/correct_error_reads", "-k", str(k),
         "-c", str(c), "-t", "1", cz_path, lib_path],
        cwd=workdir, timeout=1800)
    out = {}
    with open(lib_path) as f:
        for line in f:
            p = line.strip()
            if p:
                out[p] = {"out": p + ".correct.fa.gz",
                          "stat": p + ".correct.stat"}
    return out


def ref_debruijn_contig(lib_path: str, prefix: str, k=31, fmt=2,
                        max_read_len=250, min_ctg=125, workdir=None) -> dict:
    log = prefix + ".contig.log"
    with open(log, "wb") as lf:
        r = subprocess.run(
            [f"{REF}/DBG_contig/debruijn_contig", "-f", str(fmt),
             "-k", str(k), "-r", str(max_read_len), "-t", "1",
             "-i", "0.01", "-M", str(min_ctg), "-o", prefix, lib_path],
            cwd=workdir, stdout=subprocess.PIPE, stderr=lf, timeout=1800)
    if r.returncode != 0:
        raise RuntimeError(f"debruijn_contig failed: see {log}")
    return {p: prefix + p for p in
            (".contig.seq.fa", ".contig.seq.depth", ".contig.small.fa",
             ".contig.small.depth", ".contig.tip.fa", ".contig.bubble.fa",
             ".contig.lowedge.fa", ".contig.kmer.freq")} | {"log": log}


def ref_map_pair(contig_fa: str, lib_path: str, outdir: str,
                 min_ctg=125, min_read=150, workdir=None) -> None:
    run([f"{REF}/link_scaffold/map_pair", "-l", str(min_ctg),
         "-r", str(min_read), "-o", outdir, contig_fa, lib_path],
        cwd=workdir, timeout=1800)


def ref_link_scaffold(contig_fa: str, twoctg_lib: str, prefix: str,
                      insert=400, pair_cut=3, is_mate=0, workdir=None) -> None:
    run([f"{REF}/link_scaffold/link_scaffold", "-m", str(is_mate),
         "-n", str(pair_cut), "-i", str(insert), "-o", prefix,
         contig_fa, twoctg_lib], cwd=workdir, timeout=1800)


def ref_map_reads(contig_fa: str, lib_path: str, outdir: str,
                  min_ctg=125, min_read=250, workdir=None) -> None:
    run([f"{REF}/link_scaffold/map_reads", "-l", str(min_ctg),
         "-r", str(min_read), "-t", "1", "-o", outdir, contig_fa, lib_path],
        cwd=workdir, timeout=1800)


def ref_link_contig(contig_fa: str, twoctg_lib: str, prefix: str,
                    pair_cut=3, workdir=None) -> None:
    run([f"{REF}/link_scaffold/link_contig", "-n", str(pair_cut),
         "-o", prefix, contig_fa, twoctg_lib], cwd=workdir, timeout=1800)


def ref_link_supertig(contig_fa: str, twoctg_lib: str, prefix: str,
                      pair_cut=3, workdir=None) -> None:
    run([f"{REF}/link_scaffold/link_supertig", "-n", str(pair_cut),
         "-o", prefix, contig_fa, twoctg_lib], cwd=workdir, timeout=1800)
