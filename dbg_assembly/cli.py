"""Command-line layer — one subcommand per reference binary, same flags.

    python -m dbg_assembly clean_lowqual  -e 0.01 -r 75 in.fq.gz out.gz out.stat
    python -m dbg_assembly clean_adapter  -a Both-adapter -s 12 in out stat
    python -m dbg_assembly kmerfreq       -k 17 -m 1 reads.lib
    python -m dbg_assembly correct_error_reads -k 17 -c 2 freq.cz reads.lib
    python -m dbg_assembly debruijn_contig -k 31 -o prefix reads.lib
    python -m dbg_assembly map_pair       -l 125 -r 250 -o outdir ctg.fa reads.lib
    python -m dbg_assembly link_scaffold  -i 400 -o prefix ctg.fa twoctg.lib
    python -m dbg_assembly seqlen_stat    lens.file
    python -m dbg_assembly fasta_len      seqs.fa
    python -m dbg_assembly scaffold_pipeline -p recipe.para ctg.fa

Flag letters match the reference binaries (DBG_contig/main.cpp:162-196,
map_pair.cpp:50-66, link_scaffold.cpp:89-104, main_parallel_senior.cpp:
142-163, clean_lowqual.cpp:191-209, clean_adapter.cpp:272-291).
"""

from __future__ import annotations

import argparse
import json
import sys


def _clean_lowqual(argv):
    ap = argparse.ArgumentParser(prog="clean_lowqual")
    ap.add_argument("-e", type=float, default=0.001)
    ap.add_argument("-q", type=int, default=33)
    ap.add_argument("-r", type=int, default=75)
    ap.add_argument("-t", type=int, default=3)    # accepted, unused
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("stat")
    a = ap.parse_args(argv)
    from .clean import lowqual
    lowqual.run_file(a.input, a.output, a.stat, err_cutoff=a.e,
                     min_read_len=a.r, quality_shift=a.q)


def _clean_adapter(argv):
    ap = argparse.ArgumentParser(prog="clean_adapter")
    ap.add_argument("-a", default="Both-adapter")
    ap.add_argument("-b", type=int, default=0)
    ap.add_argument("-s", type=int, default=12)
    ap.add_argument("-r", type=int, default=75)
    ap.add_argument("-t", type=int, default=3)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("stat")
    a = ap.parse_args(argv)
    from .clean import adapter
    adapter.run_file(a.input, a.output, a.stat, adapter_file=a.a,
                     score_cutoff=a.s, min_read_len=a.r, use_rc=bool(a.b))


def _kmerfreq(argv):
    ap = argparse.ArgumentParser(prog="kmerfreq")
    ap.add_argument("-k", type=int, default=17)
    ap.add_argument("-m", type=int, default=1,
                    help="low frequency cutoff (bit set iff count > m)")
    ap.add_argument("-q", type=int, default=0,
                    help="quality cutoff: k-mer windows covering a base "
                         "with Phred quality < q are not counted")
    ap.add_argument("--qshift", type=int, default=33,
                    help="quality ASCII shift (Quality_shift convention, "
                         "clean_lowqual.cpp:26)")
    ap.add_argument("-f", type=int, default=1)
    ap.add_argument("lib")
    a = ap.parse_args(argv)
    from .kmer import kmerfreq
    kmerfreq.run(a.lib, ksize=a.k, low_freq_cutoff=a.m,
                 fmt="fq" if a.f == 1 else "fa",
                 qual_cutoff=a.q, qual_shift=a.qshift)


def _correct(argv):
    ap = argparse.ArgumentParser(prog="correct_error_reads")
    ap.add_argument("-k", type=int, default=17)
    ap.add_argument("-m", type=int, default=0)
    ap.add_argument("-c", type=int, default=2)
    ap.add_argument("-x", type=int, default=0)
    ap.add_argument("-n", type=int, default=5_000_000)
    ap.add_argument("-r", type=int, default=75)
    ap.add_argument("-t", type=int, default=10)
    ap.add_argument("-f", type=int, default=1)
    ap.add_argument("-j", type=int, default=0)
    ap.add_argument("--engine", choices=("auto", "native", "python", "jax"),
                    default="auto",
                    help="correction engine: auto = device (jax) on "
                    "accelerator backends, native C++ on CPU")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run the SHARDED corrector over an N-device jax "
                    "Mesh (4^k-bit table partitioned, probes collective — "
                    "the k>17 capacity path; implies --engine jax)")
    ap.add_argument("cz")
    ap.add_argument("lib")
    a = ap.parse_args(argv)
    from .correct import pipeline
    from .correct.engine import CorrectParams
    params = CorrectParams(ksize=a.k, high_freq_reg_len=a.m, max_change=a.c,
                           further_trim=a.x, max_bbt_nodes=a.n,
                           min_read_len=a.r)
    pipeline.run(a.cz, a.lib, params, fmt=a.f, engine=a.engine,
                 mesh_devices=a.mesh)
    if a.j == 1:
        from .contig.pipeline import read_file_list
        from .utils.helpers import merge_corrected_pair
        files = read_file_list(a.lib)
        for i in range(0, len(files), 2):
            merge_corrected_pair(files[i] + ".correct.fa.gz",
                                 files[i + 1] + ".correct.fa.gz")


def _debruijn_contig(argv):
    ap = argparse.ArgumentParser(prog="debruijn_contig")
    ap.add_argument("-k", type=int, default=31)
    ap.add_argument("-r", type=int, default=250)
    ap.add_argument("-f", type=int, default=1)
    ap.add_argument("-o", default="output")
    ap.add_argument("-t", type=int, default=10)
    ap.add_argument("-i", type=float, default=1.0)
    ap.add_argument("-l", type=float, default=0.7)
    ap.add_argument("-e", type=int, default=10)
    ap.add_argument("-b", type=int, default=10000)
    ap.add_argument("-D", type=int, default=2)
    ap.add_argument("-T", type=int, default=1)
    ap.add_argument("-I", type=int, default=100)
    ap.add_argument("-P", type=float, default=3.0)
    ap.add_argument("-W", type=int, default=1)
    ap.add_argument("-C", type=int, default=100)
    ap.add_argument("-G", type=float, default=3.0)
    ap.add_argument("-B", type=int, default=1)
    ap.add_argument("-U", type=int, default=100)
    ap.add_argument("-L", type=float, default=0.1)
    ap.add_argument("-E", type=float, default=0.1)
    ap.add_argument("-M", type=int, default=125)
    ap.add_argument("--readout", choices=("exact", "doubling"),
                    default="exact",
                    help="contig extraction engine: 'exact' replays the "
                    "reference serially (byte-exact); 'doubling' is the "
                    "scalable bulk-pruning + pointer-doubling assembler")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run the DISTRIBUTED contig stage over an N-device "
                    "jax Mesh (all_to_all ingest + sharded table "
                    "search/links/resolve; implies doubling-readout "
                    "semantics)")
    ap.add_argument("lib")
    a = ap.parse_args(argv)
    from .contig import pipeline
    from .contig.refassemble import AssembleParams
    params = AssembleParams(
        ksize=a.k, kmer_freq_cutoff=a.D, init_hash_size=a.i,
        load_factor=a.l, is_remove_tip=bool(a.T), tip_len_cutoff=a.I,
        tip_depth_cutoff=a.P, is_remove_lowedge=bool(a.W),
        lowedge_len_cutoff=a.C, lowedge_depth_cutoff=a.G,
        is_remove_bubble=bool(a.B), bubble_len_cutoff=a.U,
        bubble_len_diff_rate=a.L, bubble_base_diff_rate=a.E,
        contig_len_cutoff=a.M)
    stats = pipeline.run(a.lib, a.o, ksize=a.k, fmt=a.f, max_read_len=a.r,
                         params=params, readout=a.readout,
                         log_stream=sys.stderr, log_threads=a.t,
                         log_buffer=a.b, log_doublings=a.e,
                         mesh_devices=a.mesh)


def _map_pair(argv):
    ap = argparse.ArgumentParser(prog="map_pair")
    ap.add_argument("-k", type=int, default=31)
    ap.add_argument("-s", type=int, default=5)
    ap.add_argument("-l", type=int, default=125)
    ap.add_argument("-r", type=int, default=250)
    ap.add_argument("-i", type=float, default=0.97)
    ap.add_argument("-f", type=int, default=1)
    ap.add_argument("-o", default="./")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard read batches over an N-device jax Mesh "
                    "(output-identical to the single-device kernel)")
    ap.add_argument("contig_fa")
    ap.add_argument("lib")
    a = ap.parse_args(argv)
    from .scaffold import map_pair
    map_pair.run(a.contig_fa, a.lib, a.o, ksize=a.k, seed_kmer_num=a.s,
                 min_ctg_len=a.l, min_read_len=a.r, min_identity=a.i,
                 fmt=a.f, mesh_devices=a.mesh)


def _link_scaffold(argv):
    ap = argparse.ArgumentParser(prog="link_scaffold")
    ap.add_argument("-m", type=int, default=0)
    ap.add_argument("-n", type=int, default=3)
    ap.add_argument("-i", type=int, default=400)
    ap.add_argument("-o", default="Output")
    ap.add_argument("contig_fa")
    ap.add_argument("twoctg_lib")
    a = ap.parse_args(argv)
    from .scaffold import scaffold
    scaffold.run(a.contig_fa, a.twoctg_lib, a.o, insert_size=a.i,
                 pair_num_cut=a.n, is_mate=bool(a.m))


def _fasta_len(argv):
    ap = argparse.ArgumentParser(prog="fasta_len")
    ap.add_argument("fa")
    ap.add_argument("-o", default=None)
    a = ap.parse_args(argv)
    from .utils import nstat
    nstat.write_len_file(a.fa, a.o or (a.fa + ".len"))


def _seqlen_stat(argv):
    ap = argparse.ArgumentParser(prog="seqlen_stat")
    ap.add_argument("-col", type=int, default=2)
    ap.add_argument("len_file")
    ap.add_argument("-o", default=None)
    a = ap.parse_args(argv)
    from .utils import nstat
    nstat.write_len_stat(a.len_file, a.o or (a.len_file + ".stat"),
                         col=a.col)


def _correct_8bit(argv):
    ap = argparse.ArgumentParser(prog="correct_error")
    ap.add_argument("-k", type=int, default=17)
    ap.add_argument("-l", type=int, default=10)
    ap.add_argument("-m", type=int, default=0)
    ap.add_argument("-c", type=int, default=2)
    ap.add_argument("-x", type=int, default=0)
    ap.add_argument("-n", type=int, default=15_000_000)
    ap.add_argument("-r", type=int, default=50)
    ap.add_argument("-f", type=int, default=1)
    ap.add_argument("-j", type=int, default=1)
    ap.add_argument("cz")
    ap.add_argument("lib")
    a = ap.parse_args(argv)
    from .correct import pipeline
    pipeline.run_8bit(a.cz, a.lib, ksize=a.k, low_freq_cutoff=a.l,
                      max_change=a.c, high_freq_reg_len=a.m,
                      further_trim=a.x, min_read_len=a.r,
                      max_bbt_nodes=a.n, fmt=a.f, join=(a.j == 1))


def _map_reads(argv):
    ap = argparse.ArgumentParser(prog="map_reads")
    ap.add_argument("-k", type=int, default=31)
    ap.add_argument("-s", type=int, default=5)
    ap.add_argument("-l", type=int, default=125)
    ap.add_argument("-r", type=int, default=250)
    ap.add_argument("-i", type=float, default=0.97)
    ap.add_argument("-f", type=int, default=1)
    ap.add_argument("-o", default="./")
    ap.add_argument("-t", type=int, default=10)
    ap.add_argument("contig_fa")
    ap.add_argument("lib")
    a = ap.parse_args(argv)
    from .scaffold import map_reads
    map_reads.run(a.contig_fa, a.lib, a.o, ksize=a.k, seed_kmer_num=a.s,
                  min_ctg_len=a.l, min_read_len=a.r, min_identity=a.i,
                  fmt=a.f)


def _link_contig(argv):
    ap = argparse.ArgumentParser(prog="link_contig")
    ap.add_argument("-n", type=int, default=3)
    ap.add_argument("-o", default="Output")
    ap.add_argument("contig_fa")
    ap.add_argument("twoctg_lib")
    a = ap.parse_args(argv)
    from .scaffold import link_contig
    link_contig.run(a.contig_fa, a.twoctg_lib, a.o, pair_num_cut=a.n)


def _link_supertig(argv):
    ap = argparse.ArgumentParser(prog="link_supertig")
    ap.add_argument("-n", type=int, default=3)
    ap.add_argument("-o", default="Output")
    ap.add_argument("contig_fa")
    ap.add_argument("twoctg_lib")
    a = ap.parse_args(argv)
    from .scaffold import link_contig
    link_contig.run_supertig(a.contig_fa, a.twoctg_lib, a.o,
                             pair_num_cut=a.n)


def _redecide(argv):
    ap = argparse.ArgumentParser(prog="redecide_contig_and_small")
    ap.add_argument("--scafftig", action="store_true")
    ap.add_argument("contig_file")
    ap.add_argument("small_file")
    ap.add_argument("len_cutoff", type=int, nargs="?", default=100)
    a = ap.parse_args(argv)
    from .utils.helpers import redecide_contig_and_small
    if a.scafftig:
        redecide_contig_and_small(a.contig_file, a.small_file, a.len_cutoff,
                                  prefix="sct", small_prefix="smalltig")
    else:
        redecide_contig_and_small(a.contig_file, a.small_file, a.len_cutoff)


def _filter_unpaired(argv):
    ap = argparse.ArgumentParser(prog="filter_unpaired_reads")
    ap.add_argument("reads1")
    ap.add_argument("reads2")
    a = ap.parse_args(argv)
    from .utils.helpers import filter_unpaired_reads
    filter_unpaired_reads(a.reads1, a.reads2)


def _merge_assembly(argv):
    ap = argparse.ArgumentParser(prog="merge_assembly")
    ap.add_argument("--output_prefix", default="Output")
    ap.add_argument("--seqidprefix", default="TMC_")
    ap.add_argument("psl_best")
    ap.add_argument("scafftig_fa")
    ap.add_argument("utg_fa")
    a = ap.parse_args(argv)
    from .utils.merge_assembly import run
    run(a.psl_best, a.scafftig_fa, a.utg_fa, a.output_prefix, a.seqidprefix)


def _blasrm4(argv):
    ap = argparse.ArgumentParser(prog="blasrm4")
    ap.add_argument("stage", choices=["besthit", "map", "twoctg",
                                      "fullread_to_subread"])
    ap.add_argument("input")
    ap.add_argument("extra", nargs="?", default=None)
    ap.add_argument("--fileformat", default="blasrm4")
    ap.add_argument("--endlencut", type=int, default=100)
    ap.add_argument("--alignlencut", type=int, default=1000)
    ap.add_argument("--identitycut", type=float, default=0.7)
    a = ap.parse_args(argv)
    from .utils import pacbio
    with open(a.input) as f:
        lines = f.read().splitlines()
    if a.stage == "besthit":
        for line in pacbio.blasrm4_besthit(lines, a.fileformat):
            print(line)
    elif a.stage == "map":
        out, stats = pacbio.blasrm4_map(lines, a.endlencut, a.alignlencut,
                                        a.identitycut)
        for line in out:
            print(line)
        for k, v in stats.items():
            print(f"{k}: {v}", file=sys.stderr)
    elif a.stage == "twoctg":
        reps = []
        if a.extra:
            with open(a.extra) as f:
                reps = [ln.split()[0] for ln in f if ln.split()]
        for line in pacbio.blasrm4_twoctg(lines, reps):
            print(line)
    else:
        for line in pacbio.fullread_to_subread(lines, a.extra or "m0001"):
            print(line)


def _split_libfile(argv):
    ap = argparse.ArgumentParser(
        prog="split_libfile",
        description="split a .lib into one-line libs for job arrays "
                    "(parity: correct_error/split_libfile.pl)")
    ap.add_argument("lib")
    a = ap.parse_args(argv)
    from .utils.helpers import split_libfile
    for p in split_libfile(a.lib):
        print(p)


def _rev_com_seq(argv):
    ap = argparse.ArgumentParser(
        prog="rev_com_seq",
        description="reverse-complement every FASTA record "
                    "(parity: link_scaffold/rev_com_seq.pl)")
    ap.add_argument("fasta")
    ap.add_argument("-o", default=None,
                    help="output path (default <fasta>.revcom.fa)")
    a = ap.parse_args(argv)
    from .utils.helpers import rev_com_seq_file
    out = a.o or a.fasta + ".revcom.fa"
    rev_com_seq_file(a.fasta, out)
    print(out)


def _fullread_to_subread(argv):
    ap = argparse.ArgumentParser(
        prog="fullread_to_subread",
        description="pbsim FASTQ -> PacBio-style subread headers "
                    "(parity: link_scaffold/fullread_to_subread.pl)")
    ap.add_argument("fastq")
    ap.add_argument("smart_cell_id", nargs="?", default="m0001")
    a = ap.parse_args(argv)
    from .utils import pacbio
    with open(a.fastq) as f:
        lines = f.read().splitlines()
    for line in pacbio.fullread_to_subread(lines, a.smart_cell_id):
        print(line)


def _simulate_lowfreq_kmer(argv):
    ap = argparse.ArgumentParser(
        prog="simulate_lowfreq_kmer",
        description="k-size selection research tool "
                    "(parity: correct_error/simulate_lowfreq_kmer.cpp)")
    ap.add_argument("-k", type=int, default=17, help="kmer size")
    ap.add_argument("-s", type=int, default=100, help="mutation spacing bp")
    ap.add_argument("genome")
    a = ap.parse_args(argv)
    from .utils.simulate_lowfreq import run
    run(a.genome, a.k, a.s)


def _pipeline(argv):
    ap = argparse.ArgumentParser(
        prog="pipeline",
        description="full workflow: clean -> correct -> contigs -> "
                    "iterative scaffolding (see workflow.py)")
    ap.add_argument("-k", type=int, default=17, help="correction kmer size")
    ap.add_argument("-K", type=int, default=31, help="contig kmer size")
    ap.add_argument("-w", default="./assembly_work", help="work dir")
    ap.add_argument("-p", default=None, help=".para scaffold recipe")
    ap.add_argument("--readout", choices=("exact", "doubling"),
                    default="exact", help="contig extraction engine (see "
                    "debruijn_contig --readout)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run correction, contigs and mapping over an "
                    "N-device jax Mesh (see their own --mesh)")
    ap.add_argument("libs", nargs="+",
                    help="read1,read2,insert triples (comma separated)")
    a = ap.parse_args(argv)
    from .workflow import PipelineConfig, run_full
    raw = []
    for spec in a.libs:
        r1, r2, ins = spec.split(",")
        raw.append((r1, r2, int(ins)))
    cfg = PipelineConfig(correct_k=a.k, contig_k=a.K, readout=a.readout,
                         mesh_devices=a.mesh)
    out = run_full(raw, cfg, a.w, a.p)
    print(json.dumps(out))


COMMANDS = {
    "clean_lowqual": _clean_lowqual,
    "clean_adapter": _clean_adapter,
    "kmerfreq": _kmerfreq,
    "correct_error_reads": _correct,
    "correct_error": _correct_8bit,
    "debruijn_contig": _debruijn_contig,
    "map_pair": _map_pair,
    "map_reads": _map_reads,
    "link_scaffold": _link_scaffold,
    "link_contig": _link_contig,
    "link_supertig": _link_supertig,
    "fasta_len": _fasta_len,
    "seqlen_stat": _seqlen_stat,
    "redecide_contig_and_small": _redecide,
    "filter_unpaired_reads": _filter_unpaired,
    "merge_assembly": _merge_assembly,
    "blasrm4": _blasrm4,
    "split_libfile": _split_libfile,
    "rev_com_seq": _rev_com_seq,
    "fullread_to_subread": _fullread_to_subread,
    "simulate_lowfreq_kmer": _simulate_lowfreq_kmer,
    "pipeline": _pipeline,
}


# --platform value -> the jax_platforms name of the installed jax ("gpu" is
# an alias there that also tries ROCm, which must not mask a missing card)
PLATFORMS = {"cpu": "cpu", "gpu": "cuda"}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # --platform pins the backend before first jax use: cpu runs the native
    # host engines, gpu the device engines.  gpu on a machine without one
    # is an error, never a silent CPU run.
    if len(argv) >= 2 and argv[0] == "--platform":
        plat, argv = argv[1], argv[2:]
        if plat not in PLATFORMS:
            print(f"--platform must be one of {', '.join(PLATFORMS)}",
                  file=sys.stderr)
            return 2
        import jax
        jax.config.update("jax_platforms", PLATFORMS[plat])
        try:
            backend = jax.default_backend()
        except (RuntimeError, AssertionError) as e:
            # jax asserts when the listed platforms yield no backend at all
            backend = f"none ({type(e).__name__}: {e})"
        if backend != plat:
            print(f"--platform {plat}: no {plat} backend found, got "
                  f"{backend}", file=sys.stderr)
            return 2
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m dbg_assembly [--platform cpu|gpu] "
              "<command> [args]\n"
              "commands: " + " ".join(sorted(COMMANDS)))
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd}; commands: "
              + " ".join(sorted(COMMANDS)), file=sys.stderr)
        return 2
    COMMANDS[cmd](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
