"""Golden parity tests for the small helper equivalents (Perl scripts and
the corrected-pair merger) against the reference scripts/binaries.

Covers the PARITY.md rows previously marked impl-without-golden:
filter_unpaired_reads.pl, split_libfile.pl, rev_com_seq.pl,
redecide_contig_and_small.pl (+ scafftig variant), merge_assembly.pl, and
merge_two_corr_files (correct_error_reads -j 1).
"""

import gzip
import os
import re
import shutil
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import golden  # noqa: E402

REF = "/root/reference"


def _write_fq_gz(path, records):
    with gzip.open(path, "wb") as f:
        for name, seq, qual in records:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n".encode())


def _rand_seq(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def test_filter_unpaired_matches_perl(tmp_path):
    from dbg_assembly.utils.helpers import filter_unpaired_reads

    rng = np.random.default_rng(5)
    rec1, rec2 = [], []
    for i in range(60):
        kind = rng.integers(0, 4)
        n1 = 0 if kind == 1 or kind == 3 else int(rng.integers(30, 80))
        n2 = 0 if kind == 2 or kind == 3 else int(rng.integers(30, 80))
        name = f"read_{i} extra tokens RQ: 0.1%"
        rec1.append((name, _rand_seq(rng, n1), "I" * n1))
        rec2.append((name, _rand_seq(rng, n2), "I" * n2))
    r1 = str(tmp_path / "lib_1.fq.gz")
    r2 = str(tmp_path / "lib_2.fq.gz")
    _write_fq_gz(r1, rec1)
    _write_fq_gz(r2, rec2)

    subprocess.run(["perl", f"{REF}/clean_illumina/filter_unpaired_reads.pl",
                    r1, r2], cwd=tmp_path, capture_output=True, check=True)
    ours1 = str(tmp_path / "ours.pe1.gz")
    ours2 = str(tmp_path / "ours.pe2.gz")
    stats = filter_unpaired_reads(r1, r2, ours1, ours2)
    assert golden.gunzip_bytes(str(tmp_path / "lib_1.fq.gz.pe1.gz")) \
        == golden.gunzip_bytes(ours1)
    assert golden.gunzip_bytes(str(tmp_path / "lib_2.fq.gz.pe2.gz")) \
        == golden.gunzip_bytes(ours2)
    assert stats["both"] + stats["single"] + stats["empty"] == 60


def test_split_libfile_matches_perl(tmp_path):
    from dbg_assembly.utils.helpers import split_libfile

    content = "a/b/reads_1.fq.gz\n\n/x/reads_2.fq.gz\nlast_no_newline"
    ours_lib = tmp_path / "ours.lib"
    ref_lib = tmp_path / "ref.lib"
    ours_lib.write_text(content)
    ref_lib.write_text(content)
    subprocess.run(["perl", f"{REF}/correct_error/split_libfile.pl",
                    str(ref_lib)], cwd=tmp_path, capture_output=True,
                   check=True)
    outs = split_libfile(str(ours_lib))
    ref_outs = sorted(tmp_path.glob("ref.lib.*"), key=lambda p: str(p))
    assert len(outs) == len(ref_outs) == 4
    for i, p in enumerate(outs, 1):
        assert p == str(ours_lib) + f".{i}"
        assert open(p).read() == open(str(ref_lib) + f".{i}").read()


def _write_fasta(path, records, width=0):
    with open(path, "w") as f:
        for head, seq in records:
            f.write(">" + head + "\n")
            if width:
                for i in range(0, len(seq), width):
                    f.write(seq[i:i + width] + "\n")
            else:
                f.write(seq + "\n")


def test_rev_com_seq_matches_perl(tmp_path):
    from dbg_assembly.utils.helpers import rev_com_seq_file

    rng = np.random.default_rng(9)
    recs = []
    for i in (3, 11, 1, 20, 7):
        seq = _rand_seq(rng, int(rng.integers(20, 180)))
        # mix lowercase + N runs
        seq = seq[:5].lower() + seq[5:15] + "NNN" + seq[15:]
        recs.append((f"ctg_{i} len={len(seq)} cov 3.5", seq))
    fa = str(tmp_path / "in.fa")
    _write_fasta(fa, recs, width=60)

    ref = subprocess.run(["perl", f"{REF}/link_scaffold/rev_com_seq.pl", fa],
                         capture_output=True, check=True).stdout
    out = str(tmp_path / "out.fa")
    rev_com_seq_file(fa, out)
    assert open(out, "rb").read() == ref


def _redecide_ref(script, contig_fa, small_fa, cutoff, cwd):
    subprocess.run(["perl", f"{REF}/DBG_contig/{script}", contig_fa,
                    small_fa, str(cutoff)], cwd=cwd, capture_output=True,
                   check=True)
    return (f"{contig_fa}.len{cutoff}.fa", f"{small_fa}.len{cutoff}.fa")


def test_redecide_matches_perl(tmp_path):
    from dbg_assembly.utils.helpers import redecide_contig_and_small

    rng = np.random.default_rng(17)
    big, small = [], []
    for i in range(1, 40, 2):
        n = int(rng.integers(80, 400))
        big.append((f"{i} length {n} cvg_30.0", _rand_seq(rng, n)))
    for i in range(1, 30):
        n = int(rng.integers(40, 260))
        small.append((f"{i} length {n}", _rand_seq(rng, n)))

    for script, prefix, sprefix in (
            ("redecide_contig_and_small.pl", "ctg", "small"),
            ("redecide_scafftig_and_smalltig.pl", "sct", "smalltig")):
        d = tmp_path / prefix
        d.mkdir()
        ref_c = str(d / "ref_contig.fa")
        ref_s = str(d / "ref_small.fa")
        ours_c = str(d / "ours_contig.fa")
        ours_s = str(d / "ours_small.fa")
        _write_fasta(ref_c, big, width=70)
        _write_fasta(ref_s, small, width=70)
        _write_fasta(ours_c, big, width=70)
        _write_fasta(ours_s, small, width=70)
        rb, rs = _redecide_ref(script, ref_c, ref_s, 200, d)
        ob, os_ = redecide_contig_and_small(ours_c, ours_s, 200,
                                            prefix, sprefix)
        assert open(ob).read() == open(rb).read()
        assert open(os_).read() == open(rs).read()


def test_merge_corrected_pair_matches_binary(tmp_path):
    """Isolates merge_two_corr_files: the reference binary corrects AND
    merges (-j 1); our merger is applied to the binary's own corrected
    outputs and must reproduce .pair.fa.gz/.single.fa.gz/.pair.single.stat
    byte-for-byte (correct.cpp:851-922)."""
    from dbg_assembly.kmer import kmerfreq
    from dbg_assembly.utils.helpers import merge_corrected_pair

    ds = golden.sim_dataset()
    cleaned = []
    for p1, p2, _ in ds["libs"][:1]:
        for p in (p1, p2):
            lq = golden.ref_clean_lowqual(p, err=0.01, min_len=75)
            ad = golden.ref_clean_adapter(lq["out"], score=12, min_len=75)
            local = os.path.join(tmp_path, os.path.basename(ad["out"]))
            shutil.copy(ad["out"], local)
            cleaned.append(str(local))
    lib = os.path.join(tmp_path, "clean_reads.lib")
    with open(lib, "w") as f:
        f.write("".join(p + "\n" for p in cleaned))
    kf = kmerfreq.run(lib, ksize=13, low_freq_cutoff=1)
    # run 1 (no -j): capture the corrected per-file outputs (the -j run
    # deletes them after merging, main_parallel_senior.cpp:257-263)
    golden.run([f"{REF}/correct_error/correct_error_reads", "-k", "13",
                "-c", "2", "-t", "1", kf["cz"], lib],
               cwd=tmp_path, timeout=1800)
    m1 = os.path.join(tmp_path, "ours_1.fa.gz")
    m2 = os.path.join(tmp_path, "ours_2.fa.gz")
    shutil.copy(cleaned[0] + ".correct.fa.gz", m1)
    shutil.copy(cleaned[1] + ".correct.fa.gz", m2)
    # run 2 (-j 1): produces the reference .pair/.single/.stat
    golden.run([f"{REF}/correct_error/correct_error_reads", "-k", "13",
                "-c", "2", "-t", "1", "-j", "1", kf["cz"], lib],
               cwd=tmp_path, timeout=1800)

    ref_pair = cleaned[0] + ".correct.fa.gz.pair.fa.gz"
    ref_single = cleaned[0] + ".correct.fa.gz.single.fa.gz"
    ref_stat = cleaned[0] + ".correct.fa.gz.pair.single.stat"
    assert os.path.exists(ref_pair)

    res = merge_corrected_pair(m1, m2)
    assert golden.gunzip_bytes(res["pair"]) == golden.gunzip_bytes(ref_pair)
    assert golden.gunzip_bytes(res["single"]) \
        == golden.gunzip_bytes(ref_single)
    assert open(m1 + ".pair.single.stat").read() == open(ref_stat).read()


def _psl_line(rng, qname, tname, qsize, tsize, good=True):
    qstart = int(rng.integers(0, qsize // 4))
    qend = int(rng.integers(qstart + (qsize * 3) // 4, qsize + 1)) \
        if good else int(rng.integers(qstart + 1, qstart + qsize // 4 + 2))
    tstart = int(rng.integers(0, max(tsize - (qend - qstart), 1)))
    tend = min(tstart + (qend - qstart) + int(rng.integers(0, 20)), tsize)
    span = qend - qstart
    mismatch = int(rng.integers(0, max(span // 50, 1)))
    match = span - mismatch
    strand = "+" if rng.integers(0, 2) else "-"
    return (f"{match}\t{mismatch}\t0\t0\t1\t{int(rng.integers(0, 3))}\t1\t"
            f"{int(rng.integers(0, 3))}\t{strand}\t{qname}\t{qsize}\t"
            f"{qstart}\t{qend}\t{tname}\t{tsize}\t{tstart}\t{tend}\t1\t"
            f"{span},\t{qstart},\t{tstart},")


def test_merge_assembly_matches_perl(tmp_path):
    """Aligned (Merged_illumina_pacbio) section is deterministic in the
    Perl (sort keys) — compared byte-for-byte.  Unaligned sections iterate
    Perl hash order — compared as id-normalized sets."""
    from dbg_assembly.utils.merge_assembly import run as merge_run

    rng = np.random.default_rng(23)
    scafftigs, utgs = [], []
    for i in range(14):
        n = int(rng.integers(300, 1200))
        scafftigs.append((f"sct_{2 * i + 1} len {n}", _rand_seq(rng, n)))
    for i in range(6):
        n = int(rng.integers(2000, 6000))
        utgs.append((f"utg_{i:03d}", _rand_seq(rng, n)))
    sct_fa = str(tmp_path / "sct.fa")
    utg_fa = str(tmp_path / "utg.fa")
    _write_fasta(sct_fa, scafftigs, width=80)
    _write_fasta(utg_fa, utgs, width=80)

    lines = []
    pos = {}
    for i, (h, s) in enumerate(scafftigs[:10]):
        qname = h.split()[0]
        tname = utgs[i % 4][0]
        tlen = len(utgs[i % 4][1])
        good = i % 5 != 4
        lines.append(_psl_line(rng, qname, tname, len(s), tlen, good))
        pos[qname] = 1
    psl = str(tmp_path / "best.psl")
    with open(psl, "w") as f:
        f.write("\n".join(lines) + "\n")

    subprocess.run(["perl", f"{REF}/link_scaffold/merge_assembly.pl",
                    "--output_prefix", "REFOUT", psl, sct_fa, utg_fa],
                   cwd=tmp_path, capture_output=True, check=True)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        merge_run(psl, sct_fa, utg_fa, output_prefix="OURSOUT")
    finally:
        os.chdir(cwd)

    def split_sections(seq_path, pos_path):
        txt = open(seq_path).read()
        # split eats one newline mid-file while the final record keeps its
        # trailing blank line — normalize trailing newlines per record
        # (which record is last depends on Perl hash order)
        recs = ["\n>" + r.rstrip("\n") + "\n" for r in txt.split("\n>")]
        recs[0] = recs[0][1:]
        aligned, rest = [], []
        for r in recs:
            (aligned if "Merged_illumina_pacbio" in r else rest).append(r)
        # normalize the running seq id in unaligned records
        rest = sorted(re.sub(r"TMC_\d+", "TMC_X", r) for r in rest)
        pos_lines = open(pos_path).read().splitlines(keepends=True)
        pal, prest = [], []
        ids_aligned = {r.split()[0].lstrip(">\n") for r in aligned}
        for ln in pos_lines:
            (pal if ln.startswith("#") or ln.split("\t")[0] in ids_aligned
             else prest).append(ln)
        prest = sorted(re.sub(r"^TMC_\d+", "TMC_X", ln) for ln in prest)
        return aligned, rest, pal, prest

    ra, rr, rpa, rpr = split_sections(str(tmp_path / "REFOUT.merged_assembly.seq.fa"),
                                      str(tmp_path / "REFOUT.merged_assembly.pos.tab"))
    oa, orr, opa, opr = split_sections(str(tmp_path / "OURSOUT.merged_assembly.seq.fa"),
                                       str(tmp_path / "OURSOUT.merged_assembly.pos.tab"))
    assert ra == oa
    assert rr == orr
    assert rpa == opa
    assert rpr == opr
