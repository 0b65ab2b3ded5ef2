"""CLI smoke tests — every subcommand parses and runs on tiny inputs."""

import gzip
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import golden  # noqa: E402
from dbg_assembly.cli import main  # noqa: E402


def _write_fq(path, n=50, L=80, seed=0):
    rng = np.random.default_rng(seed)
    with gzip.open(path, "wb") as f:
        for i in range(n):
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, L))
            f.write(f"@r{i}\n{seq}\n+\n{'I' * L}\n".encode())


def test_cli_clean_and_kmerfreq(tmp_path):
    fq = str(tmp_path / "in.fq.gz")
    _write_fq(fq)
    out = str(tmp_path / "out.gz")
    stat = str(tmp_path / "out.stat")
    assert main(["clean_lowqual", "-e", "0.01", "-r", "20", fq, out,
                 stat]) == 0
    out2 = str(tmp_path / "out2.gz")
    stat2 = str(tmp_path / "out2.stat")
    assert main(["clean_adapter", "-s", "12", "-r", "20", out, out2,
                 stat2]) == 0
    lib = str(tmp_path / "r.lib")
    open(lib, "w").write(out2 + "\n")
    assert main(["kmerfreq", "-k", "9", "-m", "1", lib]) == 0
    assert os.path.exists(lib + ".kmer.freq.cz")
    assert main(["correct_error_reads", "-k", "9", "-c", "1", "-r", "20",
                 lib + ".kmer.freq.cz", lib]) == 0
    assert os.path.exists(out2 + ".correct.fa.gz")


def test_cli_contig_and_stats(tmp_path):
    ds = golden.sim_dataset()
    lib = str(tmp_path / "reads.lib")
    open(lib, "w").write(ds["libs"][0][0] + "\n")
    prefix = str(tmp_path / "asm")
    assert main(["debruijn_contig", "-k", "21", "-i", "0.001", "-f", "1",
                 "-o", prefix, lib]) == 0
    fa = prefix + ".contig.seq.fa"
    assert os.path.exists(fa)
    assert main(["fasta_len", fa]) == 0
    assert main(["seqlen_stat", fa + ".len"]) == 0
    assert os.path.exists(fa + ".len.stat")


def test_cli_small_tools(tmp_path, capsys):
    # split_libfile
    lib = str(tmp_path / "x.lib")
    open(lib, "w").write("a.fq.gz\nb.fq.gz\n")
    assert main(["split_libfile", lib]) == 0
    assert open(lib + ".1").read() == "a.fq.gz\n"
    assert open(lib + ".2").read() == "b.fq.gz\n"
    # rev_com_seq
    fa = str(tmp_path / "x.fa")
    open(fa, "w").write(">c1 extra\nACGTN\n")
    assert main(["rev_com_seq", fa]) == 0
    txt = open(fa + ".revcom.fa").read()
    assert txt == ">c1_rc\nNACGT\n"
    # fullread_to_subread
    fq = str(tmp_path / "x.fq")
    open(fq, "w").write("@r1\nACGT\n+\nIIII\n")
    capsys.readouterr()
    assert main(["fullread_to_subread", fq, "m9"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "@m9/1/0_4 RQ=0.84"
    # simulate_lowfreq_kmer
    g = str(tmp_path / "g.fa")
    rng = np.random.default_rng(7)
    open(g, "w").write(">g\n" + "".join(
        "ACGT"[c] for c in rng.integers(0, 4, 500)) + "\n")
    capsys.readouterr()
    assert main(["simulate_lowfreq_kmer", "-k", "9", "-s", "50", g]) == 0
    out = capsys.readouterr().out
    assert "Kmer species number" in out
