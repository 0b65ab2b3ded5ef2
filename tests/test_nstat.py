import golden  # noqa: F401  (path setup)
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REF_LEN = ("/root/reference/test/02.build_contig/"
           "Ecoli_corrected_reads.contig.seq.fa.len")
REF_STAT = REF_LEN + ".stat"


def test_seqlen_stat_matches_shipped_fixture(tmp_path):
    """Our N50 table must reproduce the shipped seqlen_stat.pl output on the
    shipped length file."""
    from dbg_assembly.utils import nstat
    out = str(tmp_path / "stat")
    nstat.write_len_stat(REF_LEN, out, col=2)
    assert open(out).read() == open(REF_STAT).read()
