"""Parity tests of the PacBio converter chain against the reference Perl
scripts (Perl is available on this host)."""

import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REF = "/root/reference/link_scaffold"


def _synth_blasrm4(n=300, seed=0):
    rng = np.random.default_rng(seed)
    lines = ["qName tName score percentSimilarity qStrand qStart qEnd "
             "qLength tStrand tStart tEnd tLength mapQV"]
    for i in range(n):
        qid = f"S1_{rng.integers(1, 60)}"
        tid = f"sct_{2 * rng.integers(0, 30) + 1}"
        qlen = int(rng.integers(3000, 20000))
        qstart = int(rng.integers(0, qlen // 2))
        qend = int(rng.integers(qstart + 500, qlen + 1))
        tlen = int(rng.integers(2000, 90000))
        tstart = int(rng.integers(0, max(tlen - 1000, 1)))
        tend = int(rng.integers(tstart + 400, tlen + 1))
        ident = round(float(rng.uniform(60, 99.9)), 4)
        strand = int(rng.integers(0, 2))
        lines.append(f"{qid} {tid} -{rng.integers(100,9000)} {ident} 0 "
                     f"{qstart} {qend} {qlen} {strand} {tstart} {tend} "
                     f"{tlen} 254")
    return lines


def test_blasrm4_chain_matches_perl(tmp_path):
    from dbg_assembly.utils import pacbio

    raw = _synth_blasrm4()
    inp = tmp_path / "x.blasrm4"
    inp.write_text("\n".join(raw) + "\n")

    # besthit
    ref_best = subprocess.run(["perl", f"{REF}/blasrm4_besthit.pl",
                               str(inp)], capture_output=True, check=True,
                              text=True).stdout
    ours_best = "".join(x + "\n" for x in
                        pacbio.blasrm4_besthit(raw, "blasrm4"))
    assert ref_best == ours_best

    best_file = tmp_path / "x.best"
    best_file.write_text(ours_best)

    # map
    ref_map = subprocess.run(["perl", f"{REF}/blasrm4_map.pl",
                              "--alignlencut", "500", str(best_file)],
                             capture_output=True, check=True,
                             text=True).stdout
    out, stats = pacbio.blasrm4_map(ours_best.splitlines(),
                                    align_len_cut=500)
    ours_map = "".join(x + "\n" for x in out)
    assert ref_map == ours_map

    map_file = tmp_path / "x.map"
    map_file.write_text(ours_map)

    # twoctg
    ref_two = subprocess.run(["perl", f"{REF}/blasrm4_twoctg.pl",
                              str(map_file)], capture_output=True,
                             check=True, text=True).stdout
    ours_two = "".join(x + "\n" for x in
                       pacbio.blasrm4_twoctg(ours_map.splitlines()))
    assert ref_two == ours_two


def test_fullread_to_subread_matches_perl(tmp_path):
    from dbg_assembly.utils import pacbio

    rng = np.random.default_rng(1)
    lines = []
    for i in range(20):
        L = int(rng.integers(50, 200))
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, L))
        lines += [f"@S1_{i}", seq, "+", "I" * L]
    fq = tmp_path / "r.fq"
    fq.write_text("\n".join(lines) + "\n")
    ref = subprocess.run(["perl", f"{REF}/fullread_to_subread.pl", str(fq),
                          "m0001"], capture_output=True, check=True,
                         text=True).stdout
    ours = "".join(x + "\n" for x in
                   pacbio.fullread_to_subread(lines, "m0001"))
    assert ref == ours
