"""kmerfreq `-q` quality masking.

The canonical workflow runs `kmerfreq -k 17 -m 1 -q 10`
(test/01.clean_correct/work.sh:31).  The external kmerfreq is not shipped,
so the contract is validated three ways: a brute-force oracle of the
window-masking semantics, the spectrum actually changing under -q on
degraded-quality data, and the q-masked .cz driving the SHIPPED
correct_error_reads byte-identically to our corrector.
"""
import gzip
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import golden  # noqa: E402

from dbg_assembly.kmer.kmerfreq import split_reads_by_quality  # noqa: E402


def brute_spectrum(codes, lengths, quals, k, q, shift=33):
    """Oracle: canonical k-mer multiset over windows with all quals >= q."""
    from dbg_assembly import dna
    out = {}
    for row in range(len(codes)):
        L = int(lengths[row])
        for j in range(L - k + 1):
            ql = quals[row, j:j + k].astype(int) - shift
            if (ql < q).any():
                continue
            km = dna.rolling_kmers(codes[row:row + 1, j:j + k], k)[0, 0]
            rc = dna.revcomp_kbit(np.array([km], np.uint64), k)[0]
            can = min(int(km), int(rc))
            out[can] = out.get(can, 0) + 1
    return out


def test_split_matches_bruteforce_oracle():
    rng = np.random.default_rng(3)
    N, L, k = 40, 60, 9
    codes = rng.integers(0, 4, (N, L)).astype(np.uint8)
    lengths = rng.integers(k, L + 1, N).astype(np.int32)
    quals = (rng.integers(2, 41, (N, L)) + 33).astype(np.uint8)
    # sprinkle hard-low bases
    low = rng.random((N, L)) < 0.06
    quals[low] = 33 + 2

    codes2, lens2 = split_reads_by_quality(codes, lengths, quals, k,
                                           cutoff=10)
    got = brute_spectrum(
        codes2, lens2,
        np.full(codes2.shape, 33 + 40, np.uint8), k, q=0)
    want = brute_spectrum(codes, lengths, quals, k, q=10)
    assert got == want
    assert sum(want.values()) < sum(
        brute_spectrum(codes, lengths, quals, k, q=0).values())


def test_q_masking_changes_spectrum_and_stays_byte_identical(tmp_path):
    from dbg_assembly.kmer import kmerfreq
    from dbg_assembly.correct import pipeline
    from dbg_assembly.correct.engine import CorrectParams

    k = 13
    ds = golden.sim_dataset()
    # degrade: the simulator already gives error-prone bases quals 2..14,
    # so -q 10 masks a real fraction of windows
    src = ds["libs"][0][0]
    local = str(tmp_path / os.path.basename(src))
    shutil.copy(src, local)
    lib = str(tmp_path / "reads.lib")
    open(lib, "w").write(local + "\n")

    kf0 = kmerfreq.run(lib, ksize=k, low_freq_cutoff=1,
                       out_prefix=str(tmp_path / "q0"))
    kf10 = kmerfreq.run(lib, ksize=k, low_freq_cutoff=1, qual_cutoff=10,
                        out_prefix=str(tmp_path / "q10"))
    assert kf10["individuals"] < kf0["individuals"]
    assert golden.read_bytes(kf0["stat"]) != golden.read_bytes(kf10["stat"])

    # parity: shipped corrector fed the q-masked table == our corrector
    golden.ref_correct(kf10["cz"], lib, k=k, c=2, workdir=str(tmp_path))
    shutil.move(local + ".correct.fa.gz", local + ".correct.fa.gz.ref")
    shutil.move(local + ".correct.stat", local + ".correct.stat.ref")
    pipeline.run(kf10["cz"], lib, CorrectParams(ksize=k, max_change=2),
                 fmt=1)
    assert golden.gunzip_bytes(local + ".correct.fa.gz.ref") == \
        golden.gunzip_bytes(local + ".correct.fa.gz")
    assert golden.read_bytes(local + ".correct.stat.ref") == \
        golden.read_bytes(local + ".correct.stat")
    # and the q-masked run actually corrects differently than unmasked
    pipeline.run(kf0["cz"], lib, CorrectParams(ksize=k, max_change=2),
                 fmt=1)
    assert golden.gunzip_bytes(local + ".correct.fa.gz.ref") != \
        golden.gunzip_bytes(local + ".correct.fa.gz")
