"""The native C++ corrector must match the Python parity engine exactly."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import golden  # noqa: E402


def test_native_matches_python_engine(tmp_path):
    from dbg_assembly.kmer import kmerfreq
    from dbg_assembly.correct import pipeline
    from dbg_assembly.correct.engine import CorrectParams

    ds = golden.sim_dataset()
    p = ds["libs"][0][0]
    lq = golden.ref_clean_lowqual(p, err=0.01, min_len=75)
    ad = golden.ref_clean_adapter(lq["out"], score=12, min_len=75)
    import shutil
    f1 = str(tmp_path / "a.fq.gz")
    f2 = str(tmp_path / "b.fq.gz")
    shutil.copy(ad["out"], f1)
    shutil.copy(ad["out"], f2)
    lib1 = str(tmp_path / "l1.lib")
    lib2 = str(tmp_path / "l2.lib")
    open(lib1, "w").write(f1 + "\n")
    open(lib2, "w").write(f2 + "\n")
    kf = kmerfreq.run(lib1, ksize=13, low_freq_cutoff=1)

    params = CorrectParams(ksize=13, max_change=2)
    pipeline.run(kf["cz"], lib1, params, fmt=1, engine="native")
    pipeline.run(kf["cz"], lib2, params, fmt=1, engine="python")

    a = golden.gunzip_bytes(f1 + ".correct.fa.gz")
    b = golden.gunzip_bytes(f2 + ".correct.fa.gz")
    assert a == b
    assert (golden.read_bytes(f1 + ".correct.stat")
            == golden.read_bytes(f2 + ".correct.stat"))
