"""Golden test of the error-correction stage: our kmerfreq replacement
produces the .cz table, the shipped correct_error_reads consumes it, and our
corrector must reproduce its output byte-for-byte.

Default run uses k=13 (8 MB table, seconds); the workflow-scale k=17 variant
(2 GiB table, ~6 min dominated by zlib of the dense table) is gated behind
DBG_SLOW_TESTS=1.
"""

import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402
import golden  # noqa: E402


def _diff(a: bytes, b: bytes, label: str):
    if a == b:
        return
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            lo = max(0, i - 100)
            raise AssertionError(
                f"{label}: first diff at byte {i}\n"
                f"ref:  ...{a[lo:i+150]!r}\n"
                f"ours: ...{b[lo:i+150]!r}")
    raise AssertionError(f"{label}: length differs {len(a)} vs {len(b)}")


def _run_correction_golden(tmpdir, ksize):
    from dbg_assembly.kmer import kmerfreq
    from dbg_assembly.correct import pipeline
    from dbg_assembly.correct.engine import CorrectParams

    ds = golden.sim_dataset()
    cleaned = []
    for p1, p2, ins in ds["libs"][:1]:
        for p in (p1, p2):
            lq = golden.ref_clean_lowqual(p, err=0.01, min_len=75)
            ad = golden.ref_clean_adapter(lq["out"], score=12, min_len=75)
            local = os.path.join(tmpdir, os.path.basename(ad["out"]))
            shutil.copy(ad["out"], local)
            cleaned.append(str(local))
    lib = os.path.join(tmpdir, "clean_reads.lib")
    with open(lib, "w") as f:
        f.write("".join(p + "\n" for p in cleaned))

    kf = kmerfreq.run(lib, ksize=ksize, low_freq_cutoff=1)
    golden.ref_correct(kf["cz"], lib, k=ksize, c=2, workdir=tmpdir)
    for p in cleaned:
        shutil.move(p + ".correct.fa.gz", p + ".correct.fa.gz.ref")
        shutil.move(p + ".correct.stat", p + ".correct.stat.ref")

    pipeline.run(kf["cz"], lib, CorrectParams(ksize=ksize, max_change=2),
                 fmt=1)
    for p in cleaned:
        _diff(golden.gunzip_bytes(p + ".correct.fa.gz.ref"),
              golden.gunzip_bytes(p + ".correct.fa.gz"),
              os.path.basename(p) + " corrected")
        _diff(golden.read_bytes(p + ".correct.stat.ref"),
              golden.read_bytes(p + ".correct.stat"),
              os.path.basename(p) + " stat")


@pytest.mark.parametrize("engine_env", [None, "DBG_JAX_CORRECT"])
def test_correct_golden_k13(tmp_path, monkeypatch, engine_env):
    monkeypatch.delenv("DBG_JAX_CORRECT", raising=False)
    if engine_env:  # the device wave/beam engine (correct/device.py)
        monkeypatch.setenv(engine_env, "1")
    _run_correction_golden(str(tmp_path), ksize=13)


@pytest.mark.skipif(os.environ.get("DBG_SLOW_TESTS") != "1",
                    reason="2 GiB k=17 table; set DBG_SLOW_TESTS=1")
def test_correct_golden_k17(tmp_path):
    _run_correction_golden(str(tmp_path), ksize=17)
