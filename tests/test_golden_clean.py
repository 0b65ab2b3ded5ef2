"""Byte-level golden tests of the cleaning stage vs the shipped reference
binaries (clean_lowqual / clean_adapter) on simulated reads."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import golden  # noqa: E402


def _first_diff(a: bytes, b: bytes, label: str):
    if a == b:
        return
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            lo = max(0, i - 80)
            raise AssertionError(
                f"{label}: first diff at byte {i}\n"
                f"ref:  ...{a[lo:i+80]!r}\n"
                f"ours: ...{b[lo:i+80]!r}")
    raise AssertionError(f"{label}: length differs {len(a)} vs {len(b)}")


def test_clean_lowqual_golden(tmp_path):
    from dbg_assembly.clean import lowqual

    ds = golden.sim_dataset()
    fq = ds["libs"][0][0]
    ref = golden.ref_clean_lowqual(fq, err=0.01, min_len=75)

    out = str(tmp_path / "ours.nonLowQual.gz")
    stat = str(tmp_path / "ours.stat")
    lowqual.run_file(fq, out, stat, err_cutoff=0.01, min_read_len=75)

    _first_diff(golden.gunzip_bytes(ref["out"]), golden.gunzip_bytes(out),
                "nonLowQual content")
    _first_diff(golden.read_bytes(ref["stat"]), golden.read_bytes(stat),
                "nonLowQual stat")


def test_clean_adapter_golden(tmp_path):
    from dbg_assembly.clean import adapter

    ds = golden.sim_dataset()
    fq = ds["libs"][0][0]
    refq = golden.ref_clean_lowqual(fq, err=0.01, min_len=75)
    ref = golden.ref_clean_adapter(refq["out"], score=12, min_len=75)

    out = str(tmp_path / "ours.nonAdapter.gz")
    stat = str(tmp_path / "ours.stat")
    adapter.run_file(refq["out"], out, stat, adapter_file="Both-adapter",
                     score_cutoff=12, min_read_len=75)

    _first_diff(golden.gunzip_bytes(ref["out"]), golden.gunzip_bytes(out),
                "nonAdapter content")
    _first_diff(golden.read_bytes(ref["stat"]), golden.read_bytes(stat),
                "nonAdapter stat")
