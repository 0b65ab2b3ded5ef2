"""Golden test of the 8-bit-table correct_error driver variant."""

import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

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
                f"ref:  ...{a[lo:i+150]!r}\nours: ...{b[lo:i+150]!r}")
    raise AssertionError(f"{label}: length differs {len(a)} vs {len(b)}")


def test_correct_8bit_golden(tmp_path):
    from dbg_assembly.kmer import kmerfreq
    from dbg_assembly.correct import pipeline

    ds = golden.sim_dataset()
    cleaned = []
    for p1, p2, ins in ds["libs"][:1]:
        for p in (p1, p2):
            lq = golden.ref_clean_lowqual(p, err=0.01, min_len=75)
            ad = golden.ref_clean_adapter(lq["out"], score=12, min_len=75)
            local = os.path.join(str(tmp_path), os.path.basename(ad["out"]))
            shutil.copy(ad["out"], local)
            cleaned.append(local)
    lib = os.path.join(str(tmp_path), "clean.lib")
    with open(lib, "w") as f:
        f.write("".join(p + "\n" for p in cleaned))

    kf = kmerfreq.run(lib, ksize=13, table_format="8bit")

    golden.run([f"{golden.REF}/correct_error/correct_error", "-k", "13",
                "-l", "2", "-c", "2", "-j", "0", kf["cz"], lib],
               cwd=str(tmp_path), timeout=600)
    for p in cleaned:
        shutil.move(p + ".cor", p + ".cor.ref")
        shutil.move(p + ".cor.stat", p + ".cor.stat.ref")

    pipeline.run_8bit(kf["cz"], lib, ksize=13, low_freq_cutoff=2,
                      max_change=2, fmt=1, join=False)
    for p in cleaned:
        _diff(golden.gunzip_bytes(p + ".cor.ref"),
              golden.gunzip_bytes(p + ".cor"), os.path.basename(p) + " cor")
        _diff(golden.read_bytes(p + ".cor.stat.ref"),
              golden.read_bytes(p + ".cor.stat"),
              os.path.basename(p) + " stat")
