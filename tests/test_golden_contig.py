"""Golden test: full debruijn_contig artifact set vs the reference binary."""

import os
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
                f"ref:  ...{a[lo:i+120]!r}\n"
                f"ours: ...{b[lo:i+120]!r}")
    raise AssertionError(f"{label}: length differs {len(a)} vs {len(b)}")


@pytest.fixture(scope="module")
def cleaned_libs():
    ds = golden.sim_dataset()
    files = []
    for p1, p2, ins in ds["libs"]:
        for p in (p1, p2):
            lq = golden.ref_clean_lowqual(p, err=0.01, min_len=75)
            ad = golden.ref_clean_adapter(lq["out"], score=12, min_len=75)
            files.append(ad["out"])
    return files


@pytest.fixture(scope="module")
def ref_contigs(cleaned_libs, tmp_path_factory):
    d = tmp_path_factory.mktemp("refctg")
    lib = d / "reads.lib"
    lib.write_text("".join(p + "\n" for p in cleaned_libs))
    prefix = str(d / "ref")
    out = golden.ref_debruijn_contig(str(lib), prefix, k=31, fmt=1,
                                     max_read_len=250, min_ctg=125)
    return out, str(lib)


def test_contig_golden(ref_contigs, tmp_path):
    from dbg_assembly.contig import pipeline
    from dbg_assembly.contig.refassemble import AssembleParams

    ref_paths, lib = ref_contigs
    prefix = str(tmp_path / "ours")
    params = AssembleParams(ksize=31, init_hash_size=0.01)
    pipeline.run(lib, prefix, ksize=31, fmt=1, max_read_len=250,
                 params=params)

    for suffix in (".contig.kmer.freq", ".contig.tip.fa",
                   ".contig.lowedge.fa", ".contig.bubble.fa",
                   ".contig.seq.fa", ".contig.seq.depth",
                   ".contig.small.fa", ".contig.small.depth"):
        _diff(golden.read_bytes(ref_paths[suffix]),
              golden.read_bytes(prefix + suffix), suffix)
