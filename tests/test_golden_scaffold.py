"""Golden tests: map_pair and link_scaffold vs the reference binaries."""

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
                f"ref:  ...{a[lo:i+150]!r}\n"
                f"ours: ...{b[lo:i+150]!r}")
    raise AssertionError(f"{label}: length differs {len(a)} vs {len(b)}")


@pytest.fixture(scope="module")
def contig_and_reads(tmp_path_factory):
    """Reference contigs (from the golden contig run) + raw read lib."""
    d = tmp_path_factory.mktemp("scaf")
    ds = golden.sim_dataset()
    cleaned = []
    for p1, p2, ins in ds["libs"]:
        for p in (p1, p2):
            lq = golden.ref_clean_lowqual(p, err=0.01, min_len=75)
            ad = golden.ref_clean_adapter(lq["out"], score=12, min_len=75)
            cleaned.append(ad["out"])
    lib = d / "reads.lib"
    lib.write_text("".join(p + "\n" for p in cleaned))
    prefix = str(d / "asm")
    golden.ref_debruijn_contig(str(lib), prefix, k=31, fmt=1,
                               max_read_len=250, min_ctg=125)
    # pair lib: the insert-400 library only, raw cleaned pairs
    pairlib = d / "pair400.lib"
    pairlib.write_text(cleaned[0] + "\n" + cleaned[1] + "\n")
    return {"contig_fa": prefix + ".contig.seq.fa", "pairlib": str(pairlib),
            "dir": str(d), "cleaned": cleaned}


@pytest.fixture(scope="module")
def ref_mapped(contig_and_reads):
    cr = contig_and_reads
    outdir = os.path.join(cr["dir"], "ref_map")
    golden.ref_map_pair(cr["contig_fa"], cr["pairlib"], outdir,
                        min_ctg=125, min_read=100, workdir=cr["dir"])
    base = os.path.basename(cr["cleaned"][0])
    # the reference-written .2ctg.lib concatenates outdir with the full input
    # path (map_pair.cpp:89-95), which breaks for absolute paths; write a
    # working lib pointing at the actual outputs
    twoctg = os.path.join(cr["dir"], "twoctg.lib")
    with open(twoctg, "w") as f:
        f.write(f"{outdir}/{base}.map_pair.2ctg.gz\n")
    return {"dir": outdir, "base": base, "twoctg_lib": twoctg}


@pytest.mark.parametrize("engine_env", [None, "DBG_JAX_MAP"])
def test_map_pair_golden(contig_and_reads, ref_mapped, tmp_path, monkeypatch,
                         engine_env):
    from dbg_assembly.scaffold import map_pair

    monkeypatch.delenv("DBG_PY_MAP", raising=False)
    monkeypatch.delenv("DBG_JAX_MAP", raising=False)
    if engine_env:  # the device path (scaffold/index.py:_map_kernel)
        monkeypatch.setenv(engine_env, "1")
    cr = contig_and_reads
    outdir = str(tmp_path / "ours_map")
    map_pair.run(cr["contig_fa"], cr["pairlib"], outdir, ksize=31,
                 seed_kmer_num=5, min_ctg_len=125, min_read_len=100,
                 min_identity=0.97, fmt=1)
    base = ref_mapped["base"]
    for suffix in (".map_pair.2ctg.gz", ".map_pair.1ctg.gz",
                   ".map_pair.gap.gz"):
        _diff(golden.gunzip_bytes(f"{ref_mapped['dir']}/{base}{suffix}"),
              golden.gunzip_bytes(f"{outdir}/{base}{suffix}"), suffix)
    _diff(golden.read_bytes(f"{ref_mapped['dir']}/{base}.map_pair.stat"),
          golden.read_bytes(f"{outdir}/{base}.map_pair.stat"),
          ".map_pair.stat")


def test_link_scaffold_golden(contig_and_reads, ref_mapped, tmp_path):
    from dbg_assembly.scaffold import scaffold

    cr = contig_and_reads
    # reference link_scaffold consumes the 2ctg lib written by ref map_pair
    ref_prefix = os.path.join(cr["dir"], "refscaf")
    golden.ref_link_scaffold(cr["contig_fa"], ref_mapped["twoctg_lib"],
                             ref_prefix, insert=400, pair_cut=3,
                             workdir=cr["dir"])
    ours_prefix = str(tmp_path / "ourscaf")
    scaffold.run(cr["contig_fa"], ref_mapped["twoctg_lib"], ours_prefix,
                 insert_size=400, pair_num_cut=3, is_mate=False)
    for suffix in (".insert400.scaffold.links.all",
                   ".insert400.scaffold.links.uniq",
                   ".insert400.scaffold.seq.fa",
                   ".insert400.scaffold.pos.tab",
                   ".insert400.scaffold_repeat.seq.fa",
                   ".insert400.scaffold_repeat.pos.tab"):
        _diff(golden.read_bytes(ref_prefix + suffix),
              golden.read_bytes(ours_prefix + suffix), suffix)
