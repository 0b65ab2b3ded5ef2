"""Golden tests for map_reads + link_contig + link_supertig with simulated
long reads spanning contig gaps."""

import gzip
import os
import sys

import numpy as np

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
                f"ref:  ...{a[lo:i+150]!r}\nours: ...{b[lo:i+150]!r}")
    raise AssertionError(f"{label}: length differs {len(a)} vs {len(b)}")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Contigs (reference golden) + simulated 700bp single reads."""
    d = str(tmp_path_factory.mktemp("lc"))
    ds = golden.sim_dataset()
    cleaned = []
    for p1, p2, ins in ds["libs"]:
        for p in (p1, p2):
            lq = golden.ref_clean_lowqual(p, err=0.01, min_len=75)
            ad = golden.ref_clean_adapter(lq["out"], score=12, min_len=75)
            cleaned.append(ad["out"])
    lib = os.path.join(d, "reads.lib")
    with open(lib, "w") as f:
        f.write("".join(p + "\n" for p in cleaned))
    prefix = os.path.join(d, "asm")
    golden.ref_debruijn_contig(lib, prefix, k=31, fmt=1, max_read_len=250,
                               min_ctg=125)

    # simulate long single reads from the same genome (low error rate)
    from tools.simulate_reads import make_genome, simulate_pe, write_fq_gz
    genome = make_genome(200_000, seed=7)        # same params as sim_dataset
    r1, q1, _, _ = simulate_pe(genome, 700, 1500, 8.0, seed=99,
                               err_start=0.001, err_end=0.004)
    long_fq = os.path.join(d, "long.fq.gz")
    write_fq_gz(long_fq, "long", r1, q1, 1)
    llib = os.path.join(d, "long.lib")
    with open(llib, "w") as f:
        f.write(long_fq + "\n")
    return {"dir": d, "contig_fa": prefix + ".contig.seq.fa",
            "long_lib": llib, "long_fq": long_fq}


@pytest.fixture(scope="module")
def mapped(setup):
    s = setup
    ref_out = os.path.join(s["dir"], "ref_mr")
    golden.ref_map_reads(s["contig_fa"], s["long_lib"], ref_out,
                         min_ctg=125, min_read=250, workdir=s["dir"])
    twoctg = os.path.join(s["dir"], "twoctg.lib")
    base = os.path.basename(s["long_fq"])
    with open(twoctg, "w") as f:
        f.write(f"{ref_out}/{base}.map_reads.2ctg.gz\n")
    return {"ref_dir": ref_out, "base": base, "twoctg": twoctg}


@pytest.mark.parametrize("engine_env", [None, "DBG_JAX_MAP"])
def test_map_reads_golden(setup, mapped, tmp_path, monkeypatch, engine_env):
    from dbg_assembly.scaffold import map_reads

    monkeypatch.delenv("DBG_PY_MAP", raising=False)
    monkeypatch.delenv("DBG_JAX_MAP", raising=False)
    if engine_env:  # the device path (scaffold/index.py:_map_kernel)
        monkeypatch.setenv(engine_env, "1")
    out = str(tmp_path / "ours_mr")
    map_reads.run(setup["contig_fa"], setup["long_lib"], out, ksize=31,
                  seed_kmer_num=5, min_ctg_len=125, min_read_len=250,
                  min_identity=0.97, fmt=1)
    base = mapped["base"]
    for s in (".map_reads.2ctg.gz", ".map_reads.1ctg.gz",
              ".map_reads.2ctg.gz.reads.fa.gz"):
        _diff(golden.gunzip_bytes(f"{mapped['ref_dir']}/{base}{s}"),
              golden.gunzip_bytes(f"{out}/{base}{s}"), s)
    _diff(golden.read_bytes(f"{mapped['ref_dir']}/{base}.map_reads.stat"),
          golden.read_bytes(f"{out}/{base}.map_reads.stat"),
          ".map_reads.stat")


def test_link_contig_golden(setup, mapped, tmp_path):
    from dbg_assembly.scaffold import link_contig

    ref_prefix = os.path.join(setup["dir"], "ref_lc")
    golden.ref_link_contig(setup["contig_fa"], mapped["twoctg"], ref_prefix,
                           pair_cut=3, workdir=setup["dir"])
    ours_prefix = str(tmp_path / "ours_lc")
    link_contig.run(setup["contig_fa"], mapped["twoctg"], ours_prefix,
                    pair_num_cut=3)
    for s in (".contig_R.links.all", ".contig_R.links.uniq",
              ".contig_R.seq.fa", ".contig_R.pos.tab",
              ".contig_R.repeat.seq.fa", ".contig_R.repeat.pos.tab"):
        _diff(golden.read_bytes(ref_prefix + s),
              golden.read_bytes(ours_prefix + s), s)


def test_link_supertig_golden(setup, mapped, tmp_path):
    from dbg_assembly.scaffold import link_contig

    # link_supertig extracts gap substrings with +/-250bp flanks around the
    # alignment midpoint (link_supertig.cpp:453-458) and THROWS
    # std::out_of_range when the midpoint is too close to the read edge —
    # filter the 2ctg rows to the reference's valid domain so both
    # implementations run on identical input.
    base = mapped["base"]
    src = f"{mapped['ref_dir']}/{base}.map_reads.2ctg.gz"
    filt = os.path.join(setup["dir"], "filtered.2ctg.gz")
    with gzip.open(src, "rb") as f, gzip.open(filt, "wb") as o:
        for line in f:
            if line[:1] == b"#":
                o.write(line)
                continue
            v = [t for t in line.split() if t]
            a1_end, a2_start, rlen = int(v[3]), int(v[12]), int(v[1])
            gsz = max(a2_start - a1_end - 1, 0)
            mid = (a1_end + a2_start) // 2
            if mid - 250 - gsz // 2 >= 0 and \
                    mid - 250 - gsz // 2 + gsz + 500 <= rlen:
                o.write(line)
    import shutil
    shutil.copy(f"{src}.reads.fa.gz", filt + ".reads.fa.gz")
    twoctg = os.path.join(setup["dir"], "twoctg_filtered.lib")
    with open(twoctg, "w") as f:
        f.write(filt + "\n")
    mapped = dict(mapped, twoctg=twoctg)

    ref_prefix = os.path.join(setup["dir"], "ref_st")
    golden.ref_link_supertig(setup["contig_fa"], mapped["twoctg"],
                             ref_prefix, pair_cut=3, workdir=setup["dir"])
    ours_prefix = str(tmp_path / "ours_st")
    link_contig.run_supertig(setup["contig_fa"], mapped["twoctg"],
                             ours_prefix, pair_num_cut=3)
    for s in (".supertig.links.all", ".supertig.links.uniq",
              ".supertig.seq.fa", ".supertig.pos.tab",
              ".supertig.gap.data", ".supertig_repeat.seq.fa"):
        _diff(golden.read_bytes(ref_prefix + s),
              golden.read_bytes(ours_prefix + s), s)
