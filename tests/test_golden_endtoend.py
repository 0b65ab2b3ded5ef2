"""End-to-end golden workflow: clean -> kmerfreq -> correct -> contig ->
map_pair -> scaffold (insert 400) -> map_pair -> scaffold (insert 800),
running our framework and the reference binaries side by side from the same
raw reads, comparing the final artifacts byte-for-byte at every stage
boundary (the file-stage design makes each boundary a checkpoint —
SURVEY.md section 5)."""

import gzip
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402
import golden  # noqa: E402

K_CORR = 13       # correction k (13 keeps the dense table small in CI)
K_CTG = 31


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


def test_end_to_end(tmp_path):
    from dbg_assembly.clean import lowqual, adapter
    from dbg_assembly.kmer import kmerfreq
    from dbg_assembly.correct import pipeline as corr
    from dbg_assembly.correct.engine import CorrectParams
    from dbg_assembly.contig import pipeline as ctg
    from dbg_assembly.contig.refassemble import AssembleParams
    from dbg_assembly.scaffold import map_pair, scaffold

    ds = golden.sim_dataset()
    ours_d = tmp_path / "ours"
    ref_d = tmp_path / "ref"
    ours_d.mkdir()
    ref_d.mkdir()

    # ---- stage 1: cleaning (ours; verified byte-exact elsewhere) ----
    ours_clean = []
    ref_clean = []
    for p1, p2, ins in ds["libs"]:
        for p in (p1, p2):
            b = os.path.basename(p)
            o_lq = str(ours_d / (b + ".nonLowQual.gz"))
            lowqual.run_file(p, o_lq, o_lq[:-3] + ".stat",
                             err_cutoff=0.01, min_read_len=75)
            o_ad = str(ours_d / (b + ".nonAdapter.gz"))
            adapter.run_file(o_lq, o_ad, o_ad[:-3] + ".stat",
                             adapter_file="Both-adapter", score_cutoff=12,
                             min_read_len=75)
            ours_clean.append(o_ad)
            # reference chain (cached)
            r_lq = golden.ref_clean_lowqual(p, err=0.01, min_len=75)
            r_ad = golden.ref_clean_adapter(r_lq["out"], score=12,
                                            min_len=75)
            local = str(ref_d / os.path.basename(r_ad["out"]))
            shutil.copy(r_ad["out"], local)
            ref_clean.append(local)

    for o, r in zip(ours_clean, ref_clean):
        _diff(golden.gunzip_bytes(r), golden.gunzip_bytes(o),
              "clean " + os.path.basename(o))

    # ---- stage 2+3: kmer table + correction ----
    ours_lib = str(ours_d / "clean.lib")
    with open(ours_lib, "w") as f:
        f.write("".join(p + "\n" for p in ours_clean))
    kf = kmerfreq.run(ours_lib, ksize=K_CORR, low_freq_cutoff=1)
    corr.run(kf["cz"], ours_lib, CorrectParams(ksize=K_CORR, max_change=2),
             fmt=1)

    ref_lib = str(ref_d / "clean.lib")
    with open(ref_lib, "w") as f:
        f.write("".join(p + "\n" for p in ref_clean))
    golden.ref_correct(kf["cz"], ref_lib, k=K_CORR, c=2, workdir=str(ref_d))

    for o, r in zip(ours_clean, ref_clean):
        _diff(golden.gunzip_bytes(r + ".correct.fa.gz"),
              golden.gunzip_bytes(o + ".correct.fa.gz"),
              "correct " + os.path.basename(o))

    # ---- stage 4: contigs ----
    ours_corr_lib = str(ours_d / "corr.lib")
    with open(ours_corr_lib, "w") as f:
        f.write("".join(p + ".correct.fa.gz\n" for p in ours_clean))
    ours_prefix = str(ours_d / "asm")
    ctg.run(ours_corr_lib, ours_prefix, ksize=K_CTG, fmt=2,
            max_read_len=250,
            params=AssembleParams(ksize=K_CTG, init_hash_size=0.01))

    ref_corr_lib = str(ref_d / "corr.lib")
    with open(ref_corr_lib, "w") as f:
        f.write("".join(p + ".correct.fa.gz\n" for p in ref_clean))
    ref_prefix = str(ref_d / "asm")
    golden.ref_debruijn_contig(ref_corr_lib, ref_prefix, k=K_CTG, fmt=2,
                               max_read_len=250, min_ctg=125)

    for s in (".contig.seq.fa", ".contig.seq.depth", ".contig.small.fa",
              ".contig.tip.fa", ".contig.bubble.fa", ".contig.lowedge.fa"):
        _diff(golden.read_bytes(ref_prefix + s),
              golden.read_bytes(ours_prefix + s), "contig " + s)

    # ---- stage 5: two scaffolding rounds, shortest insert first ----
    ctg_fa_ours = ours_prefix + ".contig.seq.fa"
    ctg_fa_ref = ref_prefix + ".contig.seq.fa"
    for rnd, insert in enumerate((400, 800)):
        pair_lib_o = str(ours_d / f"pair{insert}.lib")
        i0 = 0 if insert == 400 else 2
        with open(pair_lib_o, "w") as f:
            f.write(ours_clean[i0] + "\n" + ours_clean[i0 + 1] + "\n")
        map_o = str(ours_d / f"map{insert}")
        map_pair.run(ctg_fa_ours, pair_lib_o, map_o, ksize=31,
                     seed_kmer_num=5, min_ctg_len=125, min_read_len=100,
                     min_identity=0.97, fmt=1)
        two_o = str(ours_d / f"two{insert}.lib")
        with open(two_o, "w") as f:
            f.write(f"{map_o}/{os.path.basename(ours_clean[i0])}"
                    ".map_pair.2ctg.gz\n")
        scaffold.run(ctg_fa_ours, two_o, ctg_fa_ours, insert_size=insert,
                     pair_num_cut=3, is_mate=False)

        pair_lib_r = str(ref_d / f"pair{insert}.lib")
        with open(pair_lib_r, "w") as f:
            f.write(ref_clean[i0] + "\n" + ref_clean[i0 + 1] + "\n")
        map_r = str(ref_d / f"map{insert}")
        golden.ref_map_pair(ctg_fa_ref, pair_lib_r, map_r, min_ctg=125,
                            min_read=100, workdir=str(ref_d))
        two_r = str(ref_d / f"two{insert}.lib")
        with open(two_r, "w") as f:
            f.write(f"{map_r}/{os.path.basename(ref_clean[i0])}"
                    ".map_pair.2ctg.gz\n")
        golden.ref_link_scaffold(ctg_fa_ref, two_r, ctg_fa_ref,
                                 insert=insert, pair_cut=3,
                                 workdir=str(ref_d))

        for s in (f".insert{insert}.scaffold.seq.fa",
                  f".insert{insert}.scaffold.pos.tab",
                  f".insert{insert}.scaffold.links.uniq",
                  f".insert{insert}.scaffold_repeat.seq.fa"):
            _diff(golden.read_bytes(ctg_fa_ref + s),
                  golden.read_bytes(ctg_fa_ours + s),
                  f"scaffold round {rnd} {s}")
        ctg_fa_ours = ctg_fa_ours + f".insert{insert}.scaffold.seq.fa"
        ctg_fa_ref = ctg_fa_ref + f".insert{insert}.scaffold.seq.fa"
