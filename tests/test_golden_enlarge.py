"""Hash enlargement + full-table degrade goldens.

A deliberately tiny -i makes the reference grow its table x2 between
ingest buffers (enlarge_kmerset_parallel, kmerSet.cpp:132-189 — slot
order changes, hence output bytes change) and, past -e doublings, stop
ingesting further reads (DBGgraph.cpp:337-351).  Both paths must be
byte-identical: every artifact file AND the run log (timings normalized),
including the emulated count/conflict lines and the Enlarge/Alert
heartbeat interleaving.

Dataset: the shared sim dataset, k=21, two read files of 13,333 reads
(buffers of 10k; distinct-node trajectory 359k @10000 / 416k @file1-end /
586k @23333 / 641k @end):
  enlarge case: -i 0.0004 -> size 400009, cap 280006: enlargements fire
    at read 10000 (->800029) and 23333 (->1600061).
  degrade case: -i 0.0006 -e 0 -> size 600011, cap 420007: the check at
    23333 finds 586k > cap with no doublings left -> alert, remaining
    3,333 reads of file 2 ignored.
"""

import io
import os
import re
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import golden  # noqa: E402

REF_BIN = "/root/reference/DBG_contig/debruijn_contig"
K = 21
ARTIFACTS = [".contig.seq.fa", ".contig.seq.depth", ".contig.small.fa",
             ".contig.small.depth", ".contig.tip.fa", ".contig.lowedge.fa",
             ".contig.bubble.fa", ".contig.kmer.freq"]


def normalize(text: str) -> str:
    text = re.sub(r"(Run time: )[0-9.e+-]+", r"\1X", text)
    text = re.sub(r"(Finshed! Run time: )[0-9.e+-]+", r"\1X", text)
    return text


def _run_case(tmp_path, extra_flags, init_hash, max_doublings):
    from dbg_assembly.contig import pipeline
    from dbg_assembly.contig.refassemble import AssembleParams

    if not os.path.exists(REF_BIN):
        pytest.skip("reference binary unavailable")
    ds = golden.sim_dataset()
    lib = str(tmp_path / "reads.lib")
    with open(lib, "w") as f:
        f.write(ds["libs"][0][0] + "\n" + ds["libs"][0][1] + "\n")

    ref_prefix = str(tmp_path / "ref")
    with open(ref_prefix + ".log", "wb") as lf:
        subprocess.run(
            [REF_BIN, "-f", "1", "-k", str(K), "-r", "250", "-t", "1",
             "-i", str(init_hash), "-M", "125", "-o", ref_prefix]
            + extra_flags + [lib],
            stderr=lf, stdout=subprocess.DEVNULL, timeout=900, check=True)

    ours_prefix = str(tmp_path / "ours")
    stream = io.StringIO()
    pipeline.run(lib, ours_prefix, ksize=K, fmt=1, max_read_len=250,
                 params=AssembleParams(ksize=K, init_hash_size=init_hash),
                 log_stream=stream, log_threads=1,
                 log_doublings=max_doublings)

    for suffix in ARTIFACTS:
        a = golden.read_bytes(ref_prefix + suffix)
        b = golden.read_bytes(ours_prefix + suffix)
        assert a == b, f"{suffix} differs"
    ref_text = open(ref_prefix + ".log").read().replace(ref_prefix,
                                                        ours_prefix)
    assert normalize(ref_text) == normalize(stream.getvalue())


def test_enlargement_two_epochs(tmp_path):
    _run_case(tmp_path, [], init_hash=0.0004, max_doublings=10)


def test_degrade_ignores_remaining_reads(tmp_path):
    _run_case(tmp_path, ["-e", "0"], init_hash=0.0006, max_doublings=0)
