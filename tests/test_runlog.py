"""Run-log (cerr) parity: our contig pipeline's log must byte-match the
reference binary's stderr modulo the "Run time"/"Finshed" timing values —
parameter echo, hash init, per-buffer heartbeat cadence (including the
extra empty buffer group on exact-multiple files and the end-of-file
line), per-file totals, emulated hash parameters (size/count/conflict),
link/pruning summaries and readout totals."""

import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REF_BIN = "/root/reference/DBG_contig/debruijn_contig"


def normalize(text: str) -> str:
    text = re.sub(r"(Run time: )[0-9.e+-]+", r"\1X", text)
    return text


@pytest.mark.parametrize("n_reads", [250, 200])   # 200 = exact multiple of -b
def test_contig_runlog_matches_reference(tmp_path, n_reads):
    from tools.simulate_reads import make_genome, simulate_pe
    from dbg_assembly.contig import pipeline
    from dbg_assembly.contig.refassemble import AssembleParams

    if not os.path.exists(REF_BIN):
        pytest.skip("reference binary unavailable")

    genome = make_genome(12_000, seed=41, repeat_frac=0.0)
    r1, q1, r2, q2 = simulate_pe(genome, 100, 300, 5.0, seed=42,
                                 err_start=0.002, err_end=0.002)
    r = np.concatenate([r1, r2])[:n_reads]
    fa = str(tmp_path / "reads.fa.gz")
    import gzip
    with gzip.open(fa, "wb") as f:
        for i, row in enumerate(r):
            f.write(b">r%d\n" % i + row.tobytes() + b"\n")
    lib = str(tmp_path / "reads.lib")
    with open(lib, "w") as f:
        f.write(fa + "\n")

    K = 21
    ref_prefix = str(tmp_path / "ref")
    ref_log = ref_prefix + ".contig.log"
    with open(ref_log, "wb") as lf:
        subprocess.run(
            [REF_BIN, "-f", "2", "-k", str(K), "-r", "250", "-t", "1",
             "-i", "0.001", "-b", "100", "-M", "125", "-o", ref_prefix,
             lib],
            stderr=lf, stdout=subprocess.DEVNULL, timeout=600, check=True)

    ours_prefix = str(tmp_path / "ours")
    stream = io.StringIO()
    pipeline.run(lib, ours_prefix, ksize=K, fmt=2, max_read_len=250,
                 params=AssembleParams(ksize=K, init_hash_size=0.001),
                 log_stream=stream, log_threads=1, log_buffer=100)

    with open(ref_log) as f:
        ref_text = f.read()
    # the reference echoes the -o prefix; align the one path difference
    ref_text = ref_text.replace(ref_prefix, ours_prefix)
    assert normalize(ref_text) == normalize(stream.getvalue())
