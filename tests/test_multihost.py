"""Two-PROCESS distributed ingest (jax.distributed + Gloo CPU collectives).

Launches two real processes of tools/launch_distributed.py, each a
separate jax.distributed participant with 2 local virtual CPU devices
(4-device global mesh), feeding disjoint .lib slices; the union of their
owner-shard tables must equal the single-process GraphBuilder's node
table (k-mer keys and all eight edge counters)."""

import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_distributed_ingest(tmp_path):
    from tools.simulate_reads import make_genome, simulate_pe, write_fq_gz
    from dbg_assembly import dna
    from dbg_assembly.contig.graph import GraphBuilder

    K = 17
    genome = make_genome(20_000, seed=31, repeat_frac=0.0)
    r1, q1, r2, q2 = simulate_pe(genome, 100, 300, 6.0, seed=32,
                                 err_start=0.0, err_end=0.0)
    f1 = str(tmp_path / "reads_1.fq.gz")
    f2 = str(tmp_path / "reads_2.fq.gz")
    write_fq_gz(f1, "mh", r1, q1, 1)
    write_fq_gz(f2, "mh", r2, q2, 2)
    lib = str(tmp_path / "reads.lib")
    with open(lib, "w") as f:
        f.write(f1 + "\n" + f2 + "\n")

    # single-process truth
    gb = GraphBuilder(K, max_read_len=100)
    for r in (r1, r2):
        codes = dna.ascii_to_codes(r)
        gb.add(codes, np.full(len(codes), 100, np.int32))
    table = gb.finalize()

    # two real distributed processes
    out = str(tmp_path / "dist")
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tools",
                                          "launch_distributed.py"),
             "--coordinator", "localhost:29517",
             "--num-processes", "2", "--process-id", str(pid),
             "--lib", lib, "-k", str(K), "--max-read-len", "100",
             "--cpu-devices", "2", "--out", out],
            cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
        logs.append(stdout)
        assert p.returncode == 0, stdout[-3000:]

    with open(out + ".dist.json") as f:
        meta = json.load(f)
    assert meta["n_devices"] == 4
    assert meta["total_kmers"] == table.total_kmers

    got = {}
    for pid in range(2):
        z = np.load(f"{out}.p{pid}.npz")
        for i in range(len(z["kmers"])):
            km = int(z["kmers"][i])
            assert km not in got, "owner shards must be disjoint"
            got[km] = (tuple(z["lcnt"][i]), tuple(z["rcnt"][i]))
    want = {int(table.kmers[i]): (tuple(table.lcnt[i]),
                                  tuple(table.rcnt[i]))
            for i in range(table.n_nodes)}
    assert got == want
