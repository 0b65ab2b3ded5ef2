"""Multi-host distributed ingest launcher (jax.distributed).

The reference scales with pthreads in one box (DBGgraph.cpp:148-150); this
is the multi-HOST equivalent: one process per host, each host feeds its
own slice of the .lib file list (per-host input pipeline, SURVEY.md P1),
devices across all hosts form one global 'd' mesh, and every batch runs
the sharded ingest step (all_to_all k-mer routing + owner segment-reduce,
parallel/count_sharded.graph_ingest_step_exact) with psum'd global stats.

Run ON EACH HOST (process 0 is the coordinator):

  python tools/launch_distributed.py \
      --coordinator host0:29500 --num-processes 2 --process-id <i> \
      --lib reads.lib -k 21 [--cpu-devices N] [--local-device-ids 0,1]

On CPU backends cross-process collectives ride Gloo; on GPUs, NCCL.
--cpu-devices forces a CPU backend with N local virtual devices (testing;
see tests/test_multihost.py which launches two of these processes and
checks the merged table).  Several processes on ONE host must not share
its cards: give each its own --local-device-ids (e.g. process i of 4 on a
4-GPU host: --local-device-ids i); by default a process takes every card
it sees.

Each process prints its local view; process 0 additionally writes
<prefix>.dist.json with global totals so the result can be checked
against a single-process run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True,
                    help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--lib", required=True,
                    help=".lib list of read files; every process takes "
                    "lines where line_index %% num_processes == process_id")
    ap.add_argument("-k", type=int, default=21)
    ap.add_argument("-f", type=int, default=1, help="1=fastq 2=fasta")
    ap.add_argument("--max-read-len", type=int, default=250)
    ap.add_argument("--batch-reads", type=int, default=100_000)
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="force CPU backend with this many local devices")
    ap.add_argument("--local-device-ids", default=None,
                    help="comma-separated local device ids this process "
                    "owns (default: all it sees)")
    ap.add_argument("--out", default="dist")
    a = ap.parse_args(argv)

    import jax
    if a.cpu_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={a.cpu_devices}")
        jax.config.update("jax_platforms", "cpu")
    local_ids = (None if a.local_device_ids is None
                 else [int(i) for i in a.local_device_ids.split(",")])
    jax.distributed.initialize(a.coordinator,
                               num_processes=a.num_processes,
                               process_id=a.process_id,
                               local_device_ids=local_ids)

    import numpy as np
    import jax.numpy as jnp  # noqa: F401
    from jax.sharding import Mesh, PartitionSpec as P, NamedSharding
    from dbg_assembly.io import fastq
    from dbg_assembly.parallel import count_sharded
    from dbg_assembly.contig.graph import _merge_parts, NodeTable

    pid = a.process_id
    devs = jax.devices()
    local = jax.local_devices()
    n_dev = len(devs)
    print(f"[p{pid}] {len(local)} local / {n_dev} global devices",
          flush=True)
    mesh = Mesh(np.array(devs), axis_names=("d",))
    spec2 = NamedSharding(mesh, P("d", None))
    spec1 = NamedSharding(mesh, P("d"))

    with open(a.lib) as f:
        files = [ln.strip() for ln in f if ln.strip()]
    my_files = [p for i, p in enumerate(files)
                if i % a.num_processes == pid]
    print(f"[p{pid}] feeding {len(my_files)}/{len(files)} files",
          flush=True)

    k = a.k
    L = a.max_read_len
    rows_local = a.batch_reads            # per-PROCESS rows per step
    parts = []
    total_kmers = 0
    total_reads = 0
    stream_pos = pid * 10 ** 12           # disjoint per-host position space

    def run_step(cb, lb):
        nonlocal total_kmers, stream_pos
        # every process contributes an equal-size local block; the global
        # batch is the concatenation in process order
        g_codes = jax.make_array_from_process_local_data(spec2, cb)
        g_lens = jax.make_array_from_process_local_data(spec1, lb)
        uniq, lcnt, rcnt, fidx, cnts, n_unique, stats = \
            count_sharded.graph_ingest_step_exact(
                g_codes, g_lens, stream_pos, ksize=k, mesh=mesh)
        # every process keeps ONLY its addressable owner shards
        for sh_u, sh_l, sh_r, sh_f, sh_c, sh_n in zip(
                uniq.addressable_shards, lcnt.addressable_shards,
                rcnt.addressable_shards, fidx.addressable_shards,
                cnts.addressable_shards, n_unique.addressable_shards):
            un = np.asarray(sh_u.data)[0]
            nc = int(np.asarray(sh_n.data)[0])
            # per-shard records are masked at sorted positions (round-4
            # gather-free merge); compact by boolean mask
            keep = un != np.uint64(0xFFFFFFFFFFFFFFFF)
            assert keep.sum() == nc, (keep.sum(), nc)
            if nc:
                parts.append((un[keep], np.asarray(sh_l.data)[0][keep],
                              np.asarray(sh_r.data)[0][keep],
                              np.asarray(sh_f.data)[0][keep],
                              np.asarray(sh_c.data)[0][keep]))
        total_kmers += int(stats["total_kmers"]) \
            if pid == 0 else int(stats["total_kmers"])
        stream_pos += cb.shape[0] * a.num_processes * (L - k + 1)

    pend_c = np.zeros((0, L), np.uint8)
    pend_l = np.zeros((0,), np.int32)
    for path in my_files:
        batch = fastq.read_batch(path, fmt="fq" if a.f == 1 else "fa",
                                 strict_n=False, keep_heads=False)
        codes = np.zeros((batch.n_reads, L), np.uint8)
        w = min(L, batch.codes.shape[1])
        codes[:, :w] = batch.codes[:, :w]
        lens = np.minimum(batch.lengths, L).astype(np.int32)
        keep = lens >= k
        total_reads += int(keep.sum())
        pend_c = np.concatenate([pend_c, codes[keep]])
        pend_l = np.concatenate([pend_l, lens[keep]])
        while len(pend_c) >= rows_local:
            run_step(pend_c[:rows_local], pend_l[:rows_local])
            pend_c = pend_c[rows_local:]
            pend_l = pend_l[rows_local:]
    # trailing partial batch: pad to the fixed local block size (all
    # processes run the same number of steps — a .lib is split evenly in
    # practice; here every process pads its own tail)
    tail = np.zeros((rows_local, L), np.uint8)
    tail_l = np.zeros((rows_local,), np.int32)
    tail[:len(pend_c)] = pend_c
    tail_l[:len(pend_l)] = pend_l
    run_step(tail, tail_l)

    merged = _merge_parts(parts)[0] if parts else None
    if merged is not None:
        u_, l_, r_, f_, c_ = merged
        table = NodeTable(u_, l_, r_, f_, total_kmers, total_reads,
                          counts=c_)
        print(f"[p{pid}] local owner shards: {table.n_nodes} nodes",
              flush=True)
        np.savez(f"{a.out}.p{pid}.npz", kmers=table.kmers,
                 lcnt=table.lcnt, rcnt=table.rcnt,
                 first_idx=table.first_idx)
    if pid == 0:
        with open(a.out + ".dist.json", "w") as f:
            json.dump({"num_processes": a.num_processes,
                       "n_devices": n_dev,
                       "total_kmers": total_kmers}, f)
        print(f"[p0] wrote {a.out}.dist.json total_kmers={total_kmers}",
              flush=True)


if __name__ == "__main__":
    main()
