"""Ingest-step scaling curve over a virtual device mesh (CPU proxy).

Strong scaling of the distributed graph-ingest step (all_to_all k-mer
routing + owner segment-reduce): a FIXED read batch is sharded over
n = 1, 2, 4, 8 mesh devices and the jitted step is timed per n.

This is the measurement apparatus BASELINE.md's >=80% 2-host scaling
target runs on; on this dev box the 8 virtual devices share 2 physical
cores, so the CPU curve saturates at the core count — the per-device
partition sizes and collective pattern are identical to a real multi-chip
run (the dryrun + tests/test_multihost.py validate those paths).

Run:  python tools/measure_scaling.py [batch=65536]
Appends the measured table to DISTRIBUTED.md.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main(batch=65536):
    from dbg_assembly.parallel import count_sharded, mesh as meshmod

    K = 21
    L = 150
    P = L - K + 1
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, size=1_000_000, dtype=np.uint8)
    starts = rng.integers(0, len(genome) - L, size=batch)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    lengths = np.full(batch, L, np.int32)
    n_kmers = batch * P
    print(f"batch={batch} n_kmers={n_kmers} host_cpus="
          f"{os.cpu_count()}", flush=True)

    rows = []
    for n in (1, 2, 4, 8):
        m = meshmod.data_mesh(n)
        cs, ls = meshmod.shard_batch(m, codes, lengths)
        cap = count_sharded.default_capacity(batch, L, K, n)
        t0 = time.perf_counter()
        out = count_sharded.graph_ingest_step(cs, ls, 0, ksize=K, mesh=m,
                                              capacity=cap)
        jax.block_until_ready(out[:5])
        compile_s = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = count_sharded.graph_ingest_step(cs, ls, 0, ksize=K,
                                                  mesh=m, capacity=cap)
            jax.block_until_ready(out[:5])
            best = min(best, time.perf_counter() - t0)
        rate = n_kmers / best
        rows.append((n, best, rate, compile_s))
        print(f"n={n}  {best*1e3:8.1f} ms  {rate/1e6:8.2f} M kmers/s  "
              f"(compile {compile_s:.1f}s)", flush=True)

    base = rows[0][2]
    with open(os.path.join(ROOT, "DISTRIBUTED.md"), "a") as f:
        f.write("\n## Measured ingest-step scaling (CPU virtual mesh, "
                "tools/measure_scaling.py)\n\n")
        f.write(f"Fixed batch {batch} reads x {L} bp (k={K}, "
                f"{n_kmers/1e6:.1f}M k-mers), strong scaling; 8 virtual "
                f"devices share {os.cpu_count()} physical cores, so the "
                "CPU proxy saturates at the core count.\n\n")
        f.write("| devices | step wall | M k-mers/s | speedup | "
                "efficiency |\n|---|---|---|---|---|\n")
        for n, wall, rate, _ in rows:
            f.write(f"| {n} | {wall*1e3:.1f} ms | {rate/1e6:.2f} | "
                    f"{rate/base:.2f}x | {rate/base/n*100:.0f}% |\n")
    eff2 = rows[1][2] / base / 2 * 100
    print(f"2-device scaling efficiency: {eff2:.0f}%", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 65536)
