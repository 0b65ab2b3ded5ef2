"""Sanity-check DISTRIBUTED.md's communication-volume model against the
COMPILED program.

The model claims the distributed ingest moves ~16 B per k-mer slot
through all_to_all (8 B key + 8 B packed payload), flat per-device in D.
This tool compiles graph_ingest_step_exact on an 8-device CPU mesh,
walks the optimized HLO for collective ops, sums their operand bytes and
compares with the model's prediction.

Run: python -u tools/verify_comm_volume.py
"""
import os
import re
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

DTYPE_BYTES = {"u64": 8, "s64": 8, "f64": 8, "u32": 4, "s32": 4, "f32": 4,
               "u16": 2, "s16": 2, "u8": 1, "s8": 1, "pred": 1}


def op_bytes(line: str):
    """(kind, output bytes) of one collective HLO op line, else None."""
    line = re.sub(r"/\*.*?\*/", "", line)
    m = re.match(r"\s*%[\w.\-]+ = (.*?) (all-to-all|all-reduce|"
                 r"all-gather|reduce-scatter|collective-permute)\(", line)
    if not m:
        return None
    total = 0
    for dt, dims in re.findall(r"([a-z0-9]+)\[([0-9,]*)\]", m.group(1)):
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return m.group(2), total


def main():
    from dbg_assembly.parallel import mesh as meshmod
    from dbg_assembly.parallel import count_sharded

    D = 8
    m = meshmod.data_mesh(D)
    ksize = 31
    N, L = 1024, 150
    P = L - ksize + 1
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (N, L)).astype(np.uint8)
    lengths = np.full(N, L, np.int32)
    cs, ls = meshmod.shard_batch(m, codes, lengths)

    cap = count_sharded.default_capacity(N, L, ksize, D)
    traced = count_sharded.graph_ingest_step.lower(
        cs, ls, 0, ksize=ksize, mesh=m, capacity=cap)
    hlo = traced.compile().as_text()

    slots = N * P
    rows = {}
    for line in hlo.splitlines():
        r = op_bytes(line)
        if r and r[1]:
            rows[r[0]] = rows.get(r[0], 0) + r[1]
    # HLO is the per-device SPMD program: multiply by D for fleet volume
    a2a = rows.get("all-to-all", 0) * D
    model = slots * 16
    print(f"k-mer slots per step: {slots}")
    for kind, b in sorted(rows.items()):
        print(f"{kind:20s} {b*D:12d} B total   ({b*D/slots:.1f} B/slot)")
    print(f"model (DISTRIBUTED.md): all-to-all ~ {model} B (16 B/slot)")
    if a2a:
        ratio = a2a / model
        print(f"compiled/model ratio: {ratio:.2f} "
              "(>1 = bucket-capacity padding)")
        assert 0.8 <= ratio <= 2.0, "model is off — update DISTRIBUTED.md"
        print("OK: compiled program matches the 16 B/slot model "
              "(excess is the static bucket-skew headroom)")


if __name__ == "__main__":
    main()
