"""Profile the production counting kernel, kmer.count.count_unique_fast, on
a GPU: its step time, the device time of each operation from a jax.profiler
trace, the chop's share of it, and how the sort was lowered.

Run:  python -u tools/trace_count.py [outdir] [reads]

Defaults: 250 000 random 150 bp reads, k=31.  Prints
  * the step time, and the time of the chop (chop_canonical, sort=False)
    and of the sort compiled alone: medians of timed runs that end in
    block_until_ready;
  * the sort's lowering: the custom calls and sort instructions of the
    compiled step (a radix-sort library call shows as a custom call), and
    which fusion feeds it: the chop;
  * the device operations of three traced steps by total device time, with
    their share of the device busy time, and the chop fusion's share.
The optimized HLO and the trace stay under outdir.
"""

from __future__ import annotations

import glob
import os
import re
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

KSIZE, READ_LEN = 31, 150


def timed(fn, *args, reps: int = 10) -> float:
    """Median seconds of fn(*args) after one warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs)


def device_op_times(trace_dir: str) -> dict[str, float]:
    """Summed device nanoseconds per operation name over every device
    plane's op lines in the newest trace under trace_dir."""
    from jax._src.lib import _profile_data
    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    if not paths:
        raise SystemExit(f"no trace written under {trace_dir}")
    data = _profile_data.ProfileData.from_file(paths[-1])
    totals: dict[str, float] = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            # kernels run on the stream lines ("Stream #13(Compute,...)")
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                totals[ev.name] = totals.get(ev.name, 0.0) + ev.duration_ns
    if not totals:
        names = {p.name: [ln.name for ln in p.lines] for p in data.planes}
        raise SystemExit(f"no device op events; planes and lines: {names}")
    return totals


def sort_input_fusion(hlo: str) -> str | None:
    """Name of the fusion whose output the step's sort (a custom call or a
    sort instruction) consumes, through bitcasts and tuple element
    reads: the chop."""
    m = re.search(r"= [^\n]*? (?:custom-call|sort)\(%([\w.-]+)", hlo)
    name = m.group(1) if m else None
    while name is not None:
        d = re.search(rf"%{re.escape(name)} = [^\n]*? ([\w-]+)\(%([\w.-]+)",
                      hlo)
        if d is None or d.group(1) not in ("bitcast", "copy", "reshape",
                                           "get-tuple-element"):
            return name
        name = d.group(2)
    return None


def main(outdir: str = "trace_out", n_reads: int = 250_000):
    import jax
    import jax.numpy as jnp
    from dbg_assembly.kmer import count as kc

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU: jax's default device is "
                         f"{dev.platform}")
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, size=3_000_000, dtype=np.uint8)
    starts = rng.integers(0, len(genome) - READ_LEN, size=n_reads)
    codes = jnp.asarray(genome[starts[:, None] + np.arange(READ_LEN)])
    lengths = jnp.asarray(np.full(n_reads, READ_LEN, np.int32))
    slots = n_reads * (READ_LEN - KSIZE + 1)
    print(f"device: {dev.platform} {dev.device_kind}; {n_reads} reads x "
          f"{READ_LEN} bp, k={KSIZE}: {slots} k-mer slots")

    step = jax.jit(lambda c, ln: kc.count_unique_fast(c, ln, KSIZE))
    chop = jax.jit(lambda c, ln: kc.chop_canonical(c, ln, KSIZE,
                                                   sort=False)[0])
    flat = chop(codes, lengths)
    t_step = timed(step, codes, lengths)
    print(f"count_unique_fast step: {t_step * 1e3:.3f} ms "
          f"({slots / t_step / 1e6:.1f} M k-mer slots/s)")
    print(f"alone: chop {timed(chop, codes, lengths) * 1e3:.3f} ms, sort of "
          f"the {slots} u64 keys {timed(jax.jit(jnp.sort), flat) * 1e3:.3f}"
          " ms")

    hlo = step.lower(codes, lengths).compile().as_text()
    with open(os.path.join(outdir, "count_unique_fast.hlo.txt"), "w") as f:
        f.write(hlo)
    calls = sorted(set(re.findall(r'custom_call_target="([^"]+)"', hlo)))
    sorts = [ln.strip()[:160] for ln in hlo.splitlines()
             if re.search(r"\bsort\(", ln)]
    print(f"custom calls in the compiled step: {calls or 'none'}")
    print(f"sort instructions in the compiled step: {len(sorts)}")
    for ln in sorts:
        print(f"  {ln}")
    chop_op = sort_input_fusion(hlo)
    print(f"fusion feeding the sort (the chop): {chop_op}")

    trace_dir = os.path.join(outdir, "trace")
    with jax.profiler.trace(trace_dir):
        for _ in range(3):
            jax.block_until_ready(step(codes, lengths))
    totals = device_op_times(trace_dir)
    busy = sum(totals.values())
    print(f"3 traced steps: {busy / 3e6:.3f} ms device op time per step")
    for name, ns in sorted(totals.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ns / 3e6:9.3f} ms/step {100 * ns / busy:6.2f}%  "
              f"{name[:100]}")
    if chop_op in totals:
        print(f"chop fusion {chop_op}: {totals[chop_op] / 3e6:.3f} ms/step, "
              f"{100 * totals[chop_op] / busy:.2f}% of the step's device "
              "time")

if __name__ == "__main__":
    main(*sys.argv[1:2], *(int(a) for a in sys.argv[2:3]))
