"""Device-stage throughput + fallback-rate benchmarks (correction, mapping).

Measures the device correction/mapping engines' throughput and whether the
corrector's fixed shapes (R_MAX/C_MAX/H_MAX/BEAM_W, correct/device.py) hold
on realistic PE250 error profiles:

  --mode fallback   (CPU backend, exact) — PE250 reads at the simulator's
      realistic ramped error profile, k=17 table: reports the fraction of
      reads the device engine must return to the host parity engine.
  --mode device     — device-resident throughput of (a) the closed
      5-phase correction step (stage A + static wave count + phase 5 in
      ONE jit) and (b) the seed-and-extend map kernel, both timed by
      differencing two fori-loop iteration counts.

Results are printed as JSON lines.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

KSIZE_CORRECT = 17
READ_LEN = 250


def make_pe250(n_reads: int, coverage: float = 30.0, seed: int = 7):
    """PE250 reads at ~30x coverage with the simulator's realistic ramped
    error profile (0.1% at read start -> 2% at read end, the
    simulate_reads defaults) — so the k=17 table looks like a real
    correction input (true k-mers high-freq, error k-mers low)."""
    from tools.simulate_reads import make_genome, simulate_pe
    from dbg_assembly import dna

    glen = max(int(n_reads * READ_LEN / coverage), 50_000)
    genome = make_genome(glen, seed=seed)
    r1, q1, r2, q2 = simulate_pe(genome, READ_LEN, 500, 1.1 * coverage,
                                 seed=seed + 1)
    reads = np.concatenate([r1, r2])
    assert len(reads) >= n_reads
    reads = reads[:n_reads]
    ascii_np = np.ascontiguousarray(reads)
    codes = dna.ascii_to_codes(reads)
    lengths = np.full(len(reads), READ_LEN, np.int32)
    return ascii_np, codes, lengths, genome


def build_bitmap(codes, lengths, k):
    """High-frequency 1-bit table from the read set itself (count > 1),
    RC bits set — the correction consumer's view of kmerfreq's output."""
    from dbg_assembly.kmer import count as kc
    counter = kc.KmerCounter(k)
    counter.add(codes, lengths)
    uniq, counts, total = counter.finalize()
    bm = kc.freq_bitmap(uniq, counts, k, low_freq_cutoff=1)
    return kc.expand_bitmap_rc(bm, k)


def mode_fallback(n_reads):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from dbg_assembly.correct import device as dev
    from dbg_assembly.correct.engine import CorrectParams

    ascii_np, codes, lengths, bitmap, p, _ = _setup(n_reads)
    import jax.numpy as jnp
    bmd = dev.bitmap_device(bitmap)
    fb_total = 0
    waves_seen = 0
    for off in range(0, n_reads, 8192):
        end = min(off + 8192, n_reads)
        (one, multi, deleted, tl, tr, am, fb) = dev.correct_batch_device(
            ascii_np[off:end], codes[off:end], lengths[off:end], bmd, p)
        fb_total += int(fb.sum())
    rate = fb_total / n_reads
    print(json.dumps({
        "metric": "device_correction_fallback_rate_pe250_k17",
        "reads": n_reads, "fallbacks": fb_total,
        "value": round(rate, 5)}), flush=True)


def _setup(n_reads):
    from dbg_assembly.correct.engine import CorrectParams
    t0 = time.time()
    ascii_np, codes, lengths, genome = make_pe250(n_reads)
    print(f"# reads simulated in {time.time()-t0:.0f}s", flush=True)
    t0 = time.time()
    bitmap = build_bitmap(codes, lengths, KSIZE_CORRECT)
    print(f"# k={KSIZE_CORRECT} bitmap ({bitmap.nbytes/2**30:.2f} GiB) "
          f"built in {time.time()-t0:.0f}s", flush=True)
    p = CorrectParams(ksize=KSIZE_CORRECT, max_change=2).resolved()
    return ascii_np, codes, lengths, bitmap, p, genome


def mode_device(n_reads, iters=8):
    import jax
    import jax.numpy as jnp
    import functools
    from dbg_assembly.correct import device as dev

    ascii_np, codes, lengths, bitmap, p, genome = _setup(n_reads)
    k, m, mc = p.ksize, p.high_freq_reg_len, p.max_change
    t0 = time.time()
    bmd = jax.block_until_ready(dev.bitmap_device(bitmap))
    print(f"# bitmap -> device in {time.time()-t0:.0f}s", flush=True)
    ab = jnp.asarray(ascii_np)
    cb = jnp.asarray(codes)
    lb = jnp.asarray(lengths)
    jax.block_until_ready(cb)

    # wave count for the measured batch (one dispatch)
    _, _, _, _, num_h, _ = dev._stage_a(ab, cb, lb, bmd, k=k, m=m,
                                        max_change=mc)
    waves = max(int(jnp.max(num_h)) - 1, 0)
    print(f"# waves={waves}", flush=True)

    def correct_step(a, c, l_, bmd):
        a2, one, hs1, he1, num_h, fb = dev._stage_a(a, c, l_, bmd, k=k,
                                                    m=m, max_change=mc)
        accum = one
        multi = jnp.zeros_like(one)
        fail = jnp.zeros(hs1.shape, bool)
        # waves roll as ONE fori_loop body (the unrolled form triples the
        # serialized program and overflows the remote-compile request)
        def wave(i, st):
            a2, accum, multi, fail, fb = st
            return dev._wave_step(
                a2, l_, bmd, hs1, he1, num_h, accum, multi, fail, fb,
                i.astype(jnp.int32), jnp.int32(mc), k=k)
        a2, accum, multi, fail, fb = jax.lax.fori_loop(
            0, waves, wave, (a2, accum, multi, fail, fb))
        a2, multi, deleted, tl, tr, fb = dev._phase5(
            a2, l_, bmd, hs1, he1, num_h, accum, multi, fail, fb,
            k=k, mc=mc, ft=p.further_trim, min_len=p.min_read_len)
        return (jnp.sum(one + multi + deleted + tl + tr)
                + jnp.sum(fb) + a2[0, 0].astype(jnp.int64))

    rate = _time_step(correct_step, (ab, cb, lb), iters, consts=(bmd,))
    print(json.dumps({
        "metric": "device_corrected_reads_per_sec",
        "value": round(n_reads / rate, 1), "unit": "reads/s",
        "batch": n_reads, "per_iter_s": round(rate, 4),
        "waves": waves}), flush=True)

    # ---- mapping: seed-and-extend kernel against the SOURCE genome's
    # contigs (reads actually map, so the extension work is realistic)
    from dbg_assembly.scaffold import index as six
    genome = np.asarray(genome)
    ctgs = [genome[i:i + 5000].tobytes()
            for i in range(0, max(len(genome) - 5000, 1), 5000)]
    ix = six.build(ctgs, 31)
    ixa = {kk: jax.block_until_ready(v)
           for kk, v in ix.device_arrays().items()}
    ss = jnp.asarray(np.ones(n_reads, np.int64))
    fn = functools.partial(six._map_kernel, k=31, S=5)

    def map_step(c, a, l_, ixa, ss):
        out = fn(ixa, c, a, l_, ss)
        return (jnp.sum(out[0]) + jnp.sum(out[1].astype(jnp.int64))
                + jnp.sum(out[3].astype(jnp.int64)))

    rate = _time_step(map_step, (cb, ab, lb), iters, consts=(ixa, ss))
    print(json.dumps({
        "metric": "device_mapped_reads_per_sec",
        "value": round(n_reads / rate, 1), "unit": "reads/s",
        "batch": n_reads, "per_iter_s": round(rate, 4)}), flush=True)


def _time_step(step, args, iters, consts=()):
    """fori-loop differencing; every array arg is rolled consistently on
    its leading (reads) axis per iteration so the inputs stay coherent.
    consts: extra step inputs passed through UN-rolled as jit arguments —
    closure-capturing them would embed them as program CONSTANTS and ship
    them in the remote-compile request (the 2 GiB k=17 table overflowed
    the compile endpoint's size limit that way)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(args, consts, n):
        def body(i, acc):
            rolled = tuple(jnp.roll(a, i, axis=0) for a in args)
            return acc + step(*rolled, *consts).astype(jnp.int64)
        return jax.lax.fori_loop(0, n, body, jnp.int64(0))

    t0 = time.perf_counter()
    float(np.asarray(loop(args, consts, 1)))
    print(f"# compile {time.perf_counter()-t0:.0f}s", flush=True)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        float(np.asarray(loop(args, consts, iters)))
        hi = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(np.asarray(loop(args, consts, 2)))
        lo = time.perf_counter() - t0
        best = min(best, max((hi - lo) / (iters - 2), 1e-9))
    return best


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("fallback", "device"), required=True)
    ap.add_argument("--reads", type=int, default=16384)
    args = ap.parse_args()
    if args.mode == "fallback":
        mode_fallback(args.reads)
    else:
        mode_device(args.reads)
