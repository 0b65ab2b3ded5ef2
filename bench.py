"""Benchmark: canonical k-mer counting throughput per chip (k=31).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "stages"}.

The headline times the PRODUCTION counting kernel — kmer.count.
count_unique_fast, the (unique, counts)-producing step that KmerCounter /
kmerfreq run per batch (chop + one device sort + gather-free run-length
encode).  The spectrum-only pipeline is reported as the "spectrum" stage
alongside.

"stages" adds device-resident end-to-end rates (BASELINE.json "end-to-end
reads/s to contigs"):
  spectrum    count_spectrum_fast (chop+sort+blocked-window-min stats)
  ingest      contig.graph._aggregate_batch — reads -> NodeTable rows
              (k-mers + 2x4 edge counters + first-occurrence index)
  correct     the closed 5-phase correction step (stage A + BBT waves +
              phase 5) at k=13 on PE250 reads, reads/s

Baseline = the reference's single-core C++ graph-ingest rate (k-mers/s),
measured once on this host by running the shipped debruijn_contig with -t 1
and parsing its log (kmers loaded / CPU-s at end of ingest), cached in
bench_baseline.json.  BASELINE.md's published figure is ~2.9M k-mers/CPU-s
on 10 threads; the single-core rate is the agreed denominator
(BASELINE.json: ">=50x the single-core C++ k-mer-counting throughput").
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

BASELINE_FILE = os.path.join(ROOT, "bench_baseline.json")
DATA_DIR = os.path.join(ROOT, "tests", "_golden_cache", "bench")
KSIZE = 31
READ_LEN = 150
N_READS_REF = 150_000         # subset for the single-core baseline run
BATCH = 250_000               # device batch: 37.5M k-mer slots

KSIZE_CORRECT = 17            # production correction size (2-GiB table, device-built)
N_READS_CORRECT = 8192


def ensure_data():
    os.makedirs(DATA_DIR, exist_ok=True)
    marker = os.path.join(DATA_DIR, "DONE")
    if not os.path.exists(marker):
        from tools.simulate_reads import make_genome, simulate_pe, write_fq_gz
        genome = make_genome(3_000_000, seed=42)
        r1, q1, r2, q2 = simulate_pe(genome, READ_LEN, 400, 50.0, seed=43)
        write_fq_gz(os.path.join(DATA_DIR, "bench_1.fq.gz"), "bench",
                    r1, q1, 1)
        write_fq_gz(os.path.join(DATA_DIR, "bench_2.fq.gz"), "bench",
                    r2, q2, 2)
        np.save(os.path.join(DATA_DIR, "codes.npy"),
                np.concatenate([np.searchsorted(
                    np.frombuffer(b"ACGT", np.uint8), r1),
                    np.searchsorted(np.frombuffer(b"ACGT", np.uint8), r2)])
                .astype(np.uint8))
        open(marker, "w").close()
    return DATA_DIR


def measure_baseline() -> dict:
    """Single-core reference rates: ingest (k-mers/s) and contig stage
    (nodes/s over link-calc + pruning + readout, i.e. everything after
    ingest in build_contig_sequence — the work stages.contig races)."""
    if os.path.exists(BASELINE_FILE):
        with open(BASELINE_FILE) as f:
            d = json.load(f)
        if "ref_contig_nodes_per_s" in d:
            return d
    ensure_data()
    lib = os.path.join(DATA_DIR, "ref.lib")
    fq = os.path.join(DATA_DIR, "bench_1.fq.gz")
    # subset the fastq to N_READS_REF reads
    import gzip
    sub = os.path.join(DATA_DIR, "ref_subset.fq.gz")
    if not os.path.exists(sub):
        with gzip.open(fq, "rb") as f:
            lines = []
            for i, line in enumerate(f):
                if i >= 4 * N_READS_REF:
                    break
                lines.append(line)
        with gzip.open(sub, "wb") as f:
            f.writelines(lines)
    with open(lib, "w") as f:
        f.write(sub + "\n")
    log = os.path.join(DATA_DIR, "ref_bench.log")
    with open(log, "wb") as lf:
        subprocess.run(
            ["/root/reference/DBG_contig/debruijn_contig", "-f", "1",
             "-k", str(KSIZE), "-r", "250", "-t", "1", "-i", "0.01",
             "-M", "125", "-o", os.path.join(DATA_DIR, "refbench"), lib],
            stderr=lf, stdout=subprocess.DEVNULL, timeout=3000, check=True)
    text = open(log).read()
    kmers = int(re.search(r"Total number of kmers loaded into memory: (\d+)",
                          text).group(1))
    nodes = int(re.search(r"count:\t(\d+)", text).group(1))
    # Run time lines: [0] after hash init, [1] after ingest of file 1,
    # [2..] after link calc / tips / (Finshed typo: lowedges) / bubbles /
    # readout — the LAST stamp closes build_contig_sequence
    times = [float(x) for x in re.findall(r"Run time: ([0-9.]+)", text)]
    ingest_s = times[1] - times[0]
    contig_s = times[-1] - times[1]
    rate = kmers / ingest_s
    d = {"ref_single_core_kmers_per_s": rate,
         "kmers": kmers, "ingest_s": ingest_s,
         "ref_contig_nodes_per_s": nodes / contig_s,
         "contig_nodes": nodes, "contig_s": contig_s}
    with open(BASELINE_FILE, "w") as f:
        json.dump(d, f, indent=1)
    return d


def _time_loop(body, args, iters_hi=12, iters_lo=2, repeats=3):
    """The whole timing loop inside ONE jitted lax.fori_loop, two
    iteration counts differenced to cancel dispatch latency, scalar
    materialized to sync.  Returns best per-iteration seconds and the
    per-repeat spread."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(args, n):
        def step(i, acc):
            rolled = tuple(jnp.roll(a, i, axis=0) for a in args)
            return acc + body(*rolled)
        return jax.lax.fori_loop(0, n, step, jnp.int64(0))

    float(np.asarray(loop(args, 1)))          # compile + warm
    secs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(np.asarray(loop(args, iters_hi)))
        d_hi = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(np.asarray(loop(args, iters_lo)))
        d_lo = time.perf_counter() - t0
        secs.append(max((d_hi - d_lo) / (iters_hi - iters_lo), 1e-9))
    return min(secs), secs


def measure_counting():
    """Production (unique, counts) kernel + spectrum + ingest stages, on
    input preloaded into device memory."""
    import jax.numpy as jnp
    from dbg_assembly.kmer import count as kc
    from dbg_assembly.contig import graph as cg

    ensure_data()
    codes = np.load(os.path.join(DATA_DIR, "codes.npy"))[:BATCH]
    lengths = np.full(len(codes), READ_LEN, np.int32)
    P = READ_LEN - KSIZE + 1
    cb = jnp.asarray(codes)
    lb = jnp.asarray(lengths)
    nk = BATCH * P

    def body_prod(c, l_):
        uniq_m, counts_m, n_unique, n_valid = kc.count_unique_fast(
            c, l_, KSIZE)
        return (n_unique + n_valid + counts_m[12345].astype(jnp.int64)
                + (uniq_m[123] & jnp.uint64(1)).astype(jnp.int64))

    def body_spectrum(c, l_):
        spectrum, n_unique, n_valid = kc.count_spectrum_fast(
            c, l_, KSIZE, max_freq=255)
        return spectrum[1] + n_unique + n_valid

    def body_ingest(c, l_):
        uniq, lcnt, rcnt, fidx, cnts, n_uniq, n_valid = cg._aggregate_batch(
            c, l_, KSIZE, jnp.int64(0))
        return (n_uniq + n_valid + fidx[0] + cnts[0].astype(jnp.int64)
                + lcnt[0, 0].astype(jnp.int64)
                + (uniq[0] & jnp.uint64(1)).astype(jnp.int64))

    per_prod, spread = _time_loop(body_prod, (cb, lb))
    per_spec, _ = _time_loop(body_spectrum, (cb, lb), repeats=2)
    per_ing, _ = _time_loop(body_ingest, (cb, lb), repeats=2)
    return {
        "prod_kmers_per_s": nk / per_prod,
        "prod_spread_ms": [round(s * 1e3, 1) for s in spread],
        "spectrum_kmers_per_s": nk / per_spec,
        "ingest_kmers_per_s": nk / per_ing,
    }


def measure_contig():
    """Device-resident contig stage: link/topology
    pass + directed successor build (one table search per state) +
    pointer-doubling chain resolution over the node table — the same
    programs the mesh contig stage runs, composed on one chip
    (contig.pointer_doubling.contig_stage_step).  Table built on device
    (untimed): the ingest aggregation compacted by one payload-carrying
    sort."""
    import jax
    import jax.numpy as jnp
    from dbg_assembly.contig import graph as cg
    from dbg_assembly.contig import pointer_doubling as pd

    ensure_data()
    codes = np.load(os.path.join(DATA_DIR, "codes.npy"))[:BATCH]
    lengths = np.full(len(codes), READ_LEN, np.int32)
    # size the static node-row count from the measured distinct-k-mer
    # count (the error-containing read set has ~8.3M uniques: 3M genomic
    # + error k-mers); count_unique_fast is already compiled by
    # measure_counting in this process
    from dbg_assembly.kmer import count as kc
    _, _, n_unique0, _ = kc.count_unique_fast(
        jnp.asarray(codes), jnp.asarray(lengths), KSIZE)
    S = 1 << max(22, int(np.ceil(np.log2(int(n_unique0) + 1))))

    @jax.jit
    def build_table(c, l_):
        uniq, lcnt, rcnt, fidx, cnts, n_uniq, n_valid = cg._aggregate_batch(
            c, l_, KSIZE, jnp.int64(0))
        lc = jnp.clip(lcnt, 0, 255).astype(jnp.uint64)
        rc = jnp.clip(rcnt, 0, 255).astype(jnp.uint64)
        sh = jnp.uint64(8) * jnp.arange(4, dtype=jnp.uint64)[None, :]
        pay = (jnp.sum(lc << sh, axis=1)
               | (jnp.sum(rc << sh, axis=1) << jnp.uint64(32)))
        km, pv = jax.lax.sort((uniq, pay), num_keys=1)
        km, pv = km[:S], pv[:S]
        lcn = ((pv[:, None] >> sh) & jnp.uint64(255)).astype(jnp.int32)
        rcn = ((pv[:, None] >> (sh + jnp.uint64(32)))
               & jnp.uint64(255)).astype(jnp.int32)
        return km, lcn, rcn, n_uniq

    km, lcn, rcn, n_uniq = jax.block_until_ready(
        build_table(jnp.asarray(codes), jnp.asarray(lengths)))
    nodes = int(n_uniq)
    assert nodes <= S, nodes

    def body(km, lcn, rcn):
        l_num, r_num, linear, e, dist, cyc = pd.contig_stage_step(
            km, lcn, rcn, k=KSIZE, cut=2)
        return (jnp.sum(l_num + r_num).astype(jnp.int64)
                + jnp.sum(linear).astype(jnp.int64) + e[0] + dist[0]
                + jnp.sum(cyc).astype(jnp.int64))

    # _time_loop's jnp.roll would unsort the k-mer key array (the kernel's
    # table search requires ascending keys); roll only the counter planes
    # so the body stays iteration-dependent without breaking sortedness
    @jax.jit
    def loop(km, lcn, rcn, n):
        def step(i, acc):
            return acc + body(km, jnp.roll(lcn, i, axis=0),
                              jnp.roll(rcn, i, axis=0))
        return jax.lax.fori_loop(0, n, step, jnp.int64(0))

    # time SINGLE executions including dispatch (conservative: it biases
    # the rate down)
    import time as _time
    float(np.asarray(loop(km, lcn, rcn, 1)))
    secs = []
    for _ in range(2):
        t0 = _time.perf_counter()
        float(np.asarray(loop(km, lcn, rcn, 1)))
        secs.append(_time.perf_counter() - t0)
    per_iter = min(secs)
    return {"contig_nodes_per_s": nodes / per_iter, "contig_nodes": nodes,
            "contig_note": "single-execution wall incl. dispatch"}


def measure_correction():
    """Device-resident 5-phase correction step (reads -> corrected) at the
    PRODUCTION k=17.  The 2-GiB 1-bit table is built ON DEVICE
    (count_unique_fast + bit scatter-add).  The timed
    body is the full closed step: stage A + gap waves + phase 5, with
    active-row compaction (correct/device._bbt_compact).  Host-fallback
    rate is reported alongside — flagged reads re-run on the host engine,
    preserving byte parity."""
    import time as _time
    import jax
    import jax.numpy as jnp
    from tools.bench_stages import make_pe250
    from dbg_assembly import dna
    from dbg_assembly.correct import device as dev
    from dbg_assembly.correct.engine import CorrectParams
    from dbg_assembly.kmer import count as kc

    n = N_READS_CORRECT
    k = KSIZE_CORRECT
    ascii_np, codes, lengths, _ = make_pe250(n)
    p = CorrectParams(ksize=k, max_change=2).resolved()
    m, mc = p.high_freq_reg_len, p.max_change

    @jax.jit
    def build(c, l_):
        uniq_m, counts_m, n_unique, _ = kc.count_unique_fast(c, l_, k)
        hi = jnp.where(counts_m > 1, uniq_m, kc.SENTINEL)
        rc = dna.revcomp_kbit(hi, k)
        bits = jnp.concatenate([hi, rc])
        ok = bits != kc.SENTINEL
        word = jnp.where(ok, (bits >> jnp.uint64(5)).astype(jnp.int32),
                         1 << 30)
        shift = (jnp.uint64(8) * ((bits >> jnp.uint64(3)) & jnp.uint64(3))
                 + (jnp.uint64(7) - (bits & jnp.uint64(7))))
        val = jnp.uint32(1) << shift.astype(jnp.uint32)
        table = jnp.zeros((1 << (2 * k - 5),), jnp.uint32)
        return table.at[word].add(jnp.where(ok, val, 0), mode="drop")

    cb = jnp.asarray(codes)
    lb = jnp.asarray(lengths)
    bmd = jax.block_until_ready(build(cb, lb))
    ab = jnp.asarray(ascii_np)
    _, _, _, _, num_h, _ = dev._stage_a(ab, cb, lb, bmd, k=k, m=m,
                                        max_change=mc)
    waves = max(int(jnp.max(num_h)) - 1, 0)
    wave_c = max(n // 4, 256)
    p5_c = max(n // 2, 256)

    def body(bm, a, c, l_):
        a2, one, hs1, he1, num_h, fb = dev._stage_a(a, c, l_, bm, k=k,
                                                    m=m, max_change=mc)
        accum = one
        multi = jnp.zeros_like(one)
        fail = jnp.zeros(hs1.shape, bool)

        def wave(i, st):
            a2, accum, multi, fail, fb = st
            return dev._wave_step(
                a2, l_, bm, hs1, he1, num_h, accum, multi, fail, fb,
                i.astype(jnp.int32), jnp.int32(mc), k=k, compact_c=wave_c)

        a2, accum, multi, fail, fb = jax.lax.fori_loop(
            0, waves, wave, (a2, accum, multi, fail, fb))
        a2, multi, deleted, tl, tr, fb = dev._phase5(
            a2, l_, bm, hs1, he1, num_h, accum, multi, fail, fb,
            k=k, mc=mc, ft=p.further_trim, min_len=p.min_read_len,
            compact_c=p5_c)
        return (jnp.sum(one + multi + deleted + tl + tr).astype(jnp.int64),
                jnp.sum(fb).astype(jnp.int64), a2)

    # fallback rate (one un-timed run of the same body)
    _, fb_count, _ = jax.jit(body)(bmd, ab, cb, lb)
    fallback_rate = float(fb_count) / n

    # timing: the 2-GiB table must be a loop ARGUMENT (a closed-over
    # constant bloats lowering) and must not be rolled; read arrays roll
    @jax.jit
    def loop(bm, a, c, l_, it):
        def step(i, acc):
            chk, fbs, _ = body(bm, jnp.roll(a, i, axis=0),
                               jnp.roll(c, i, axis=0), l_)
            return acc + chk + fbs
        return jax.lax.fori_loop(0, it, step, jnp.int64(0))

    float(np.asarray(loop(bmd, ab, cb, lb, 1)))
    secs = []
    for _ in range(2):
        t0 = _time.perf_counter()
        float(np.asarray(loop(bmd, ab, cb, lb, 8)))
        hi = _time.perf_counter() - t0
        t0 = _time.perf_counter()
        float(np.asarray(loop(bmd, ab, cb, lb, 2)))
        lo = _time.perf_counter() - t0
        secs.append(max((hi - lo) / 6, 1e-9))
    per_iter = min(secs)
    return {"correct_reads_per_s": n / per_iter, "waves": waves,
            "fallback_rate": round(fallback_rate, 5)}


def main():
    import jax
    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures a GPU; jax's default backend "
                         f"is {jax.default_backend()}")
    base = measure_baseline()
    baseline = base["ref_single_core_kmers_per_s"]
    counting = measure_counting()
    corr = measure_correction()
    ctg = measure_contig()
    rate = counting["prod_kmers_per_s"]
    stages = {
        "spectrum_kmers_per_s": round(counting["spectrum_kmers_per_s"], 1),
        "spectrum_vs_baseline": round(
            counting["spectrum_kmers_per_s"] / baseline, 3),
        "ingest_kmers_per_s": round(counting["ingest_kmers_per_s"], 1),
        "ingest_vs_baseline": round(
            counting["ingest_kmers_per_s"] / baseline, 3),
        "contig_nodes_per_s": round(ctg["contig_nodes_per_s"], 1),
        "contig_vs_baseline": round(
            ctg["contig_nodes_per_s"] / base["ref_contig_nodes_per_s"], 3),
        "correct_reads_per_s": round(corr["correct_reads_per_s"], 1),
        "headline_spread_ms_per_iter": counting["prod_spread_ms"],
        # the reference single-core rate is HOST-STATE dependent (this
        # virtualized host sped up ~2.4x between rounds 1 and 5 — see
        # BASELINE.md "baseline drift"); the denominator is recorded here
        # so vs_baseline is interpretable across rounds
        "baseline_ref_kmers_per_s": round(baseline, 1),
        "baseline_ref_contig_nodes_per_s": round(
            base["ref_contig_nodes_per_s"], 1),
    }
    for key in ("waves", "fallback_rate"):
        if key in corr:
            stages["correct_" + key] = corr[key]
    print(json.dumps({
        "metric": "kmers_counted_per_sec_per_chip",
        "value": round(rate, 1),
        "unit": "kmers/s",
        "vs_baseline": round(rate / baseline, 3),
        "stages": stages,
    }))


if __name__ == "__main__":
    main()
