"""GPU bring-up check: the assembly workflow on the card, byte-compared with
the CPU engines.

    python chip_smoke.py             # one GPU: the full `pipeline` command
    python chip_smoke.py --mesh 4    # four GPUs: `pipeline --mesh 4`

The data is the reference workflow's own shape at E. coli scale (SURVEY.md
section 4, tools/run_ecoli_scale.py): a 4.6 Mb genome simulated from fixed
seeds, PE250 reads in two libraries at 20x each with inserts of 400 and 800,
k=17 correction, k=31 contigs and two scaffolding rounds.

The same `pipeline` command runs twice: on the GPU in this process, where
the device engines run, and then in a subprocess pinned to the CPU
(`--platform cpu`), where the native host engines make the reference
artifacts.  The subprocess never opens the card.  Every artifact of every
stage is then compared byte for byte (.gz files on their decompressed
bytes); any difference, missing file or failed phase exits non-zero.  The
last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

With --mesh N the device run is `pipeline --mesh N`: the sharded corrector,
the mesh contig stage and sharded mapping over N cards.  Its reference is
`pipeline --readout doubling` on the CPU, run concurrently: the native
corrector and mapper, and the doubling contig stage, which the mesh stage
matches by design.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

GENOME_LEN = 4_600_000
GENOME_SEED = 11
READ_LEN = 250
DEPTH = 20.0
INSERTS = (400, 800)
CORRECT_K = 17
CONTIG_K = 31
# files whose text names the run's own work directory
PATH_BEARING = (".lib", ".para")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit` reports it."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip()


def device_check(n_devices: int) -> dict:
    """Phase 1: a GPU backend with n_devices cards, and every device stage
    choosing its device engine.  Raises SystemExit otherwise."""
    flags = sorted(k for k in os.environ
                   if k.startswith(("DBG_PY_", "DBG_JAX_")))
    if flags:
        raise SystemExit(f"engine override variables set: {flags}")
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"no GPU: jax default backend is {backend!r}")
    devices = jax.devices()
    if len(devices) < n_devices:
        raise SystemExit(f"need {n_devices} GPUs, jax sees {len(devices)}")
    from dbg_assembly.correct import pipeline as corr
    from dbg_assembly.kmer.count import KmerCounter
    from dbg_assembly.scaffold import index
    engines = {"correct": corr._engine(), "map_pair": index._engine(),
               "kmerfreq": ("native" if KmerCounter(CORRECT_K)._use_native()
                            else "jax")}
    log(f"engines: {json.dumps(engines)}")
    if any(e != "jax" for e in engines.values()):
        raise SystemExit(f"a device stage did not take its jax engine: "
                         f"{engines}")
    log(f"card: {card_line()}")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": n_devices}


def make_data(work: str) -> list[tuple[str, str, int]]:
    """Phase 2: the native library built from the committed sources (once,
    before two processes could race to build it), and the E. coli-shaped
    read set from fixed seeds (the same draws as tools/run_ecoli_scale.py).
    """
    from dbg_assembly import native
    from tools.simulate_reads import make_genome, simulate_pe, write_fq_gz
    t0 = time.perf_counter()
    native.lib()
    log(f"native library ready: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    genome = make_genome(GENOME_LEN, seed=GENOME_SEED)
    libs = []
    for ins in INSERTS:
        r1, q1, r2, q2 = simulate_pe(genome, READ_LEN, ins, DEPTH,
                                     seed=100 + ins)
        p1 = os.path.join(work, f"ecoli_ins{ins}_1.fq.gz")
        p2 = os.path.join(work, f"ecoli_ins{ins}_2.fq.gz")
        write_fq_gz(p1, f"read_{ins}", r1, q1, 1)
        write_fq_gz(p2, f"read_{ins}", r2, q2, 2)
        libs.append((p1, p2, ins))
    log(f"data: {GENOME_LEN} bp genome, {len(libs)} PE{READ_LEN} libraries "
        f"at {DEPTH:g}x, {time.perf_counter() - t0:.1f} s")
    return libs


def cpu_env() -> dict:
    """Environment of the CPU reference process: no engine overrides, and
    no visible card, so it can never take the GPU's memory."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DBG_PY_", "DBG_JAX_"))}
    env.update(JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    return env


def run_cli_cpu(commands: list[list[str]], logpath: str) -> None:
    """Run CLI commands one after another in CPU-pinned subprocesses."""
    with open(logpath, "w") as lf:
        for argv in commands:
            subprocess.run([sys.executable, "-m", "dbg_assembly",
                            "--platform", "cpu", *argv], cwd=ROOT,
                           env=cpu_env(), stdout=lf, stderr=lf, check=True)


def run_cli_here(argv: list[str]) -> str:
    """Run one CLI command in this process; returns what it printed."""
    import contextlib
    import io
    from dbg_assembly import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"{argv[0]} exited {rc}")
    return buf.getvalue()


def pipeline_argv(work: str, libs, extra=()) -> list[str]:
    return (["pipeline", "-k", str(CORRECT_K), "-K", str(CONTIG_K),
             "-w", work, *extra] + [f"{a},{b},{ins}" for a, b, ins in libs])


def run_check(base: str, mesh: int) -> None:
    """Phases 2-5: the `pipeline` command on the card(s), then (or, on a
    mesh, meanwhile) the same command CPU-pinned, then the comparison.

    One card: the device run is timed alone, so its stage walls are not
    shared with the CPU reference.  With --mesh N the device run is
    `pipeline --mesh N` and the reference `pipeline --readout doubling`,
    whose contig set the mesh stage matches by design; the reference runs
    concurrently, since N cards cost N times the card-time of one."""
    libs = make_data(base)
    cpu_work = os.path.join(base, "cpu")
    dev_work = os.path.join(base, "device")
    dev_extra = ["--mesh", str(mesh)] if mesh else []
    cpu_extra = ["--readout", "doubling"] if mesh else []
    cpu_log = os.path.join(base, "cpu.log")
    cpu_cmds = [pipeline_argv(cpu_work, libs, cpu_extra)]
    pool = ThreadPoolExecutor(max_workers=1)
    cpu = pool.submit(run_cli_cpu, cpu_cmds, cpu_log) if mesh else None
    t0 = time.perf_counter()
    out = json.loads(run_cli_here(pipeline_argv(dev_work, libs, dev_extra))
                     .strip().splitlines()[-1])
    for stage, sec in out["seconds"].items():
        log(f"device stage {stage}: {sec:.1f} s")
    log(f"device pipeline wall: {time.perf_counter() - t0:.1f} s"
        + (" (CPU reference running concurrently)" if mesh else ""))
    share = out["correct_host_fallback"] / max(out["correct_reads"], 1)
    log(f"correction engine {out['correct_engine']}: "
        f"{out['correct_host_fallback']} of {out['correct_reads']} reads "
        f"took the host fallback ({share:.6f})")
    t0 = time.perf_counter()
    if cpu is None:
        run_cli_cpu(cpu_cmds, cpu_log)
    else:
        cpu.result()
    pool.shutdown()
    log(f"CPU reference pipeline done {time.perf_counter() - t0:.1f} s "
        "after the device run")
    with open(cpu_log) as f:
        cpu_out = json.loads([ln for ln in f.read().splitlines()
                              if ln.startswith("{")][-1])
    for stage, sec in cpu_out["seconds"].items():
        log(f"CPU stage {stage}: {sec:.1f} s")
    compare_trees(cpu_work, dev_work)


def _content(path: str, root: str) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            data = f.read()
    else:
        with open(path, "rb") as f:
            data = f.read()
    if path.endswith(PATH_BEARING):
        data = data.replace(root.encode(), b"<work>")
    return data


def _files(root: str) -> set[str]:
    out = set()
    for d, _, names in os.walk(root):
        for n in names:
            out.add(os.path.relpath(os.path.join(d, n), root))
    return out


def compare_trees(ref: str, got: str) -> None:
    """Phase 5: every file of both work trees, byte for byte (.gz on the
    decompressed bytes; .lib/.para with the work directory masked).  One
    line per file; raises SystemExit naming every difference."""
    ref_files, got_files = _files(ref), _files(got)
    bad = []
    for rel in sorted(ref_files | got_files):
        if rel not in got_files or rel not in ref_files:
            side = "device" if rel not in got_files else "CPU reference"
            log(f"MISSING {rel} (absent from the {side} run)")
            bad.append(rel)
            continue
        a = _content(os.path.join(ref, rel), ref)
        b = _content(os.path.join(got, rel), got)
        if a == b:
            log(f"match {rel} ({len(a)} bytes)")
        else:
            at = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                      min(len(a), len(b)))
            log(f"DIFF {rel}: {len(a)} vs {len(b)} bytes, first difference "
                f"at byte {at}")
            bad.append(rel)
    if not ref_files:
        raise SystemExit(f"no artifacts under {ref}")
    if bad:
        raise SystemExit(f"{len(bad)} artifacts differ: {bad}")
    log(f"all {len(ref_files)} artifacts byte-identical")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="check `pipeline --mesh N` on N GPUs instead")
    a = ap.parse_args(argv)
    device = device_check(max(a.mesh, 1))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as base:
        run_check(base, a.mesh)
    log(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
