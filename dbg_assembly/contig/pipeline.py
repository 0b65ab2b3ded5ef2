"""debruijn_contig pipeline driver: device graph build + order-exact assembly.

CLI parity with DBG_contig/main.cpp:162-212 (flags mapped to AssembleParams);
outputs the full artifact set: .contig.seq.fa/.seq.depth, .small.*, .tip.fa,
.lowedge.fa, .bubble.fa, .kmer.freq.
"""

from __future__ import annotations

from .graph import GraphBuilder
from .refassemble import (AssembleParams, RefAssembler, _cap,
                          compute_hash_schedule)


def read_file_list(path: str) -> list[str]:
    """Parity: DBG_contig/seqKmer.cpp:101-114 (every nonempty line)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                out.append(line)
    return out


def _ingest(files, fmt, ksize, max_read_len, mesh, ranges=None,
            lengths_sink=None):
    """Feed all files into a GraphBuilder.  ranges: per-file (start, end)
    GLOBAL read-ordinal windows for the degrade re-pass (DBGgraph.cpp:
    337-351 ignore-remaining-reads policy) — the builder's read ordinals
    are pinned to the ORIGINAL numbering so stream->read mapping and the
    schedule recomputation stay in the same coordinate system.
    lengths_sink: list collecting the per-file truncated length arrays of
    the reads actually INGESTED (for the parity run log)."""
    import numpy as np
    from ..io import fastq
    from concurrent.futures import ThreadPoolExecutor

    gb = GraphBuilder(ksize, max_read_len, mesh=mesh)

    def _read(path):
        return fastq.read_batch(path, fmt="fq" if fmt == 1 else "fa",
                                strict_n=False, keep_heads=False)

    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(_read, files[0]) if files else None
        for i, path in enumerate(files):
            batch = fut.result()
            if i + 1 < len(files):
                fut = ex.submit(_read, files[i + 1])
            codes, lengths = batch.codes, batch.lengths
            if ranges is not None:
                # every degrade range is a file PREFIX; pin the builder's
                # ordinal counter to the file's ORIGINAL start so the
                # truncated pass shares the full pass's coordinates
                s, e = ranges[i]
                gb.read_seq = s
                codes, lengths = codes[:e - s], lengths[:e - s]
            gb.new_file()
            if lengths_sink is not None:
                lengths_sink.append(
                    np.minimum(lengths, max_read_len).astype(np.int32))
            gb.add(codes, lengths)
    return gb


def run(lib_file: str, prefix: str, ksize: int = 31, fmt: int = 1,
        max_read_len: int = 250, params: AssembleParams | None = None,
        readout: str = "exact", log_stream=None, log_threads: int = 10,
        log_buffer: int = 10_000, log_doublings: int = 10,
        mesh_devices: int = 0):
    """readout="exact" replays the reference serially (byte-exact files);
    readout="doubling" runs the scalable bulk-pruning + pointer-doubling
    assembler (record-exact; file order may differ on length ties).
    mesh_devices > 0 builds a jax Mesh over that many devices and runs the
    DISTRIBUTED stage: all_to_all-routed ingest (GraphBuilder mesh mode) +
    the mesh contig stage (sharded table search / links / resolve;
    implies readout="doubling" semantics, byte-identical to it).
    log_stream: emit the reference-parity cerr run log there
    (contig/runlog.py; the reference's per-block heartbeat cadence follows
    log_buffer = its -b flag, log_threads its -t).

    Hash enlargement parity: when the distinct-node count exceeds the
    initial capacity (-i x load factor), the reference grows the table x2
    between ingest buffers (kmerSet.cpp:132-189) and, past -e doublings,
    stops ingesting further reads (DBGgraph.cpp:337-351).  Both are
    emulated: a schedule is derived from first-occurrence read ordinals,
    the degrade case re-ingests exactly the reference's read subset, and
    the epoch-aware native layout reproduces the redistributed slot order
    byte-for-byte."""
    import numpy as np
    from .. import native
    from .runlog import ContigRunLog, count_end_marks

    if params is None:
        params = AssembleParams(ksize=ksize)
    params.ksize = ksize
    params.buffer_reads = log_buffer
    params.max_doublings = log_doublings
    files = read_file_list(lib_file)
    log = None
    if log_stream is not None:
        log = ContigRunLog(log_stream, params, prefix, fmt, max_read_len,
                           threads=log_threads, buffer_reads=log_buffer,
                           max_doublings=log_doublings)
        log.parameters()
        log.hash_init()
    mesh = None
    if mesh_devices:
        from ..parallel import mesh as meshmod
        mesh = meshmod.data_mesh(mesh_devices)

    want_lengths = log is not None
    file_lengths: list | None = [] if want_lengths else None
    gb = _ingest(files, fmt, ksize, max_read_len, mesh,
                 lengths_sink=file_lengths)
    table = gb.finalize()

    # ---- enlargement / degrade schedule (exact-path parity)
    schedule = None
    epoch_occ = None
    init = int(params.init_hash_size * 1_000_000_000)
    size0 = 3 if init < 3 else native.find_next_prime(init)
    n_normal = int((table.kmers != np.uint64(0)).sum())
    if n_normal > _cap(size0, params.load_factor):
        normal = table.kmers != np.uint64(0)
        first_read = gb.stream_to_read(table.first_idx[normal])
        schedule = compute_hash_schedule(first_read, gb.file_starts,
                                         gb.read_seq, params)
        if schedule.ingest_ranges is not None:
            # degrade: re-ingest exactly the reference's read subset
            file_lengths = [] if want_lengths else None
            gb = _ingest(files, fmt, ksize, max_read_len, mesh,
                         ranges=schedule.ingest_ranges,
                         lengths_sink=file_lengths)
            table = gb.finalize()
            normal = table.kmers != np.uint64(0)
            first_read = gb.stream_to_read(table.first_idx[normal])
            schedule = compute_hash_schedule(first_read, gb.file_starts,
                                             gb.read_seq, params)
        if schedule.enlarge_reads:
            # per-epoch occurrence counts for count_conflict parity: one
            # truncated recount per enlargement boundary (rare; goldens
            # are small and production sizes -i to avoid enlargement)
            epoch_occ = [
                _occurrences_before(files, fmt, ksize, max_read_len,
                                    schedule.ingest_ranges, q, table)
                for q in schedule.enlarge_reads]

    if log:
        _emit_file_log(log, files, file_lengths, ksize, schedule, gb)

    if mesh is not None:
        from .mesh_assemble import assemble_doubling_mesh
        stats = assemble_doubling_mesh(table, params, prefix, mesh)
        readout = "doubling"
    elif readout == "doubling":
        from .pointer_doubling import assemble_doubling
        stats = assemble_doubling(table, params, prefix)
    else:
        asm = RefAssembler(table, params, schedule, epoch_occ)
        if log:
            log.hash_params(asm.size, asm.n_nodes,
                            asm.stats.hash_conflicts_occ)
        stats = asm.run(prefix)
    if log:
        if readout == "doubling":
            log.hash_params(stats.hash_size, stats.total_nodes,
                            stats.hash_conflicts_occ)
        log.links(stats)
        log.pruning(stats)
        brk, bra = count_end_marks(prefix)
        log.readout(stats, brk, bra)
    return stats


def _occurrences_before(files, fmt, ksize, max_read_len, ranges, q, table):
    """Per-table-row canonical k-mer occurrence counts over reads with
    global ordinal < q (for the epoch-wise count_conflict emulation)."""
    import numpy as np
    from ..io import fastq
    from ..kmer import count as kc

    counter = kc.KmerCounter(ksize)
    seq = 0
    for i, path in enumerate(files):
        batch = fastq.read_batch(path, fmt="fq" if fmt == 1 else "fa",
                                 strict_n=False, keep_heads=False)
        codes, lengths = batch.codes, batch.lengths
        n = len(codes)
        s, e = (seq, seq + n) if ranges is None else ranges[i]
        lo, hi = max(s, seq), min(e, seq + n, q)
        if hi > lo:
            cb = codes[lo - seq:hi - seq][:, :max_read_len]
            lb = np.minimum(lengths[lo - seq:hi - seq], max_read_len)
            counter.add(cb, lb)
        seq += n
        if seq >= q:
            break
    uniq, counts, _ = counter.finalize()
    out = np.zeros(len(table.kmers), np.int64)
    idx = np.searchsorted(table.kmers, uniq)
    ok = (idx < len(table.kmers))
    ok &= table.kmers[np.minimum(idx, len(table.kmers) - 1)] == uniq
    out[idx[ok]] = counts[ok]
    return out


def _emit_file_log(log, files, file_lengths, ksize, schedule, gb):
    """Replay the per-file heartbeat groups, injecting the enlargement /
    degrade lines at their buffer boundaries."""
    enlarges = {}
    alerts = {}
    if schedule is not None:
        for q, ns in zip(schedule.enlarge_reads, schedule.sizes[1:]):
            enlarges[q] = ns
        for q, total in schedule.alerts:
            alerts[q] = total
    starts = list(gb.file_starts)
    for i, path in enumerate(files):
        log.file_start(path)
        log.file_blocks(file_lengths[i], ksize, file_start=starts[i],
                        enlarges=enlarges, alerts=alerts)
        log.file_end()
