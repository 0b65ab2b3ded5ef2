"""correct_error_reads driver: 1-bit table in, corrected one-line FASTA out.

Parity: main_parallel_senior.cpp:142-269,507-679 — per input file writes
<file>.correct.fa.gz (header + "\\tModifiedBaseNum/FinalReadLength/
LeftEndTrim/RightEndTrim/IsDeleted" annotations, deleted reads emitted with
an empty sequence line) and <file>.correct.stat.  Optional read1/read2
pairing merge (merge_two_corr_files, correct.cpp:851-922).
"""

from __future__ import annotations

import gzip

import numpy as np

from ..io import cz as czio
from ..io import fastq, stat as statio
from ..kmer import count as kc
from .engine import CorrectParams, ReadCorrector, classify_regions_batch


def load_bitmap(cz_path: str, ksize: int) -> np.ndarray:
    """Load the 1-bit .cz table and OR in reverse-complement bits
    (make_kmerFreq_1bit_table_from_1BitGz + thread_setrevcompkmer,
    main_parallel_senior.cpp:334-408,310-329)."""
    bm = czio.read_cz_bits(cz_path, ksize)
    return kc.expand_bitmap_rc(bm, ksize)


def load_bitmap_8bit(cz_path: str, ksize: int,
                     low_freq_cutoff: int = 10) -> np.ndarray:
    """Load an 8-bit .cz table into a high-frequency bitmap with RC bits set
    (make_kmerFreq_1bit_table_from_8BitGz, correct_error/main.cpp:161-220:
    high iff count > cutoff, strict '>')."""
    from .. import dna
    freqs = czio.read_cz_bytes(cz_path, ksize)
    hi = np.flatnonzero(freqs > low_freq_cutoff).astype(np.uint64)
    total = 1 << (2 * ksize)
    bitmap = np.zeros(total // 8, dtype=np.uint8)
    for idx in (hi, dna.revcomp_kbit(hi, ksize)):
        np.bitwise_or.at(bitmap, (idx // 8).astype(np.int64),
                         (np.uint8(1) << (7 - (idx % 8)).astype(np.uint8)))
    return bitmap


def correct_batch_jax(batch, bitmap: np.ndarray, p: CorrectParams,
                      chunk: int = 8192, mesh=None):
    """Device correction (correct/device.py) with host fallback for reads
    that exceed the fixed beam/slot shapes (byte-exactness guaranteed by
    re-running flagged rows on the parity engine from the original read).
    mesh: a jax Mesh switches to the SHARDED corrector (the 4^k-bit table
    partitioned over the mesh, every probe a collective —
    correct/sharded.correct_batch_sharded, bit-equal to the single-device
    engine).  The last result is the number of reads re-run on the host."""
    from . import device as dev

    n = batch.n_reads
    Lmax = batch.seqs_ascii.shape[1]
    lengths = batch.lengths.astype(np.int32)
    if mesh is not None:
        from . import sharded as csh
        bm_shard = csh.shard_bitmap(mesh, bitmap)
    else:
        bitmap_dev = dev.bitmap_device(bitmap)
    ones = np.zeros(n, np.int32)
    multis = np.zeros(n, np.int32)
    deleteds = np.zeros(n, np.int32)
    tls = np.zeros(n, np.int32)
    trs = np.zeros(n, np.int32)
    reads_mod = np.ascontiguousarray(batch.seqs_ascii).copy()
    n_fallback = 0

    for off in range(0, n, chunk):
        end = min(off + chunk, n)
        c = end - off
        a = np.zeros((chunk, Lmax), np.uint8)
        cd = np.full((chunk, Lmax), 4, np.uint8)
        ln = np.zeros(chunk, np.int32)
        a[:c] = batch.seqs_ascii[off:end]
        cd[:c] = batch.codes[off:end]
        ln[:c] = lengths[off:end]
        if mesh is not None:
            (o, m, d, tl, tr, am, fb) = csh.correct_batch_sharded(
                mesh, a, cd, ln, bm_shard, p)
        else:
            (o, m, d, tl, tr, am, fb) = dev.correct_batch_device(
                a, cd, ln, bitmap_dev, p)
        ones[off:end] = o[:c]
        multis[off:end] = m[:c]
        deleteds[off:end] = d[:c]
        tls[off:end] = tl[:c]
        trs[off:end] = tr[:c]
        reads_mod[off:end] = am[:c]
        # host fallback for flagged rows, from the ORIGINAL read
        for i in np.flatnonzero(fb[:c]):
            gi = off + int(i)
            L = int(lengths[gi])
            read = bytearray(batch.seqs_ascii[gi, :L].tobytes())
            corr = ReadCorrector(bitmap, p)
            bits_i = classify_regions_batch(
                batch.codes[gi:gi + 1], lengths[gi:gi + 1], bitmap,
                p.ksize)[0]
            (ones[gi], multis[gi], deleteds[gi], tls[gi],
             trs[gi]) = corr.correct_one_read(
                read, bits_i[:max(L - p.ksize + 1, 0)])
            reads_mod[gi, :L] = np.frombuffer(bytes(read), np.uint8)
            n_fallback += 1
    return ones, multis, deleteds, tls, trs, reads_mod, n_fallback


def _engine(requested: str = "auto") -> str:
    """'native' | 'python' | 'jax' — like scaffold.index._engine: the
    native batch corrector on the CPU backend, the jax device engine on
    accelerators.  DBG_PY_CORRECT / DBG_JAX_CORRECT force."""
    import os
    if os.environ.get("DBG_PY_CORRECT") == "1":
        return "python"
    if os.environ.get("DBG_JAX_CORRECT") == "1":
        return "jax"
    if requested != "auto":
        return requested
    import jax
    return "native" if jax.default_backend() == "cpu" else "jax"


def correct_file(path: str, bitmap: np.ndarray, params: CorrectParams,
                 fmt: int = 1, engine: str = "auto", mesh=None) -> dict:
    """engine 'native' uses the C++ batch corrector (native/
    correct_engine.cpp, same semantics as the Python ReadCorrector —
    cross-verified in tests); 'python' forces the reference Python path;
    'jax' runs the device engine (correct/device.py) with host fallback;
    'auto' (default) picks jax on accelerator backends, native on CPU."""
    engine = _engine(engine)
    p = params.resolved()
    batch = fastq.read_batch(path, fmt="fq" if fmt == 1 else "fa",
                             strict_n=False, keep_ascii=True)
    n = batch.n_reads
    lengths = batch.lengths.astype(np.int64)
    # the jax engine classifies regions on device (correct/device.py
    # _stage_a) and its host fallback re-derives bits per flagged read —
    # the full-batch host pass would be pure duplicated work there
    bits = None
    if engine != "jax":
        bits = classify_regions_batch(batch.codes, batch.lengths, bitmap,
                                      p.ksize)

    num_raw_reads = n
    num_raw_bases = int(lengths.sum())
    num_res_reads = 0
    num_res_bases = 0
    num_trimmed_reads = 0
    num_trimmed_bases = 0
    num_deleted_reads = 0
    n_fallback = 0
    one_total = 0
    multi_total = 0

    if engine == "native" and n > 0:
        from .. import native as nat
        Lmax = batch.seqs_ascii.shape[1]
        flat = np.ascontiguousarray(batch.seqs_ascii).reshape(-1)
        offsets = (np.arange(n, dtype=np.int64) * Lmax)
        ones, multis, deleteds, tls, trs = nat.correct_batch(
            flat, offsets, lengths.astype(np.int32), bits, bitmap, p)
        reads_mod = flat.reshape(n, Lmax)
    elif engine == "jax" and n > 0:
        (ones, multis, deleteds, tls, trs, reads_mod,
         n_fallback) = correct_batch_jax(batch, bitmap, p, mesh=mesh)
    else:
        corr = ReadCorrector(bitmap, p)
        ones = np.zeros(n, np.int32)
        multis = np.zeros(n, np.int32)
        deleteds = np.zeros(n, np.int32)
        tls = np.zeros(n, np.int32)
        trs = np.zeros(n, np.int32)
        reads_mod = batch.seqs_ascii
        for i in range(n):
            L = int(lengths[i])
            read = bytearray(batch.seqs_ascii[i, :L].tobytes())
            if L >= p.ksize:
                (ones[i], multis[i], deleteds[i], tls[i],
                 trs[i]) = corr.correct_one_read(
                    read, bits[i, :max(L - p.ksize + 1, 0)])
            else:
                deleteds[i] = 1
            reads_mod[i, :L] = np.frombuffer(bytes(read), np.uint8)

    out = bytearray()
    for i in range(n):
        L = int(lengths[i])
        head = batch.heads[i]
        if fmt == 1 and head[:1] == b"@":
            head = b">" + head[1:]
        one, multi, deleted, tl, tr = (int(ones[i]), int(multis[i]),
                                       int(deleteds[i]), int(tls[i]),
                                       int(trs[i]))
        score = one + multi
        final_len = L - tl - tr
        if not deleted:
            one_total += one
            multi_total += multi
            read = reads_mod[i, tl:tl + final_len].tobytes()
            if tl > 0 or tr > 0:
                num_trimmed_reads += 1
                num_trimmed_bases += tl + tr
            num_res_reads += 1
            num_res_bases += final_len
        else:
            num_deleted_reads += 1
            read = b""
        out += (head + f"\tModifiedBaseNum: {score}"
                f"\tFinalReadLength: {len(read)}"
                f"\tLeftEndTrim: {tl}\tRightEndTrim: {tr}"
                f"\tIsDeleted: {deleted}".encode()
                + b"\n" + read + b"\n")

    out_path = path + ".correct.fa.gz"
    with gzip.open(out_path, "wb", compresslevel=6) as f:
        f.write(bytes(out))
    statio.write_correct_stat(path + ".correct.stat", num_raw_reads,
                              num_raw_bases, num_res_reads, num_res_bases,
                              num_trimmed_reads, num_trimmed_bases,
                              num_deleted_reads, one_total, multi_total)
    return {"out": out_path, "stat": path + ".correct.stat",
            "reads": n, "res_reads": num_res_reads,
            "deleted": num_deleted_reads, "engine": engine,
            "host_fallback": n_fallback}


def run(cz_path: str, lib_path: str, params: CorrectParams | None = None,
        fmt: int = 1, engine: str = "auto",
        mesh_devices: int = 0) -> list[dict]:
    """mesh_devices > 0 runs the SHARDED corrector over that many devices
    (table partitioned, probes collective — the k>17 capacity path);
    implies the jax engine."""
    from ..contig.pipeline import read_file_list

    if params is None:
        params = CorrectParams()
    bitmap = load_bitmap(cz_path, params.ksize)
    mesh = None
    if mesh_devices:
        from ..parallel import mesh as meshmod
        mesh = meshmod.data_mesh(mesh_devices)
        engine = "jax"
    results = []
    for path in read_file_list(lib_path):
        results.append(correct_file(path, bitmap, params, fmt, engine,
                                    mesh=mesh))
    return results


def correct_file_8bit(path: str, bitmap: np.ndarray, params: CorrectParams,
                      fmt: int = 1) -> dict:
    """correct_error (8-bit table) driver variant.

    Parity: correct_error/parse_one_reads_fq_file / _fa_file
    (correct.cpp:639-848): outputs <reads>.cor (gz) with the
    " score: N  left_trim: N" header annotation, deleted reads as an empty
    line, and <reads>.cor.stat with the older key names.  Defaults differ
    from the senior driver: HighFreqRegLenCutoff IS recomputed from -k
    (main.cpp:93-95), Further_trim_len default is the compiled 17/2=8.
    """
    p = params.resolved()
    batch = fastq.read_batch(path, fmt="fq" if fmt == 1 else "fa",
                             strict_n=False, keep_ascii=True)
    n = batch.n_reads
    lengths = batch.lengths.astype(np.int64)
    bits = classify_regions_batch(batch.codes, batch.lengths, bitmap,
                                  p.ksize)
    corr = ReadCorrector(bitmap, p)

    stats = dict(raw_reads=n, raw_bases=int(lengths.sum()), res_reads=0,
                 res_bases=0, trimmed_reads=0, trimmed_bases=0,
                 deleted_reads=0, one=0, multi=0)
    out = bytearray()
    for i in range(n):
        L = int(lengths[i])
        head = batch.heads[i]
        if fmt == 1 and head[:1] == b"@":
            head = b">" + head[1:]
        read = bytearray(batch.seqs_ascii[i, :L].tobytes())
        if L >= p.ksize:
            one, multi, deleted, tl, tr = corr.correct_one_read(
                read, bits[i, :max(L - p.ksize + 1, 0)])
        else:
            one, multi, deleted, tl, tr = 0, 0, 1, 0, 0
        score = one + multi
        final_len = L - tl - tr
        if not deleted:
            stats["one"] += one
            stats["multi"] += multi
            if tl > 0 or tr > 0:
                read = read[tl:tl + final_len]
                stats["trimmed_reads"] += 1
                stats["trimmed_bases"] += tl + tr
            stats["res_reads"] += 1
            stats["res_bases"] += final_len
            out += (head + f" score: {score}  left_trim: {tl}".encode()
                    + b"\n" + bytes(read) + b"\n")
        else:
            stats["deleted_reads"] += 1
            out += (head + f" score: {score}  left_trim: {tl}".encode()
                    + b"\n\n")
    with gzip.open(path + ".cor", "wb", compresslevel=6) as f:
        f.write(bytes(out))

    all_score = stats["one"] + stats["multi"]
    filt = (stats["raw_bases"] - stats["res_bases"]) / stats["raw_bases"] \
        if stats["raw_bases"] else float("nan")
    corr_ratio = all_score / stats["res_bases"] if stats["res_bases"] \
        else float("nan")
    with open(path + ".cor.stat", "w") as f:
        f.write(f"num_raw_reads {stats['raw_reads']}\n")
        f.write(f"num_raw_bases {stats['raw_bases']}\n")
        f.write(f"num_result_reads {stats['res_reads']}\n")
        f.write(f"num_result_bases {stats['res_bases']}\n")
        f.write(f"\nnum_trimmed_reads {stats['trimmed_reads']}\n")
        f.write(f"num_trimmed_bases {stats['trimmed_bases']}\n")
        f.write(f"num_deleted_reads {stats['deleted_reads']}\n")
        f.write(f"\nnum_corrected_bases_by_Fast_method {stats['one']}\n")
        f.write(f"num_corrected_bases_by_BBtree_method {stats['multi']}\n")
        f.write(f"num_corrected_bases_by_two_methods {all_score}\n")
        f.write("\nlow_quality_bases_filter_ratio "
                f"{statio.fmt_g6(filt)}\n")
        f.write("estimated_raw_base_error_ratio "
                f"{statio.fmt_g6(corr_ratio)}\n")
    return {"out": path + ".cor", "stat": path + ".cor.stat"}


def run_8bit(cz_path: str, lib_path: str, ksize: int = 17,
             low_freq_cutoff: int = 10, max_change: int = 2,
             high_freq_reg_len: int = 0, further_trim: int = 0,
             min_read_len: int = 50, max_bbt_nodes: int = 15_000_000,
             fmt: int = 1, join: bool = True) -> list[dict]:
    """correct_error (v2.2, 8-bit table) pipeline.  -m 0 resolves to the
    RUNTIME k (main.cpp:93-95), -x 0 to the compiled 17/2 = 8."""
    from ..contig.pipeline import read_file_list
    from ..utils.helpers import merge_corrected_pair

    params = CorrectParams(
        ksize=ksize,
        high_freq_reg_len=high_freq_reg_len or ksize,
        max_change=max_change,
        further_trim=further_trim or 8,
        max_bbt_nodes=max_bbt_nodes,
        min_read_len=min_read_len)
    bitmap = load_bitmap_8bit(cz_path, ksize, low_freq_cutoff)
    results = []
    files = read_file_list(lib_path)
    for path in files:
        results.append(correct_file_8bit(path, bitmap, params, fmt))
    if join:
        for i in range(0, len(files) - 1, 2):
            merge_corrected_pair(files[i] + ".cor", files[i + 1] + ".cor")
    return results
