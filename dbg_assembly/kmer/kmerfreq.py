"""kmerfreq replacement — k-mer frequency table producer.

The external `kmerfreq` tool (sister repo of the reference, NOT shipped) is
replaced by the device counting engine.  Outputs, matching the formats consumed
by the reference binaries and shipped stat fixtures:

  <lib>.kmer.freq.cz / .cz.len   1-bit-per-kmer table: bit set at the
                                 CANONICAL index iff count > low_freq_cutoff
                                 (consumer spec main_parallel_senior.cpp:
                                 273-329; strict '>' per main.cpp:202)
  <lib>.kmer.freq.stat           spectrum table (format per
                                 test/01.clean_correct/clean_reads.lib.
                                 kmer.freq.stat), counters capped at 65535.
"""

from __future__ import annotations

import numpy as np

from ..io import cz as czio
from ..io import fastq, stat as statio
from . import count as kc


def split_reads_by_quality(codes: np.ndarray, lengths: np.ndarray,
                           quals: np.ndarray, ksize: int, cutoff: int,
                           shift: int = 33):
    """kmerfreq `-q` quality masking: a base whose Phred quality
    (ascii - shift) is below `cutoff` is unreliable; every k-mer window
    covering it is excluded from the count.  Implemented by splitting each
    read at unreliable bases into its maximal reliable segments (>= ksize)
    — counting the segments is exactly counting the surviving windows.

    The external kmerfreq (sister repo, not shipped here) is invoked as
    `kmerfreq -k 17 -m 1 -q 10` by the canonical workflow
    (test/01.clean_correct/work.sh:31); the Phred+33 convention matches the
    rest of the suite (clean_lowqual.cpp:26 Quality_shift=33).
    Returns (codes2 [R, Lmax2] uint8, lengths2 [R] int32)."""
    N, L = codes.shape
    pos = np.arange(L)[None, :]
    inlen = pos < lengths[:, None]
    good = inlen & ((quals.astype(np.int32) - shift) >= cutoff)
    if good.sum() == inlen.sum():
        return codes, lengths
    prev = np.zeros_like(good)
    prev[:, 1:] = good[:, :-1]
    starts2d = good & ~prev
    flat_good = good.ravel()
    rid = np.cumsum(starts2d.ravel()) - 1          # run id at good slots
    n_runs = int(starts2d.sum())
    if n_runs == 0:
        return (np.zeros((0, ksize), np.uint8), np.zeros(0, np.int32))
    run_len = np.bincount(rid[flat_good], minlength=n_runs)
    run_start = np.flatnonzero(starts2d.ravel())
    keep = run_len >= ksize
    run_len = run_len[keep]
    run_start = run_start[keep]
    if len(run_len) == 0:
        return (np.zeros((0, ksize), np.uint8), np.zeros(0, np.int32))
    Lmax = int(run_len.max())
    flat_codes = codes.ravel()
    idx = np.minimum(run_start[:, None] + np.arange(Lmax)[None, :],
                     len(flat_codes) - 1)
    return flat_codes[idx], run_len.astype(np.int32)


def run(lib_path: str, ksize: int = 17, low_freq_cutoff: int = 1,
        fmt: str | None = None, out_prefix: str | None = None,
        batch_reads: int = 200_000, table_format: str = "1bit",
        qual_cutoff: int = 0, qual_shift: int = 33) -> dict:
    """table_format '1bit': high/low bitmap (kmerfreq_16bit, consumed by
    correct_error_reads); '8bit': one saturated count byte per k-mer index
    (consumed by correct_error/correct_error_parallel,
    correct_error/main.cpp:161-220).  qual_cutoff > 0 enables `-q`
    quality masking (split_reads_by_quality) for FASTQ inputs."""
    from ..contig.pipeline import read_file_list

    prefix = out_prefix or (lib_path + ".kmer.freq")
    files = read_file_list(lib_path)
    counter = kc.KmerCounter(ksize, batch_reads=batch_reads)
    for path in files:
        batch = fastq.read_batch(path, fmt=fmt, strict_n=False,
                                 keep_heads=False)
        codes, lens = batch.codes, batch.lengths
        if qual_cutoff > 0 and batch.quals is not None \
                and batch.quals.any():
            codes, lens = split_reads_by_quality(
                codes, lens, batch.quals, ksize, qual_cutoff, qual_shift)
        if len(codes):
            counter.add(codes, lens)
    uniq, counts, total = counter.finalize()

    if table_format == "8bit":
        freqs = np.zeros(1 << (2 * ksize), dtype=np.uint8)
        freqs[uniq.astype(np.int64)] = np.minimum(counts, 255)
        czio.write_cz_bytes(prefix + ".cz", freqs)
        bitmap = None
    else:
        bitmap = kc.freq_bitmap(uniq, counts, ksize, low_freq_cutoff)
        czio.write_cz_bits(prefix + ".cz", bitmap)

    spec = kc.spectrum(counts, max_freq=65535)
    theory = 1 << (2 * ksize)
    statio.write_kmerfreq_stat(prefix + ".stat", ksize, 65535,
                               int(total), len(uniq), theory, spec)
    return {"cz": prefix + ".cz", "stat": prefix + ".stat",
            "species": len(uniq), "individuals": int(total),
            "bitmap": bitmap}
