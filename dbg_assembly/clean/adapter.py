"""clean_adapter — adapter trimming by ungapped local DP, vectorized.

Reference semantics (clean_illumina/clean_adapter.cpp):
  * alphabet maps N and every non-ACGT byte to 4 (:54-64); score matrix is
    +1 for a base match, -2 otherwise incl. N-vs-N (:67-73).
  * the "DP" is diagonal-only (ungapped): S[i][j] = max(0, S[i-1][j-1] + s)
    (:120-135); the best cell is tracked with a STRICT '>' so ties resolve
    to the first cell in row-major (read-pos, adapter-pos) order (:129-133).
  * traceback walks the diagonal back to the nearest zero cell; the start is
    the cell after it (:138-149).
  * adapters are tried in file order and the FIRST one whose max score
    reaches the cutoff wins, truncating the read at align_read_start-1
    (:189-206); header annotation :199-202.
  * reads shorter than the minimum after trimming are emptied ("RemoveShort",
    :211-216); every read is written out.

Vectorization: one lax.scan over read positions carrying the DP row
[N, M+1] per adapter, with run-start tracking so no traceback pass is
needed.  All adapters are scored in one batched pass and the first-hit rule
is applied by index arithmetic afterwards — same result, no early exit.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from .. import dna
from ..io import stat as statio

DEFAULT_ADAPTERS = {
    # shipped defaults: clean_illumina/illumina_NEB_adapter*.fa
    "Both-adapter": [("R1", "GATCGGAAGAGCACACGTCTGAACTCCAGTCAC"),
                     ("R2", "GATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT")],
    "R1-adapter": [("R1", "GATCGGAAGAGCACACGTCTGAACTCCAGTCAC")],
    "R2-adapter": [("R2", "GATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT")],
}


@functools.partial(jax.jit, static_argnames=("adapter_len",))
def _align_one_adapter(read_codes: jnp.ndarray, lengths: jnp.ndarray,
                       adapter_codes: jnp.ndarray, adapter_len: int):
    """Ungapped local alignment of every read vs one adapter.

    read_codes: [N, L] uint8 (strict alphabet: N=4), lengths [N].
    Returns (max_score, i_end, j_end, i_start, j_start) each [N], 1-based
    coordinates matching the reference's traceback output.
    """
    N, L = read_codes.shape
    M = adapter_len
    a = adapter_codes[:M].astype(jnp.int32)                 # [M]

    def step(carry, x):
        dp_row, start_row, best, i = carry
        codes_i, = x
        # match score for row i vs all adapter positions
        s = jnp.where((codes_i[:, None] == a[None, :])
                      & (codes_i[:, None] < 4), 1, -2)      # [N, M]
        prev = dp_row[:, :M]                                # S[i-1][j-1]
        val = prev + s
        val = jnp.maximum(val, 0)
        # run starts at (i, j) when the diagonal predecessor cell is zero
        new_start_i = jnp.where(prev == 0, i, start_row[:, :M, 0])
        new_start_j = jnp.where(prev == 0,
                                jnp.arange(1, M + 1, dtype=jnp.int32)[None, :],
                                start_row[:, :M, 1])
        dp_next = jnp.concatenate(
            [jnp.zeros((N, 1), jnp.int32), val], axis=1)
        start_next = jnp.stack(
            [jnp.concatenate([jnp.zeros((N, 1), jnp.int32), new_start_i], 1),
             jnp.concatenate([jnp.zeros((N, 1), jnp.int32), new_start_j], 1)],
            axis=-1)
        # best update: row-major strict '>' — within the row argmax picks the
        # first maximal j; across rows only strictly greater replaces.
        in_read = (i <= lengths)                            # i is 1-based
        row_best_j = jnp.argmax(val, axis=1).astype(jnp.int32)  # first max
        row_best = jnp.max(val, axis=1)
        row_best = jnp.where(in_read, row_best, -1)
        bs, bi, bj, bsi, bsj = best
        better = row_best > bs
        j1 = row_best_j + 1
        bs = jnp.where(better, row_best, bs)
        bi = jnp.where(better, i, bi)
        bj = jnp.where(better, j1, bj)
        take = lambda arr: jnp.take_along_axis(arr, row_best_j[:, None],
                                               axis=1)[:, 0]
        bsi = jnp.where(better, take(new_start_i), bsi)
        bsj = jnp.where(better, take(new_start_j), bsj)
        return (dp_next, start_next, (bs, bi, bj, bsi, bsj), i + 1), None

    dp0 = jnp.zeros((N, M + 1), jnp.int32)
    st0 = jnp.zeros((N, M + 1, 2), jnp.int32)
    best0 = (jnp.zeros(N, jnp.int32), jnp.zeros(N, jnp.int32),
             jnp.zeros(N, jnp.int32), jnp.zeros(N, jnp.int32),
             jnp.zeros(N, jnp.int32))
    xs = (jnp.swapaxes(read_codes.astype(jnp.int32), 0, 1),)
    (_, _, best, _), _ = jax.lax.scan(step, (dp0, st0, best0, jnp.int32(1)),
                                      xs)
    bs, bi, bj, bsi, bsj = best
    return bs, bi, bj, bsi, bsj


@dataclass
class AdapterResult:
    hit: np.ndarray            # [N] adapter index or -1
    score: np.ndarray          # [N]
    read_start: np.ndarray     # [N] 1-based alignment start on read
    read_end: np.ndarray       # [N]
    adapter_start: np.ndarray  # [N]
    adapter_end: np.ndarray    # [N]
    keep_len: np.ndarray       # [N] after trimming, before short filter
    short: np.ndarray          # [N] bool


def clean_adapter_arrays(read_codes: np.ndarray, lengths: np.ndarray,
                         adapters: list[str], score_cutoff: int,
                         min_read_len: int) -> AdapterResult:
    n = len(read_codes)
    per_adapter = []
    for aseq in adapters:
        acodes = dna.ascii_to_codes(
            np.frombuffer(aseq.encode(), np.uint8), strict_n=True)
        res = _align_one_adapter(jnp.asarray(read_codes),
                                 jnp.asarray(lengths.astype(np.int32)),
                                 jnp.asarray(acodes), len(aseq))
        per_adapter.append([np.asarray(x) for x in res])

    hit = np.full(n, -1, np.int64)
    score = np.zeros(n, np.int64)
    rs = np.zeros(n, np.int64)
    re_ = np.zeros(n, np.int64)
    as_ = np.zeros(n, np.int64)
    ae = np.zeros(n, np.int64)
    for ai, (bs, bi, bj, bsi, bsj) in enumerate(per_adapter):
        sel = (hit < 0) & (bs >= score_cutoff)
        hit = np.where(sel, ai, hit)
        score = np.where(sel, bs, score)
        rs = np.where(sel, bsi, rs)
        re_ = np.where(sel, bi, re_)
        as_ = np.where(sel, bsj, as_)
        ae = np.where(sel, bj, ae)

    keep_len = np.where(hit >= 0, rs - 1, lengths.astype(np.int64))
    short = keep_len < min_read_len
    return AdapterResult(hit, score, rs, re_, as_, ae, keep_len, short)


def load_adapter_file(path: str, use_rc: bool = False):
    """Parse a multi-FASTA adapter file (read_fasta, clean_adapter.cpp:234-268)."""
    ids, seqs = [], []
    with open(path) as f:
        cur_id, cur = None, []
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if cur_id is not None:
                    seqs.append("".join(cur))
                    ids.append(cur_id)
                cur_id = line[1:].split()[0]
                cur = []
            else:
                cur.append(line)
        if cur_id is not None:
            seqs.append("".join(cur))
            ids.append(cur_id)
    if use_rc:
        out_ids, out_seqs = [], []
        comp = str.maketrans("ACGTNacgtn", "TGCANtgcan")
        for i, s in zip(ids, seqs):
            out_ids.append(i)
            out_seqs.append(s)
            out_ids.append(i + " minus-strand")
            out_seqs.append(s.translate(comp)[::-1])
        return out_ids, out_seqs
    return ids, seqs


def run_file(in_path: str, out_path: str, stat_path: str,
             adapter_file: str = "Both-adapter", score_cutoff: int = 12,
             min_read_len: int = 75, use_rc: bool = False) -> dict:
    """File-level driver (CLI parity: clean_adapter <in> <out> <stat>)."""

    from ..io import fastq

    if adapter_file in DEFAULT_ADAPTERS:
        ids = [x[0] for x in DEFAULT_ADAPTERS[adapter_file]]
        seqs = [x[1] for x in DEFAULT_ADAPTERS[adapter_file]]
    else:
        ids, seqs = load_adapter_file(adapter_file, use_rc)

    batch = fastq.read_batch(in_path, fmt="fq", strict_n=True,
                             keep_ascii=True)
    seq = batch.seqs_ascii
    lengths = batch.lengths.astype(np.int64)
    res = clean_adapter_arrays(batch.codes, batch.lengths, seqs,
                               score_cutoff, min_read_len)
    n = batch.n_reads

    raw_reads = n
    raw_bases = int(lengths.sum())
    trimmed = res.hit >= 0
    trimmed_reads = int(trimmed.sum())
    trimmed_bases = int((lengths - res.read_start + 1)[trimmed].sum())
    short_reads = int(res.short.sum())
    short_bases = int(res.keep_len[res.short].clip(0).sum())
    final_len = np.where(res.short, 0, res.keep_len)
    clean_reads = int((~res.short).sum())
    clean_bases = int(final_len[~res.short].sum())

    out = bytearray()
    for i in range(n):
        head = batch.heads[i]
        if trimmed[i]:
            head += (f"   Aligned to adapter {ids[res.hit[i]]}, "
                     f" reads_pos: {res.read_start[i]}-{res.read_end[i]}, "
                     f"adapter_pos: {res.adapter_start[i]}-"
                     f"{res.adapter_end[i]},   score: {res.score[i]}"
                     ).encode()
        if res.short[i]:
            head += b"   RemoveShort"
        l_ = int(final_len[i])
        out += head + b"\n" + seq[i, :l_].tobytes() + b"\n+\n" \
            + batch.quals[i, :l_].tobytes() + b"\n"
    fastq.gz_write_bytes(out_path, bytes(out))

    statio.write_clean_adapter_stat(stat_path, raw_reads, raw_bases,
                                    trimmed_reads, trimmed_bases,
                                    short_reads, short_bases,
                                    clean_reads, clean_bases)
    return dict(raw_reads=raw_reads, clean_reads=clean_reads)
