"""FASTQ/FASTA (one-line, optionally gzipped) I/O to padded code batches.

The reference streams records with gzstream + getline (e.g. DBGgraph.cpp:
244-272, clean_lowqual.cpp:248-259); the array design instead decodes a
whole file (or block) into fixed-shape uint8 tensors:

    ReadBatch.codes  [N, Lmax] uint8   2-bit codes (pad = 4)
    ReadBatch.quals  [N, Lmax] uint8   raw ASCII qualities (pad = 0)
    ReadBatch.lengths [N]      int32
    ReadBatch.heads  list[bytes]       raw header lines (host-side only)

Record-selection parity: the reference accepts a record only when the header
line starts with '@' ('>' for FASTA) and then unconditionally consumes the
next 3 (1) lines (DBGgraph.cpp:246-258) — reproduced here.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field

import numpy as np

from .. import dna


def _open_maybe_gz(path: str, mode: str = "rb"):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, mode)
    return open(path, mode)


@dataclass
class ReadBatch:
    codes: np.ndarray          # [N, Lmax] uint8, 0..3 bases, 4 = pad (and N if strict)
    quals: np.ndarray          # [N, Lmax] uint8 raw ASCII (0 = pad / absent)
    lengths: np.ndarray        # [N] int32
    heads: list = field(default_factory=list)
    seqs_ascii: np.ndarray | None = None   # [N, Lmax] uint8 raw bytes (0 pad)

    @property
    def n_reads(self) -> int:
        return int(self.codes.shape[0])

    @property
    def n_bases(self) -> int:
        return int(self.lengths.sum())


def _records_from_lines(lines: list[bytes], fmt: str):
    """Yield (head, seq, qual|None) honoring the reference's guard-and-skip."""
    lead = b"@" if fmt == "fq" else b">"
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i]
        if line.startswith(lead):
            if fmt == "fq":
                if i + 3 >= n:
                    break
                yield line, lines[i + 1], lines[i + 3]
                i += 4
            else:
                if i + 1 >= n:
                    break
                yield line, lines[i + 1], None
                i += 2
        else:
            i += 1


def read_batch(path: str, fmt: str | None = None, strict_n: bool = False,
               max_len: int | None = None, keep_heads: bool = True,
               keep_ascii: bool = False) -> ReadBatch:
    """Load a whole one-line FASTQ/FASTA(.gz) file into a padded batch.

    The per-record loop looks naive but is the right shape for one-shot
    pipeline processes on this class of host: a fully vectorized variant
    (newline scan + bulk gathers) was measured SLOWER cold because it
    touches ~3x the fresh memory (index planes + masks) and first-touch
    page faults dominate; the loop writes straight into the two output
    arrays."""
    if fmt is None:
        base = path[:-3] if path.endswith(".gz") else path
        fmt = "fa" if any(base.endswith(e) for e in (".fa", ".fasta", ".fa.gz")) \
            or ".fa." in os.path.basename(path) else "fq"
        # heuristic fallback: sniff first byte
    with _open_maybe_gz(path) as f:
        data = f.read()
    if data[:1] == b">":
        fmt = "fa"
    elif data[:1] == b"@":
        fmt = "fq"
    if os.environ.get("DBG_PY_FASTQ") != "1":
        # native single-pass parser (native/fastq_engine.cpp): the
        # per-record numpy loop below costs ~11 us/record, which made
        # file decode the largest cost of the contig/map stages
        from .. import native
        codes, qarr, lens32, hoff, hlen, aarr = native.fastq_parse(
            data, fq=(fmt == "fq"), strict_n=strict_n, max_len=max_len,
            keep_ascii=keep_ascii)
        heads = [data[o:o + l] for o, l in zip(hoff, hlen)] \
            if keep_heads else []
        return ReadBatch(codes=codes, quals=qarr, lengths=lens32,
                         heads=heads, seqs_ascii=aarr)
    lines = data.split(b"\n")
    heads, seqs, quals = [], [], []
    for h, s, q in _records_from_lines(lines, fmt):
        heads.append(h)
        seqs.append(s)
        quals.append(q if q is not None else b"")

    n = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=n)
    Lmax = int(lens.max()) if n else 0
    if max_len is not None:
        Lmax = min(Lmax, max_len) if n else 0
    codes = np.full((n, Lmax), 4, dtype=np.uint8)
    qarr = np.zeros((n, Lmax), dtype=np.uint8)
    aarr = np.zeros((n, Lmax), dtype=np.uint8) if keep_ascii else None
    for i, (s, q) in enumerate(zip(seqs, quals)):
        L = min(len(s), Lmax)
        sb = np.frombuffer(s, dtype=np.uint8, count=L)
        codes[i, :L] = dna.ascii_to_codes(sb, strict_n=strict_n)
        if aarr is not None:
            aarr[i, :L] = sb
        if q:
            ql = min(len(q), L)
            qarr[i, :ql] = np.frombuffer(q, dtype=np.uint8, count=ql)
    return ReadBatch(codes=codes, quals=qarr,
                     lengths=np.minimum(lens, Lmax).astype(np.int32),
                     heads=heads if keep_heads else [],
                     seqs_ascii=aarr)


def gz_write_bytes(path: str, data: bytes, level: int = 1) -> None:
    """One-shot gzip write.  Level 1 by default: all our .gz artifacts are
    pipeline interchange compared/consumed on DECOMPRESSED bytes, so the
    container level is a pure speed knob (level 1 deflates ~4x faster than
    the default 6 for ~10% larger files)."""
    import zlib
    co = zlib.compressobj(level, zlib.DEFLATED, 31)
    with open(path, "wb") as f:
        f.write(co.compress(data))
        f.write(co.flush())


def write_fastq_gz(path: str, heads: list, seqs: list, quals: list,
                   level: int = 6) -> None:
    """Write one-line FASTQ records; the '+' separator line is bare, matching
    the reference writers (clean_lowqual.cpp:298, clean_adapter.cpp:414)."""
    out = bytearray()
    for h, s, q in zip(heads, seqs, quals):
        out += h + b"\n" + s + b"\n+\n" + q + b"\n"
    with gzip.open(path, "wb", compresslevel=level) as f:
        f.write(bytes(out))


def write_fasta_gz(path: str, heads: list, seqs: list, level: int = 6) -> None:
    out = bytearray()
    for h, s in zip(heads, seqs):
        out += h + b"\n" + s + b"\n"
    with gzip.open(path, "wb", compresslevel=level) as f:
        f.write(bytes(out))
