""".cz / .cz.len k-mer frequency table interchange format.

The external `kmerfreq` tool (sister repo, absent from the reference) writes a
dense array over all 4^k k-mer indices, zlib-compressed in fixed-size source
blocks, plus a text file listing each compressed block's byte size.  The
format is fully specified by its consumers in the reference:

  * 1-byte-per-kmer variant: source blocks of 8 MiB bytes
    (correct_error/main.cpp:48,190-215).
  * 1-bit-per-kmer variant: source blocks of 8M k-mers = 1 MiB bytes
    (main_parallel_senior.cpp:71,285-295); a set bit means frequency above the
    low-freq cutoff, stored at the canonical k-mer index only — consumers OR
    in the reverse-complement bits afterwards
    (main_parallel_senior.cpp:310-329).

Both writers and readers are provided so the device k-mer counter can feed the
reference `correct_error_reads` binary directly (golden validation path).
"""

from __future__ import annotations

import zlib

import numpy as np

SRC_BLOCK_KMERS = 8 * 1024 * 1024      # 8M k-mers per compression block


def write_cz_bits(path: str, bitmap: np.ndarray, level: int = 1) -> None:
    """Write a 1-bit-per-kmer table.  bitmap: uint8 array of 4^k/8 bytes,
    bit (7 - idx%8) of byte idx/8 set iff k-mer idx is high-frequency
    (bit order parity: correct_error/seqKmer.cpp:34 bitAll)."""
    block_bytes = SRC_BLOCK_KMERS // 8
    sizes = []
    with open(path, "wb") as f:
        for off in range(0, len(bitmap), block_bytes):
            comp = zlib.compress(bitmap[off:off + block_bytes].tobytes(), level)
            f.write(comp)
            sizes.append(len(comp))
    with open(path + ".len", "w") as f:
        for s in sizes:
            f.write(f"{s}\n")


def read_cz_bits(path: str, ksize: int) -> np.ndarray:
    total = 1 << (2 * ksize)
    bitmap = np.zeros(total // 8, dtype=np.uint8)
    block_bytes = SRC_BLOCK_KMERS // 8
    with open(path + ".len") as f:
        sizes = [int(x) for x in f.read().split()]
    off = 0
    with open(path, "rb") as f:
        for s in sizes:
            raw = zlib.decompress(f.read(s))
            bitmap[off:off + len(raw)] = np.frombuffer(raw, dtype=np.uint8)
            off += block_bytes
    return bitmap


def write_cz_bytes(path: str, freqs: np.ndarray, level: int = 1) -> None:
    """Write an 8-bit-per-kmer table (freq saturated to 255), blocks of 8 MiB
    source bytes (parity correct_error/main.cpp:48,190-194)."""
    block_bytes = SRC_BLOCK_KMERS
    sizes = []
    with open(path, "wb") as f:
        for off in range(0, len(freqs), block_bytes):
            comp = zlib.compress(freqs[off:off + block_bytes].tobytes(), level)
            f.write(comp)
            sizes.append(len(comp))
    with open(path + ".len", "w") as f:
        for s in sizes:
            f.write(f"{s}\n")


def read_cz_bytes(path: str, ksize: int) -> np.ndarray:
    total = 1 << (2 * ksize)
    freqs = np.zeros(total, dtype=np.uint8)
    with open(path + ".len") as f:
        sizes = [int(x) for x in f.read().split()]
    off = 0
    with open(path, "rb") as f:
        for s in sizes:
            raw = zlib.decompress(f.read(s))
            freqs[off:off + len(raw)] = np.frombuffer(raw, dtype=np.uint8)
            off += SRC_BLOCK_KMERS
    return freqs
