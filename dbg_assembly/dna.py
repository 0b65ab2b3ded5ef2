"""L0 sequence/k-mer primitives, vectorized for accelerators.

Reference semantics (cited for parity, re-designed as array ops):
  - 2-bit base coding A=0 C=1 G=2 T=3; parity with DBG_contig/seqKmer.cpp:9-24.
    Two alphabet variants exist in the reference:
      * k-mer modules map N (and every non-ACGT byte) -> 0, i.e. N is treated
        as A in k-mer space (DBG_contig/seqKmer.cpp:15-17,
        correct_error/seqKmer.cpp:17-19).
      * clean_adapter maps N -> 4 (clean_adapter.cpp:54-64).
  - bit-parallel reverse complement of a packed k-mer
    (DBG_contig/seqKmer.cpp:89-97).
  - canonical k-mer = min(kbit, rc_kbit); the graph builder takes fwd when
    kbit <= rc_kbit (DBGgraph.cpp:80-89), the read mapper takes fwd when
    kbit < rc_kbit (map_func.cpp:160-166).  For odd k there are no
    palindromic k-mers so the two rules agree.

Everything here works on uint8 code arrays of shape [..., L] where codes are
0..3 for ACGT and 4 for N/invalid, plus packed uint64 k-mer arrays.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# ASCII -> 2-bit code lookup tables (host-side, used when decoding bytes).
# Variant "kmer": N -> 0 (A); variant "strict": N and unknown -> 4.
_KMER_LUT = np.full(256, 0, dtype=np.uint8)      # default 0 would be wrong for
_KMER_LUT[:] = 0                                  # unknown bytes in reference:
# reference alphabet maps every non-ACGT char to 4, but positions beyond 127
# never occur in FASTQ.  k-mer variant: A=a=N=n=0.
for _ch, _v in (("A", 0), ("a", 0), ("C", 1), ("c", 1), ("G", 2), ("g", 2),
                ("T", 3), ("t", 3), ("N", 0), ("n", 0)):
    _KMER_LUT[ord(_ch)] = _v

_STRICT_LUT = np.full(256, 4, dtype=np.uint8)
for _ch, _v in (("A", 0), ("a", 0), ("C", 1), ("c", 1), ("G", 2), ("g", 2),
                ("T", 3), ("t", 3)):
    _STRICT_LUT[ord(_ch)] = _v

BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)      # code -> ASCII
C_BASES = np.frombuffer(b"TGCAN", dtype=np.uint8)    # code -> complement ASCII


def ascii_to_codes(buf: np.ndarray, strict_n: bool = False) -> np.ndarray:
    """Map ASCII bytes to 2-bit codes (uint8).  strict_n: N->4 else N->0."""
    lut = _STRICT_LUT if strict_n else _KMER_LUT
    return lut[buf]


def codes_to_ascii(codes: np.ndarray) -> np.ndarray:
    return BASES[np.minimum(codes, 4)]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array along the last axis (N=4 fixed)."""
    comp = np.where(codes < 4, 3 - codes, codes)
    return comp[..., ::-1]


# ---------------------------------------------------------------------------
# Packed k-mer ops (uint64, 2 bits/base, leftmost base in the highest bits)
# ---------------------------------------------------------------------------

_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_M8 = np.uint64(0x00FF00FF00FF00FF)
_M16 = np.uint64(0x0000FFFF0000FFFF)
_M32 = np.uint64(0x00000000FFFFFFFF)


def revcomp_kbit(kbit, ksize: int):
    """Bit-parallel reverse complement of packed k-mers.

    Works on numpy or jax uint64 arrays.  Parity:
    DBG_contig/seqKmer.cpp:89-97 (identical algorithm, vectorized).
    """
    xp = jnp if isinstance(kbit, jnp.ndarray) else np
    k = xp.asarray(kbit, dtype=xp.uint64)
    k = ~k
    k = ((k & _M2) << np.uint64(2)) | ((k & ~_M2) >> np.uint64(2))
    k = ((k & _M4) << np.uint64(4)) | ((k & ~_M4) >> np.uint64(4))
    k = ((k & _M8) << np.uint64(8)) | ((k & ~_M8) >> np.uint64(8))
    k = ((k & _M16) << np.uint64(16)) | ((k & ~_M16) >> np.uint64(16))
    k = ((k & _M32) << np.uint64(32)) | ((k & ~_M32) >> np.uint64(32))
    return k >> np.uint64(64 - (ksize << 1))


def seq2bit(codes, ksize: int | None = None):
    """Pack a code array [..., k] into uint64 k-mers (parity seqKmer.cpp:34-41).

    Codes >= 4 contribute their low 2 bits (reference behavior: alphabet value
    4 ORs 0b100 but since reference only ever packs ACGT/N->0 codes this path
    matches when inputs are pre-mapped with the kmer alphabet).
    """
    xp = jnp if isinstance(codes, jnp.ndarray) else np
    c = xp.asarray(codes, dtype=xp.uint64)
    k = c.shape[-1]
    out = xp.zeros(c.shape[:-1], dtype=xp.uint64)
    for i in range(k):
        out = (out << np.uint64(2)) | c[..., i]
    return out


def bit2seq(kbit: int, ksize: int) -> str:
    """Unpack one packed k-mer to an ACGT string (parity seqKmer.cpp:45-52)."""
    kbit = int(kbit)
    return "".join("ACGT"[(kbit >> (2 * (ksize - 1 - i))) & 3]
                   for i in range(ksize))


def rolling_kmers(codes, ksize: int):
    """All k-mers of each sequence: [..., L] codes -> [..., L-k+1] uint64.

    Vectorized replacement for the reference's per-base rolling update
    (DBGgraph.cpp:64-74): the shift-or recurrence is unrolled across the
    window dimension as k dense vector ops, which XLA fuses into a single
    bandwidth-bound pass — no sequential scan, no scalar loop.
    """
    xp = jnp if isinstance(codes, jnp.ndarray) else np
    c = xp.asarray(codes, dtype=xp.uint64)
    L = c.shape[-1]
    P = L - ksize + 1
    out = xp.zeros(c.shape[:-1] + (P,), dtype=xp.uint64)
    for i in range(ksize):
        out = (out << np.uint64(2)) | c[..., i:i + P]
    return out


def canonical(kbit, ksize: int):
    """Canonical k-mer = elementwise min(kbit, revcomp(kbit))."""
    xp = jnp if isinstance(kbit, jnp.ndarray) else np
    rc = revcomp_kbit(kbit, ksize)
    return xp.minimum(kbit, rc), rc


def next_kmer_rightward(kbit, base, ksize: int):
    """(kbit << 2 | base) & mask — parity contig.h:127-130."""
    mask = np.uint64((1 << (2 * ksize)) - 1)
    xp = jnp if isinstance(kbit, jnp.ndarray) else np
    return ((xp.asarray(kbit, xp.uint64) << np.uint64(2))
            | xp.asarray(base, xp.uint64)) & mask


def next_kmer_leftward(kbit, base, ksize: int):
    """(kbit >> 2) + (base << 2(k-1)) — parity contig.h:119-123."""
    xp = jnp if isinstance(kbit, jnp.ndarray) else np
    return ((xp.asarray(kbit, xp.uint64) >> np.uint64(2))
            + (xp.asarray(base, xp.uint64) << np.uint64(2 * (ksize - 1))))
