"""dbg_assembly — accelerator de Bruijn graph genome assembly engine.

A from-scratch JAX/XLA re-design of the classic C++ pipeline
fanagislab/DBG_assembly:

    raw FASTQ --clean.lowqual--> trimmed FASTQ --clean.adapter--> clean FASTQ
      --kmer.count--> k-mer frequency table (.cz/.cz.len)
      --correct--> corrected one-line FASTA (.correct.fa.gz)
      --contig--> contigs (.contig.seq.fa + .seq.depth + tip/bubble/lowedge/kmer.freq)
      --scaffold.map_pair--> read-pair->contig alignments (.map_pair.2ctg.gz)
      --scaffold.link--> scaffolds (.scaffold.seq.fa + .pos.tab)

Design stance (see SURVEY.md section 7): same five stage boundaries and file
formats as the reference for bit-exact validation, completely different
internals — fixed-shape 2-bit-coded read tensors, prefix-sharded k-mer tables,
sort/segment-reduce instead of hash-CAS, pointer-doubling instead of serial
walks.  The host-side sequential tails (order-exact graph pruning + readout)
run in native C++ (native/), mirroring the reference's emergent hash-slot
ordering so contig FASTA bytes match the reference binaries exactly.

64-bit integers are required for k<=31 k-mer codes (2k bits <= 62), so x64 is
enabled package-wide before any JAX arrays are created.

Compiled programs persist in JAX's compilation cache: the directory named by
JAX_COMPILATION_CACHE_DIR when that is set (JAX reads it itself), otherwise
a fixed .jax_cache/ at the checkout root, so repeated runs from one checkout
skip recompiling.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache"))


def _raise_mmap_threshold():
    """Keep large malloc blocks on the heap so freed pages are reused.

    glibc mmap()s allocations above ~128 KiB and returns them to the OS on
    free; every fresh multi-MB numpy array then pays first-touch page
    faults (~12 us/page on virtualized hosts — measured 1.7 s to touch a
    fresh 400 MB buffer vs 0.1 s reused).  The host pipelines allocate
    large batch arrays cyclically, so raising M_MMAP_THRESHOLD is worth
    ~2x on the whole host tail.  Linux/glibc only; silently skipped
    elsewhere."""
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6")
        M_MMAP_THRESHOLD = -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
    except Exception:
        pass


_raise_mmap_threshold()

__version__ = "0.1.0"
