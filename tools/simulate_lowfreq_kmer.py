"""Shim: the implementation moved to dbg_assembly.utils.simulate_lowfreq
so the CLI can surface it (reference ships it as an invocable tool,
correct_error/simulate_lowfreq_kmer.cpp)."""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from dbg_assembly.utils.simulate_lowfreq import (  # noqa: F401,E402
    read_fasta_seqs, run)

if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("-k", type=int, default=17)
    ap.add_argument("-s", type=int, default=100)
    ap.add_argument("genome")
    a = ap.parse_args()
    run(a.genome, a.k, a.s)
