"""Fuzz harness: recover the reference binary's std::sort tie permutation.

link_scaffold with an empty link file turns every contig into a singleton
scaffold; records enter its LenAndSeq vector in contig-id order (our chosen
order) and leave sorted by length desc with the binary's ACTUAL unstable tie
behavior. pos.tab maps output rank -> input contig, giving the ground-truth
permutation to compare against native.gcc44_sort_perm_desc.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dbg_assembly import native  # noqa: E402

REF = "/root/reference/link_scaffold/link_scaffold"


def oracle_perm(lens):
    """Run the reference binary on singleton contigs with these lengths."""
    d = tempfile.mkdtemp(prefix="sortfuzz")
    fa = os.path.join(d, "c.fa")
    with open(fa, "w") as f:
        for i, ln in enumerate(lens):
            # contig ids 1,3,5,... ; sequence of length ln
            f.write(f">ctg_{2*i+1}\n" + "A" * 3 + "C" * (ln - 3) + "\n")
    lib = os.path.join(d, "empty.lib")
    twoctg = os.path.join(d, "e.2ctg")
    with open(twoctg, "w") as f:
        f.write("#header\n")
    with open(lib, "w") as f:
        f.write(twoctg + "\n")
    prefix = os.path.join(d, "o")
    r = subprocess.run([REF, "-i", "100", "-n", "1", "-o", prefix, fa, lib],
                       capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr[-500:]
    perm = []
    with open(prefix + ".insert100.scaffold.pos.tab") as f:
        for line in f:
            if line.startswith("\t") and "ctg_" in line:
                cid = int(line.split()[0].split("_")[1])
                perm.append((cid - 1) // 2)
    return perm


def main():
    rng = np.random.default_rng(0)
    for trial in range(200):
        n = int(rng.integers(2, 120))
        # many duplicates to stress tie handling
        vals = rng.integers(10, 10 + max(n // 3, 2), size=n) * 7 + 10
        lens = vals.astype(np.uint64)
        ref = oracle_perm([int(x) for x in lens])
        mine = native.gcc44_sort_perm_desc(lens).tolist()
        if ref != mine:
            print(f"MISMATCH trial={trial} n={n}")
            print("lens:", lens.tolist())
            print("ref :", ref)
            print("mine:", mine)
            return 1
        if trial % 20 == 0:
            print(f"trial {trial} ok (n={n})")
    print("all trials match")
    return 0


if __name__ == "__main__":
    sys.exit(main())
