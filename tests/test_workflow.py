"""Smoke test of the L5 orchestration driver (full pipeline, small data),
parametrized over the contig readout: "exact" (byte-parity assembler) and
"doubling" (the scalable pointer-doubling assembler), so the scalable path
is exercised by L5, not only by its own fixtures."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import golden  # noqa: E402

_contig_sets = {}


def _canon_contig_set(path):
    comp = bytes.maketrans(b"ACGTN", b"TGCAN")
    out = []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith(">"):
            continue
        s = line.encode()
        rc = s.translate(comp)[::-1]
        out.append(min(s, rc))
    return sorted(out)


_MODES = ["exact", "doubling"]
if os.environ.get("DBG_SLOW_TESTS") == "1":
    _MODES.append("mesh")      # distributed correction+contig stages


@pytest.mark.parametrize("readout", _MODES)
def test_run_full_pipeline(tmp_path, readout):
    from dbg_assembly.workflow import PipelineConfig, run_full
    from dbg_assembly.utils import nstat

    ds = golden.sim_dataset()
    raw_libs = [(p1, p2, ins) for p1, p2, ins in ds["libs"]]
    cfg = PipelineConfig(correct_k=13, init_hash_size=0.01,
                         map_min_read=100,
                         readout="doubling" if readout == "mesh" else readout,
                         mesh_devices=8 if readout == "mesh" else 0)
    out = run_full(raw_libs, cfg, str(tmp_path / "work"))
    assert os.path.exists(out["contigs"])
    assert os.path.exists(out["scaffolds"])
    # sanity: scaffolds assemble most of the 200kb genome
    lens = [ln for _, ln in nstat.fasta_lengths(out["scaffolds"])]
    assert sum(lens) > 150_000
    assert max(lens) > 5_000
    # the two readouts must emit the same contig multiset (canonicalized:
    # output order/strand are hash-iteration artifacts, pointer_doubling.py
    # module docstring)
    _contig_sets[readout] = _canon_contig_set(out["contigs"])
    if "exact" in _contig_sets and "doubling" in _contig_sets:
        assert _contig_sets["exact"] == _contig_sets["doubling"]
    if "mesh" in _contig_sets and "exact" in _contig_sets:
        assert _contig_sets["mesh"] == _contig_sets["exact"]
