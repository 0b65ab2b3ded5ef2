"""CPU checks of the GPU bring-up harness (chip_smoke.py), the --platform
switch and the compile-cache location.  The GPU run itself is
`python chip_smoke.py` on a machine with a card."""

import gzip
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(extra)
    return env


def test_smoke_refuses_cpu_backend():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=_env(JAX_PLATFORMS="cpu"), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def _tree(root):
    """A small work tree with the artifact kinds the smoke compares."""
    os.makedirs(os.path.join(root, "02.contig"))
    with gzip.open(os.path.join(root, "reads.correct.fa.gz"), "wb") as f:
        f.write(b">r1\nACGTACGT\n>r2\nTTGCA\n")
    with open(os.path.join(root, "02.contig", "asm.contig.seq.fa"),
              "wb") as f:
        f.write(b">1 length 9\nACGTTGCAA\n")
    with open(os.path.join(root, "clean_reads.lib"), "w") as f:
        f.write(os.path.join(root, "reads.fq.gz") + "\n")


def _flip_gz_byte(root):
    path = os.path.join(root, "reads.correct.fa.gz")
    data = bytearray(gzip.open(path).read())
    data[5] ^= 1
    with gzip.open(path, "wb") as f:
        f.write(bytes(data))


def _drop_contigs(root):
    os.unlink(os.path.join(root, "02.contig", "asm.contig.seq.fa"))


@pytest.mark.parametrize("change,bad_file", [
    (None, None),
    (_flip_gz_byte, "reads.correct.fa.gz"),
    (_drop_contigs, "02.contig/asm.contig.seq.fa"),
], ids=["identical", "gz-byte", "missing"])
def test_compare_trees(tmp_path, capsys, change, bad_file):
    import chip_smoke
    ref, got = str(tmp_path / "cpu"), str(tmp_path / "device")
    _tree(ref)
    _tree(got)     # its .lib names its own directory: masked, not a diff
    if change is not None:
        change(got)
    if bad_file is None:
        chip_smoke.compare_trees(ref, got)
        assert "all 3 artifacts byte-identical" in capsys.readouterr().out
        return
    with pytest.raises(SystemExit) as e:
        chip_smoke.compare_trees(ref, got)
    assert bad_file in str(e.value)
    out = capsys.readouterr().out
    assert "match clean_reads.lib" in out
    assert any(line.startswith(("DIFF", "MISSING")) and bad_file in line
               for line in out.splitlines())


def test_platform_gpu_without_gpu_fails():
    r = subprocess.run([sys.executable, "-m", "dbg_assembly", "--platform",
                        "gpu", "fasta_len", "missing.fa"], cwd=ROOT,
                       env=_env(JAX_PLATFORMS="cpu"), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert "no gpu backend" in r.stderr


_COMPILE = (
    "import jax, dbg_assembly\n"
    "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
    "jax.jit(lambda x: x * 3 + 1)(jax.numpy.arange(7)).block_until_ready()\n"
    "print(jax.config.jax_compilation_cache_dir)\n")


@pytest.mark.parametrize("from_env", [True, False], ids=["env", "default"])
def test_compile_cache_location(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is the
    checkout's .jax_cache/."""
    want = (str(tmp_path / "cache") if from_env
            else os.path.join(ROOT, ".jax_cache"))
    env = _env(JAX_PLATFORMS="cpu")
    if from_env:
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run([sys.executable, "-c", _COMPILE], cwd=str(tmp_path),
                       env=dict(env, PYTHONPATH=ROOT), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == want
    assert os.listdir(want)


def test_pipeline_cli_reports_stages(tmp_path, capsys):
    """`pipeline` prints one JSON line with every stage's wall time and the
    correction engine's host-fallback count (what chip_smoke reads)."""
    import json
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import golden
    from dbg_assembly import cli

    ds = golden.sim_dataset()
    (p1, p2, ins) = ds["libs"][0]
    libs = []
    for p in (p1, p2):
        libs.append(str(tmp_path / os.path.basename(p)))
        shutil.copyfile(p, libs[-1])
    assert cli.main(["pipeline", "-k", "13", "-w", str(tmp_path / "w"),
                     f"{libs[0]},{libs[1]},{ins}"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out["seconds"]) == {"clean", "kmerfreq", "correct", "contig",
                                   "scaffold"}
    assert out["correct_engine"] == "native"
    assert out["correct_reads"] > 0
    assert out["correct_host_fallback"] == 0
    assert os.path.exists(out["scaffolds"])


def test_pipeline_mesh_matches_doubling(tmp_path, capsys):
    """`pipeline --mesh 2` (what `chip_smoke.py --mesh N` runs on the cards)
    writes the same bytes as `pipeline --readout doubling`, its reference,
    here on two virtual CPU devices."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import golden
    import chip_smoke
    from dbg_assembly import cli

    ds = golden.sim_dataset()
    (p1, p2, ins) = ds["libs"][0]
    reads = tmp_path / "reads"
    reads.mkdir()
    libs = []
    for p in (p1, p2):
        libs.append(str(reads / os.path.basename(p)))
        shutil.copyfile(p, libs[-1])
    spec = f"{libs[0]},{libs[1]},{ins}"
    for work, extra in (("ref", ["--readout", "doubling"]),
                        ("mesh", ["--mesh", "2"])):
        assert cli.main(["pipeline", "-k", "13", "-w", str(tmp_path / work),
                         *extra, spec]) == 0
    chip_smoke.compare_trees(str(tmp_path / "ref"), str(tmp_path / "mesh"))
    assert "byte-identical" in capsys.readouterr().out
