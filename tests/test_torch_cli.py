"""`python -m biokanga_tpu_torch` against `python -m biokanga_tpu`.

align: about 1,000 simulated reads (substitutions, Ns, a planted
five-copy repeat so that multi-hit assignment runs) are aligned by both
CLIs against the index `biokanga_tpu index` writes; the SAM files must be
byte-identical.  ecreads: noisy long reads, some reverse-complemented,
are corrected by both CLIs at one and two rounds and target-chunked; the
FASTA files must be byte-identical.  The port runs with `--device cpu`,
its kernels' plain versions.  A subprocess run shows the port's CLI never
imports jax, and a scan of the sources that no module of the port, and
not chip_smoke.py, imports jax or the JAX package.
"""
import ast
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from biokanga_tpu.cli import main as jax_main
from biokanga_tpu.pacbio import ecreads as jax_ec
from biokanga_tpu.seq.fasta import write_fasta, write_fastq
from biokanga_tpu.sim.simreads import random_genome, simulate_reads
from biokanga_tpu_torch.cli import main as torch_main

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(7)
    seqs = random_genome([("chr1", 70_000), ("chr2", 40_000)], seed=17)
    block = seqs[0][1][2_000:2_400].copy()
    for dst in (15_000, 50_000):
        seqs[0][1][dst:dst + 400] = block
    seqs[1][1][9_000:9_400] = block
    seqs[1][1][30_000:30_030] = 4
    write_fasta(str(d / "ref.fa"), seqs)
    assert jax_main(["index", "-i", str(d / "ref.fa"), "-o",
                     str(d / "ref.npz"), "--lut-bases", "9"]) == 0
    names, reads, _ = simulate_reads(seqs, 1_000, read_len=100,
                                     sub_rate=0.01, seed=5)
    for i in range(0, 1_000, 10):             # reads from the repeat
        s = 2_000 + rng.integers(0, 300)
        reads[i] = seqs[0][1][s:s + 100]
    for i in range(3, 1_000, 17):             # N runs
        p = rng.integers(0, 95)
        reads[i, p:p + rng.integers(1, 4)] = 4
    write_fastq(str(d / "reads.fq"),
                ((n, r, None) for n, r in zip(names, reads)))
    return d


@pytest.mark.parametrize("opts", [
    [],
    ["-Q", "sense", "-s", "5", "-e", "2", "-R", "3", "-m", "more",
     "--no-mlassign", "--batch-size", "300"],
])
def test_sam_is_byte_identical_to_jax_cli(inputs, opts):
    d = inputs
    common = ["-i", str(d / "reads.fq"), "-I", str(d / "ref.npz")] + opts
    assert jax_main(["align", "-o", str(d / "jax.sam")] + common) == 0
    assert torch_main(["align", "-o", str(d / "torch.sam"), "--device",
                       "cpu"] + common) == 0
    want = (d / "jax.sam").read_bytes()
    assert (d / "torch.sam").read_bytes() == want
    lines = want.decode().splitlines()
    records = [ln.split("\t") for ln in lines if not ln.startswith("@")]
    assert sum(r[4] == "60" for r in records) > 400
    if not opts:                  # multi-hit assignment added records
        assert any(r[4] == "3" for r in records)


def test_cli_never_imports_jax(inputs):
    d = inputs
    code = ("import sys; from biokanga_tpu_torch.cli import main; "
            "rc = main(sys.argv[1:]); "
            "assert 'jax' not in sys.modules, 'jax was imported'; "
            "raise SystemExit(rc)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-c", code, "align", "-i", str(d / "reads.fq"),
         "-I", str(d / "ref.npz"), "-o", str(d / "sub.sam"),
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert (d / "sub.sam").stat().st_size > 0


def test_cuda_is_never_replaced_by_the_cpu(inputs, monkeypatch):
    d = inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        torch_main(["align", "-i", str(d / "reads.fq"), "-I",
                    str(d / "ref.npz"), "-o", str(d / "x.sam")])


@pytest.mark.parametrize("flag", [["-u", "mates.fq"], ["-O", "snps.csv"],
                                  ["-a", "5"], ["-C", "60"]])
def test_flags_outside_the_slice_are_rejected(inputs, flag):
    d = inputs
    with pytest.raises(SystemExit) as e:
        torch_main(["align", "-i", str(d / "reads.fq"), "-I",
                    str(d / "ref.npz"), "-o", str(d / "x.sam"),
                    "--device", "cpu"] + flag)
    assert e.value.code == 2


@pytest.fixture(scope="module")
def long_reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ec_cli")
    rng = np.random.default_rng(13)
    true = random_genome([("t", 700)], seed=61)[0][1]
    reads = []
    for i in range(10):
        keep = rng.random(len(true)) > 0.02               # deletions
        r = true[keep].copy()
        sub = rng.random(len(r)) < 0.03
        r[sub] = (r[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        ins = rng.integers(0, len(r), 8)                  # insertions
        r = np.insert(r, ins, rng.integers(0, 4, 8)).astype(np.int8)
        reads.append(r[::-1].copy() if i % 4 == 3 else r)
    reads[5][100:103] = 4
    write_fasta(str(d / "pb.fa"), ((f"read{i}", r)
                                   for i, r in enumerate(reads)))
    return d


@pytest.mark.parametrize("opts", [
    ["--rounds", "1"],
    ["--rounds", "2", "--min-score", "80"],
    ["--rounds", "1", "--target-chunk", "4", "--max-targets", "6"],
])
def test_ecreads_fasta_is_byte_identical_to_jax_cli(long_reads, opts,
                                                    monkeypatch):
    # the JAX package pads each SW chunk to sw_chunk_bytes of pairs (tens
    # of thousands of pairs here), minutes in interpret mode; votes are
    # integer sums, so a smaller chunk gives the same FASTA in seconds
    monkeypatch.setattr(jax_ec, "ECParams", functools.partial(
        jax_ec.ECParams, sw_chunk_bytes=1 << 23))
    d = long_reads
    common = ["-i", str(d / "pb.fa")] + opts
    assert jax_main(["ecreads", "-o", str(d / "jax.fa")] + common) == 0
    assert torch_main(["ecreads", "-o", str(d / "torch.fa"), "--device",
                       "cpu"] + common) == 0
    want = (d / "jax.fa").read_bytes()
    assert (d / "torch.fa").read_bytes() == want
    assert want.count(b">") == 10 and want != (d / "pb.fa").read_bytes()


def test_ecreads_refuses_checkpoints(long_reads):
    with pytest.raises(SystemExit) as e:
        torch_main(["ecreads", "-i", str(long_reads / "pb.fa"), "-o",
                    str(long_reads / "x.fa"), "--checkpoint-dir",
                    str(long_reads / "ck"), "--device", "cpu"])
    assert e.value.code == 2


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_neither_jax_nor_the_jax_package():
    root = pathlib.Path(ROOT)
    files = sorted((root / "biokanga_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(root)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "biokanga_tpu")]
    assert not bad, bad
