"""`python -m biokanga_tpu_torch` against `python -m biokanga_tpu`.

align: about 1,000 simulated reads (substitutions, Ns, a planted
five-copy repeat so that multi-hit assignment runs) are aligned by both
CLIs against the index `biokanga_tpu index` writes; the SAM files must be
byte-identical; paired ends the same (mate files and a PE-interleaved
`.rds`, with `-d/-D`, `-E` and `--peinsertdist`, whose CSV must be
byte-identical too) on pairs that need the orphan rescue; 500 bp reads
from a 2 kb repeat, whose rescue rows pass the block sort's 32,768
values, the same.  ecreads: noisy long reads, some reverse-complemented,
are corrected by both CLIs at one and two rounds, target-chunked and with
SW bands past 255; the FASTA files must be byte-identical.  The port runs with `--device cpu`,
its kernels' plain versions.  A subprocess run shows the port's CLI never
imports jax, and a scan of the sources that no module of the port, and
not chip_smoke.py, profile_torch.py or the port's probe, SASS, bench and
multi-host scripts, imports jax or the JAX package.  The port's
subcommands are the JAX CLI's but `eccontigs`.  The dispatch: `-v`,
and `-q DB` on the subcommands without their own (the JAX CLI's row),
while `index` and `align` keep theirs; `cuda` without a card raises
for `align`, `filter -c` and `ngsqc -c`.
"""
import ast
import functools
import json
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
from biokanga_tpu.seq.rds import write_rds
from biokanga_tpu.sim.simreads import random_genome, simulate_reads
from biokanga_tpu_torch.cli import main as torch_main
from cli_parity import assert_same_outputs, sqlite_rows

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
    # filter -c and ngsqc -c screen vectors with the aligner on --device
    write_fasta(str(d / "contam.fa"),
                [("adp@3", np.array([0, 2, 0, 3, 1, 2, 2] * 3, np.int8)),
                 ("vec&12", random_genome([("v", 400)], seed=3)[0][1])])
    for argv in (["filter", "-i", str(d / "reads.fq"), "-o",
                  str(d / "x.fq")],
                 ["ngsqc", "-i", str(d / "reads.fq"), "-o",
                  str(d / "x.html")]):
        for device in ([], ["--device", "cuda"]):
            with pytest.raises(RuntimeError, match="is_available"):
                torch_main(argv + ["-c", str(d / "contam.fa")] + device)
    assert not (d / "x.fq").exists() and not (d / "x.html").exists()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """300 pairs of 2 x 100 bp at 1% substitutions from a genome with a
    300 bp block in three copies and an N run; in every seventh pair one
    mate lies in the block (multi-hit: an orphan for the rescue) and in
    every eleventh one mate has a substitution in every seed core."""
    d = tmp_path_factory.mktemp("torch_cli_pe")
    seqs = random_genome([("chr1", 60_000), ("chr2", 35_000)], seed=29)
    g = seqs[0][1]
    block = g[8_000:8_300].copy()
    g[40_000:40_300] = block
    seqs[1][1][17_000:17_300] = block
    seqs[1][1][25_000:25_040] = 4
    write_fasta(str(d / "ref.fa"), seqs)
    assert jax_main(["index", "-i", str(d / "ref.fa"), "-o",
                     str(d / "ref.npz"), "--lut-bases", "9"]) == 0
    n = 300
    names, reads, _ = simulate_reads(seqs, n, read_len=100, sub_rate=0.01,
                                     seed=6, pe=True, insert_min=200,
                                     insert_max=500)
    rc = lambda x: np.where(x >= 4, x, 3 - x)[::-1]
    for i in range(0, n, 7):
        s = (8_000, 40_000)[i % 2] + 30 + i % 50
        reads[2 * i] = g[s:s + 100]
        reads[2 * i + 1] = rc(g[s + 320:s + 420])
    for i in range(3, n, 11):
        r = reads[2 * i + i % 2]
        r[4:93:11] = (r[4:93:11] + 1) % 4
    for i in range(5, n, 40):                    # ragged lengths, Ns
        reads[2 * i, 50:53] = 4
    write_fastq(str(d / "r1.fq"), ((nm, r, None) for nm, r in
                                   zip(names[0::2], reads[0::2])))
    write_fastq(str(d / "r2.fq"), ((nm, r, None) for nm, r in
                                   zip(names[1::2], reads[1::2])))
    write_rds(str(d / "pe.rds.npz"), zip(names, reads), pe_interleaved=True)
    return d


@pytest.mark.parametrize("case,opts", [
    ("insert-range", ["-d", "100", "-D", "600", "--batch-size", "128"]),
    ("same-strand", ["-E", "-D", "600"]),
    ("insert-dist", ["-d", "150", "-D", "450", "--peinsertdist", "ins.csv",
                     "-s", "8"]),
    ("rds", ["-D", "600", "--batch-size", "256"]),
])
def test_pe_sam_is_byte_identical_to_jax_cli(pairs, case, opts):
    d = pairs
    if case == "rds":
        common = ["-i", str(d / "pe.rds.npz")]
    else:
        common = ["-i", str(d / "r1.fq"), "-u", str(d / "r2.fq")]
    common += ["-I", str(d / "ref.npz")]
    outs = {}
    for who, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        o = [str(d / f"{who}_{x}") if x == "ins.csv" else x for x in opts]
        assert main(["align", "-o", str(d / f"{who}.sam")] + common + o
                    + extra) == 0
        outs[who] = (d / f"{who}.sam").read_bytes()
    assert outs["torch"] == outs["jax"]
    records = [ln.split("\t") for ln in outs["jax"].decode().splitlines()
               if not ln.startswith("@")]
    assert len(records) == 600
    n_proper = sum(int(r[1]) & 2 > 0 for r in records)
    if case == "same-strand":
        assert n_proper < 40
    else:
        assert n_proper > 400
        # a mate from the three-copy block is placed by the rescue
        assert int(records[0][1]) & 2 and records[0][4] == "60"
    if case == "insert-dist":
        want = (d / "jax_ins.csv").read_bytes()
        assert (d / "torch_ins.csv").read_bytes() == want
        assert b'"InsertBin","Count"' in want


@pytest.fixture(scope="module")
def other_indexes(inputs):
    """A bisulfite and a colorspace index of the same genome, built by the
    JAX CLI."""
    d = inputs
    for name, opts in (("bs", ["-m", "1"]), ("cs", ["-C"])):
        assert jax_main(["index", "-i", str(d / "ref.fa"), "-o",
                         str(d / f"{name}.npz"), "--lut-bases", "9"]
                        + opts) == 0
    return d


@pytest.mark.parametrize("case", ["bisulfite", "colorspace",
                                  "index -m 1", "index -C"])
def test_what_stays_outside_the_slice_is_refused(other_indexes, case):
    """Bisulfite and colorspace indexes, once refused with exit code 2, are
    ported: `align` against such an index file, with SE options its
    branch ignores, and `index -m 1` / `-C` give the JAX CLI's files
    (the SAM byte for byte; the index arrays and meta but created_unix).
    The colorspace branch reads `-i` as .csfasta, so this FASTQ gives
    both CLIs a SAM of no records.  tests/test_torch_bisulfite.py and
    tests/test_torch_colorspace.py hold both modes on their own reads."""
    d = other_indexes
    idx = {"bisulfite": "bs", "colorspace": "cs"}
    if case in idx:
        argv = ["align", "-i", str(d / "reads.fq"), "-I",
                str(d / f"{idx[case]}.npz"), "-O", str(d / "x.csv"), "-a",
                "5"]
        assert jax_main(argv + ["-o", str(d / "x_jax.sam")]) == 0
        assert torch_main(argv + ["-o", str(d / "x_torch.sam"), "--device",
                                  "cpu"]) == 0
        want = (d / "x_jax.sam").read_bytes()
        assert (d / "x_torch.sam").read_bytes() == want
        assert (case == "colorspace") == (want == b"")
        return
    flag = {"index -m 1": ["-m", "1"], "index -C": ["-C"]}[case]
    for main, tag in ((jax_main, "jax"), (torch_main, "torch")):
        assert main(["index", "-i", str(d / "ref.fa"), "-o",
                     str(d / f"x_{tag}.npz"), "--lut-bases", "9"] + flag) == 0
    with np.load(d / "x_jax.npz") as za, np.load(d / "x_torch.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            if k == "meta":
                ma, mb = (json.loads(z[k].tobytes().decode())
                          for z in (za, zb))
                assert ma.pop("created_unix") and mb.pop("created_unix")
                assert ma == mb
            else:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_cuda_is_never_replaced_by_the_cpu_with_the_se_options(inputs,
                                                               monkeypatch):
    d = inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        torch_main(["align", "-i", str(d / "reads.fq"), "-I",
                    str(d / "ref.npz"), "-o", str(d / "x.bam"),
                    "-O", str(d / "x.csv"), "--snpvcf", str(d / "x.vcf"),
                    "-a", "10", "-A", "50000", "-C", "50", "-k", "2",
                    "--stats", str(d / "x_stats.csv"), "--checkpoint-dir",
                    str(d / "x_ck")])
    assert not (d / "x_ck").exists()


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


@pytest.mark.parametrize("band", [256, 320])
def test_ecreads_wide_band_is_byte_identical_to_jax_cli(long_reads, band,
                                                        monkeypatch):
    """Bands past the one-warp SW path (W > 255), as CLR users with
    indel-heavy reads set them."""
    monkeypatch.setattr(jax_ec, "ECParams", functools.partial(
        jax_ec.ECParams, sw_chunk_bytes=1 << 23))
    d = long_reads
    common = ["-i", str(d / "pb.fa"), "--rounds", "1", "--sw-band",
              str(band)]
    assert jax_main(["ecreads", "-o", str(d / "jax.fa")] + common) == 0
    assert torch_main(["ecreads", "-o", str(d / "torch.fa"), "--device",
                       "cpu"] + common) == 0
    want = (d / "jax.fa").read_bytes()
    assert (d / "torch.fa").read_bytes() == want
    assert want.count(b">") == 10 and want != (d / "pb.fa").read_bytes()


def test_align_500bp_reads_past_the_block_sort(tmp_path, monkeypatch):
    """Reads of 500 bp from a 2 kb block in 60 copies reach rescue step
    2, whose dedup rows (40 cores x 1,024 positions) pass the block sort's
    32,768 values; the SAM must equal the JAX CLI's."""
    from biokanga_tpu_torch.align import pipeline

    d = tmp_path
    rng = np.random.default_rng(3)
    L, glen = 500, 150_000
    seqs = random_genome([("chr1", glen)], seed=11)
    g = seqs[0][1]
    block = g[1_000:3_000].copy()
    for c in range(60):
        g[5_000 + 2_100 * c: 7_000 + 2_100 * c] = block
    write_fasta(str(d / "ref.fa"), seqs)
    assert jax_main(["index", "-i", str(d / "ref.fa"), "-o",
                     str(d / "ref.npz"), "--lut-bases", "9"]) == 0
    reads = []
    for i in range(8):
        s = (1_000 + int(rng.integers(0, 2_000 - L)) if i % 2 == 0
             else int(rng.integers(0, glen - L)))
        r = g[s:s + L].copy()
        sub = rng.random(L) < 0.03
        r[sub] = (r[sub] + 1 + rng.integers(0, 3, int(sub.sum()))) % 4
        reads.append(r)
    write_fastq(str(d / "reads.fq"),
                ((f"r{i}", r, None) for i, r in enumerate(reads)))
    widths = []
    sort_rows = pipeline.sort_rows
    monkeypatch.setattr(pipeline, "sort_rows", lambda x: (
        widths.append(x.shape[1]), sort_rows(x))[1])
    common = ["-i", str(d / "reads.fq"), "-I", str(d / "ref.npz")]
    assert jax_main(["align", "-o", str(d / "jax.sam")] + common) == 0
    assert torch_main(["align", "-o", str(d / "torch.sam"), "--device",
                       "cpu"] + common) == 0
    assert max(widths) > 32_768
    want = (d / "jax.sam").read_bytes()
    assert (d / "torch.sam").read_bytes() == want
    records = [ln.split("\t") for ln in want.decode().splitlines()
               if not ln.startswith("@")]
    assert len(records) >= 8 and any(r[5] == "500M" for r in records)


def test_ecreads_refuses_checkpoints(long_reads):
    """`ecreads --checkpoint-dir` is no longer refused: it runs one round
    in resumable groups and writes the FASTA of `--rounds 1`, also when
    it resumes from its checkpoints (tests/test_torch_pbfilter.py holds
    it against the JAX package)."""
    d = long_reads
    argv = ["ecreads", "-i", str(d / "pb.fa"), "--device", "cpu"]
    assert torch_main(argv + ["-o", str(d / "r1.fa"), "--rounds", "1"]) == 0
    for out in ("ck1.fa", "ck2.fa"):
        assert torch_main(argv + ["-o", str(d / out), "--checkpoint-dir",
                                  str(d / "ck")]) == 0
        assert (d / out).read_bytes() == (d / "r1.fa").read_bytes()


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_neither_jax_nor_the_jax_package():
    root = pathlib.Path(ROOT)
    files = sorted((root / "biokanga_tpu_torch").rglob("*.py"))
    files += [root / "chip_smoke.py", root / "profile_torch.py",
              root / "scripts" / "probe_stream_gather_torch.py",
              root / "scripts" / "sass_sw_torch.py",
              root / "scripts" / "bench_sw_torch.py",
              root / "scripts" / "bench_sort_torch.py",
              root / "scripts" / "bench_extend_torch.py",
              root / "scripts" / "bench_tools_torch.py",
              root / "scripts" / "multihost_dryrun_torch.py",
              root / "tests" / "bs_reads.py",
              root / "tests" / "win_edge_cases.py",
              root / "tests" / "readprep_reads.py",
              root / "tests" / "chromatin_inputs.py",
              root / "tests" / "chunk_merge_cases.py"]
    assert len(files) > 30
    bad = [(str(f.relative_to(root)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "biokanga_tpu")]
    assert not bad, bad


def test_version_flag(capsys):
    for flag in ("-v", "--version"):
        assert jax_main([flag]) == 0
        want = capsys.readouterr().out
        assert torch_main([flag]) == 0
        assert capsys.readouterr().out == want == "0.1.0\n"
    assert torch_main([]) == 0
    listed = capsys.readouterr().out.split("subcommands: ")[1].split(", ")
    assert len(listed) == 108


def test_port_has_every_jax_subcommand_but_eccontigs():
    """A subcommand added to one CLI and not the other fails here;
    `eccontigs` stays out while the JAX CLI's own version raises."""
    from biokanga_tpu.cli import SUBCOMMANDS as jax_subcommands
    from biokanga_tpu_torch.cli import SUBCOMMANDS

    assert set(SUBCOMMANDS) == set(jax_subcommands) - {"eccontigs"}


@pytest.mark.parametrize("case", ["kangarg", "uhamming", "filter",
                                  "fasta2nxx", "argparse-error"])
def test_dispatch_logs_the_jax_cli_sumrslts_row(inputs, tmp_path, capsys,
                                                monkeypatch, case):
    """`-q DB` (or `--sumrslts=DB`) anywhere in a subcommand's argv, for
    every subcommand but index and align: the row of the JAX CLI's
    dispatch, outside the time fields; the port's row differs only by the
    `--device cpu` its device commands are given."""
    d = inputs
    fa = str(d / "ref.fa")
    argv, device = {
        "kangarg": (["kangarg", "-i", fa, "-q", "run.db", "-o", "o.fa",
                     "-k", "3"], False),
        "uhamming": (["uhamming", "-i", str(d / "small.fa"), "-o",
                      "o.hmg.npz", "-K", "24", "--sumrslts=run.db"], True),
        "filter": (["filter", "-q", "run.db", "-i", str(d / "reads.fq"),
                    "-o", "o.fq", "-c", str(d / "qc_contam.fa")], True),
        "fasta2nxx": (["fasta2nxx", "-i", fa, "-q", "run.db"], False),
        "argparse-error": (["xfasta", "-i", fa, "-q", "run.db"], False),
    }[case]
    if case == "uhamming":
        write_fasta(str(d / "small.fa"),
                    random_genome([("u", 1_500)], seed=4))
    if case == "filter":
        write_fasta(str(d / "qc_contam.fa"),
                    [("vec&1", random_genome([("v", 300)], seed=5)[0][1])])
    extra = ["--device", "cpu"] if device else []
    outs = {}
    for who, main, more in (("jax", jax_main, []),
                            ("torch", torch_main, extra)):
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        capsys.readouterr()
        if case == "argparse-error":      # -o missing: rc 1 is logged
            with pytest.raises(SystemExit):
                main(argv + more)
        else:
            assert main(argv + more) == 0
        outs[who] = capsys.readouterr().out
    assert outs["jax"] == outs["torch"]
    rows = {who: sqlite_rows(tmp_path / who / "run.db")
            for who in ("jax", "torch")}
    cols, params = rows["torch"]["TblParameters"]
    k = cols.index("ParamValue")
    rows["torch"]["TblParameters"] = (cols, [
        r[:k] + (r[k].replace(" --device cpu", ""),) + r[k + 1:]
        for r in params])
    assert rows["torch"] == rows["jax"]
    assert rows["jax"]["TblProcesses"][1][0][2] == argv[0]
    results = dict(r[3:5] for r in rows["jax"]["TblResults"][1])
    assert results["result_code"] == (
        "1" if case == "argparse-error" else "0")
    if case not in ("argparse-error", "fasta2nxx"):      # fasta2nxx: stdout
        for who in ("jax", "torch"):
            (tmp_path / who / "run.db").unlink()
        assert_same_outputs(tmp_path / "jax", tmp_path / "torch")


def test_index_and_align_keep_their_own_sumrslts(inputs, tmp_path):
    """The dispatch leaves -q to index and align, whose rows hold their
    own parameters and results (tests/test_torch_index.py and
    test_torch_align_options.py hold those rows against the JAX CLI)."""
    from biokanga_tpu_torch.cli import _OWN_SUMRSLTS

    assert _OWN_SUMRSLTS == {"index", "align"}
    d = inputs
    db = tmp_path / "run.db"
    assert torch_main(["index", "-i", str(d / "ref.fa"), "-o",
                       str(tmp_path / "i.npz"), "--lut-bases", "8", "-q",
                       str(db)]) == 0
    assert torch_main(["align", "-i", str(d / "reads.fq"), "-I",
                       str(d / "ref.npz"), "-o", str(tmp_path / "a.sam"),
                       "--device", "cpu", "-q", str(db)]) == 0
    rows = sqlite_rows(db)
    assert [r[2] for r in rows["TblProcesses"][1]] == ["index", "align"]
    names = {r[3] for r in rows["TblParameters"][1]}
    assert "argv" not in names
    assert "total_bp" in {r[3] for r in rows["TblResults"][1]}
