"""`python -m biokanga_tpu_torch align` with the single-end options
against `python -m biokanga_tpu align`, on the CPU.

One read set serves every group: 1,000 reads of 100 bp against a 52 kb
two-entry genome with a planted repeat and an N run.  Most reads come
from an 8 kb window of a "sample" with a planted SNP every 300 bases
(depth ~10, so SNPs and haplotypes are called); others carry a
micro-indel or a splice junction shared by three reads
(tests/options_reads.py), a junk tail, Ns, or are PCR duplicates.  For
each option group the SAM and every side file (--stats, the SNP CSV and
VCF, the DiSNP, TriSNP and centroid CSVs, BAM and its BAI) must be
byte-identical to the JAX CLI's, and the `-q` rows equal outside their
time fields.  A checkpointed run is run twice; the second loads every
block.  Paired ends: `.bam` output and --pcrprimersubs (which widens
the PE budget and corrects nothing, as in the JAX CLI).
"""
import numpy as np
import pytest
import torch

import options_reads as opt

from biokanga_tpu.cli import main as jax_main
from biokanga_tpu.seq.fasta import write_fasta, write_fastq
from biokanga_tpu.sim.simreads import random_genome, simulate_reads
from biokanga_tpu_torch.align import pipeline as torch_pipeline
from biokanga_tpu_torch.cli import main as torch_main

torch.set_num_threads(2)

N_READS = 1_000
WINDOW = 8_000


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_align_options")
    rng = np.random.default_rng(88)
    seqs = random_genome([("chr1", 36_000), ("chr2", 16_000)], seed=21)
    block = seqs[0][1][20_000:20_300].copy()
    seqs[1][1][5_000:5_300] = block
    seqs[1][1][9_000:9_030] = 4
    write_fasta(str(d / "ref.fa"), seqs)
    assert jax_main(["index", "-i", str(d / "ref.fa"), "-o",
                     str(d / "ref.npz"), "--lut-bases", "8"]) == 0
    # SNPs every ~300 bases in the first 8 kb window of chr1
    win = [(seqs[0][0], seqs[0][1][:WINDOW].copy())]
    sample_win, snps = opt.plant_snps(win, 300, rng, margin=200)
    sample = [(seqs[0][0], seqs[0][1].copy()), seqs[1]]
    sample[0][1][:WINDOW] = sample_win[0][1]
    names, reads, _ = simulate_reads(sample_win, 780, read_len=100,
                                     sub_rate=0.002, seed=3)
    n2, r2, _ = simulate_reads(sample, N_READS - 780, read_len=100,
                               sub_rate=0.01, seed=4)
    names, reads = list(names) + list(n2), np.concatenate([reads, r2])
    events = opt.plan_events(sample, 17, 17, snps, rng, spacing=100)
    opt.alter_reads(names, reads, sample, events, rng, 0.05, 0.05, 0.02,
                    block=N_READS)
    for i in range(800, 830):             # reads from the repeat
        s = 20_000 + int(rng.integers(0, 200))
        reads[i] = seqs[0][1][s:s + 100]
        names[i] = f"rep{i}"
    for i in range(830, 860, 3):          # PCR duplicates
        reads[i + 1] = reads[i + 2] = reads[i]
    for i in range(5, N_READS, 53):       # N runs
        reads[i, 40:42] = 4
    write_fastq(str(d / "reads.fq"),
                ((n, r, None) for n, r in zip(names, reads)))
    opt.loci_constraints_csv(str(d / "constraints.csv"), seqs, rng)
    opt.priority_bed(str(d / "priority.bed"), seqs, rng)
    pn, pr, _ = simulate_reads(seqs, 150, read_len=100, sub_rate=0.03,
                               seed=6, pe=True, insert_min=200,
                               insert_max=500)
    for m in (0, 1):
        write_fastq(str(d / f"p{m + 1}.fq"),
                    ((a, b, None) for a, b in zip(pn[m::2], pr[m::2])))
    return d


SIDE_FILES = {"--stats": "stats.csv", "-O": "snps.csv",
              "--snpvcf": "snps.vcf", "--disnp": "di.csv",
              "--trisnp": "tri.csv", "--snpcentroid": "cent.csv"}


def _run_both(d, opts, out="out.sam", pe=False):
    """Run both CLIs with `opts` (side files named by SIDE_FILES, inputs
    by their file names in `d`); return {file name: (jax bytes, torch
    bytes)} for the output and every side file."""
    inputs = (["-i", str(d / "p1.fq"), "-u", str(d / "p2.fq")] if pe
              else ["-i", str(d / "reads.fq")])
    got = {}
    for who, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        argv = ["align", "-I", str(d / "ref.npz"), "-o",
                str(d / f"{who}_{out}")] + inputs + extra
        names = [out]
        it = iter(opts)
        for a in it:
            argv.append(a)
            if a in SIDE_FILES:
                argv.append(str(d / f"{who}_{SIDE_FILES[a]}"))
                names.append(SIDE_FILES[a])
            elif a in ("--lociconstraints", "-Y"):
                argv.append(str(d / next(it)))
        assert main(argv) == 0
        if out.endswith(".bam"):
            names.append(out + ".bai")
        for nm in names:
            got.setdefault(nm, []).append((d / f"{who}_{nm}").read_bytes())
    return got


def _records(sam: bytes):
    return [ln.split("\t") for ln in sam.decode().splitlines()
            if not ln.startswith("@")]


@pytest.mark.parametrize("group,opts", [
    ("trim-dedupe-stats", ["-x", "3", "-y", "2", "--min-accept-len", "90",
                           "-k", "2", "--stats"]),
    ("chimeric", ["-C", "50", "--stats"]),
    ("postpasses", ["--minflankexacts", "5", "--pcrprimersubs", "2",
                    "--lociconstraints", "constraints.csv", "-Y",
                    "priority.bed"]),
    ("snp", ["-O", "--snpvcf", "--disnp", "--trisnp", "--snpcentroid", "-p",
             "3", "-P", "0.1", "--snpnonrefpcnt", "20"]),
    ("indel-splice", ["-a", "10", "-A", "50000", "--stats"]),
])
def test_option_group_is_byte_identical_to_jax_cli(data, group, opts):
    got = _run_both(data, opts)
    for name, (want, have) in got.items():
        assert have == want, name
    recs = _records(got["out.sam"][0])
    cigars = [r[5] for r in recs if r[4] == "60"]
    if group == "chimeric":
        assert sum("S" in c for c in cigars) >= 10
    if group == "indel-splice":
        for op in "DIN":
            assert sum(op in c for c in cigars) >= 5, op
    if group == "postpasses":
        assert any("S" in c for c in cigars)          # flank trims
    if group == "snp":
        calls = got["snps.csv"][0].decode().splitlines()
        assert len(calls) > 15
        assert got["di.csv"][0].count(b"\n") > 5
        assert got["tri.csv"][0].count(b"\n") > 5
    if group == "trim-dedupe-stats":
        assert all(len(r[9]) == 95 for r in recs)
        assert b'"unique"' in got["stats.csv"][0]


def test_every_option_at_once_is_byte_identical_to_jax_cli(data):
    got = _run_both(data, [
        "-x", "3", "-y", "2", "-k", "2", "--min-accept-len", "90",
        "--minflankexacts", "5", "--pcrprimersubs", "2",
        "--lociconstraints", "constraints.csv", "-Y", "priority.bed",
        "-O", "--snpvcf", "--disnp", "--trisnp", "--snpcentroid", "-p", "3",
        "-C", "50", "-a", "10", "-A", "50000", "--stats"], out="all.bam")
    for name, (want, have) in got.items():
        assert have == want, name
    assert len(got["all.bam"][0]) > 10_000


def test_bam_output_is_byte_identical_to_jax_cli(data):
    got = _run_both(data, [], out="se.bam")
    assert sorted(got) == ["se.bam", "se.bam.bai"]
    for name, (want, have) in got.items():
        assert have == want, name
    assert not list(data.glob("*.tmp.sam"))


@pytest.mark.parametrize("case,opts", [
    ("bam", []), ("pcrprimersubs", ["--pcrprimersubs", "3", "-s", "2"])])
def test_paired_end_options_are_byte_identical_to_jax_cli(data, case, opts):
    out = "pe.bam" if case == "bam" else "pe.sam"
    got = _run_both(data, opts, out=out, pe=True)
    for name, (want, have) in got.items():
        assert have == want, name
    if case == "pcrprimersubs":
        # PE aligns with the wider budget: more pairs than at -s 2 alone
        plain = _run_both(data, ["-s", "2"], out="pe2.sam", pe=True)
        n_wide = sum(r[4] == "60" for r in _records(got["pe.sam"][0]))
        n_plain = sum(r[4] == "60" for r in _records(plain["pe2.sam"][0]))
        assert n_wide > n_plain


def test_sumrslts_rows_equal_jax(data):
    d = data
    for who, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        for run in range(2):                 # two experiments in one DB
            assert main(["align", "-i", str(d / "reads.fq"), "-I",
                         str(d / "ref.npz"), "-o", str(d / f"{who}_q.sam"),
                         "-s", str(5 + run), "-q", str(d / f"{who}.db")]
                        + extra) == 0
    rows = opt.sumrslts_rows(d / "torch.db")
    assert rows == opt.sumrslts_rows(d / "jax.db")
    assert len(rows[0]) == 2 and ("total", "1000") in [r[3:] for r in rows[3]]


def test_checkpointed_run_resumes_and_equals_jax(data, monkeypatch):
    d = data
    common = ["align", "-i", str(d / "reads.fq"), "-I", str(d / "ref.npz"),
              "-a", "10", "--batch-size", "300"]
    assert jax_main(common + ["-o", str(d / "ck_jax.sam"), "--checkpoint-dir",
                              str(d / "ck_jax")]) == 0
    port = common + ["--device", "cpu", "--checkpoint-dir",
                     str(d / "ck_torch")]
    assert torch_main(port + ["-o", str(d / "ck1.sam")]) == 0
    assert len(list((d / "ck_torch").glob("c0000_b*.npz"))) == 4

    def no_engine(*args, **kwargs):
        raise AssertionError("a checkpointed block was aligned again")

    monkeypatch.setattr(torch_pipeline.AlignEngine, "align_with_rescue",
                        no_engine)
    assert torch_main(port + ["-o", str(d / "ck2.sam")]) == 0
    want = (d / "ck_jax.sam").read_bytes()
    assert (d / "ck1.sam").read_bytes() == want
    assert (d / "ck2.sam").read_bytes() == want
