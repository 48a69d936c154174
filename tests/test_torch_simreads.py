"""The port's simulators against the JAX package, byte for byte through
both CLIs: `simreads` with every flag (single and paired ends, FASTA,
FASTQ and colorspace output, -H min-Hamming descriptors, planted SNPs
and their BED, indels, every error mode with uniform and spatial
placement, random reads), `rnafragsim`, `usimdiffexpr` and `kangarg`;
and `repeat_genome`, which has no subcommand.  Seeds fix every draw."""
import numpy as np
import pytest

from biokanga_tpu.cli import main as jax_main
from biokanga_tpu.seq.fasta import write_fasta
from biokanga_tpu.sim.repeatgenome import repeat_genome as jax_repeat
from biokanga_tpu.sim.simreads import random_genome
from biokanga_tpu_torch.cli import main as torch_main
from biokanga_tpu_torch.sim.repeatgenome import repeat_genome


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("sim")
    seqs = random_genome([("chr1", 12_000), ("chr2", 5_000), ("chr3", 300)],
                         seed=5)
    seqs[1][1][1000:1040] = 4
    write_fasta(str(d / "g.fa"), seqs)
    assert jax_main(["uhamming", "-i", str(d / "g.fa"), "-o",
                     str(d / "g.hmg.npz"), "-K", "40", "-m", "2", "-n", "50",
                     "-N", "1"]) == 0
    (d / "tx.bed").write_text(
        "chr1\t500\t2500\ttx1\t0\t+\nchr1\t4000\t9000\ttx2\t0\t-\n"
        "chr2\t100\t400\ttx3\t0\t+\nchr9\t0\t900\ttx4\t0\t+\n"
        "chr2\t2000\t2100\tshort\t0\t+\n")
    return d


SIMREADS = {
    "se_fasta": ["-n", "300", "-l", "50"],
    "se_fastq_subs": ["-n", "300", "--sub-rate", "0.02", "--seed", "3"],
    "pe_two_files": ["--pe", "-n", "200", "--insert-min", "150",
                     "--insert-max", "260", "--sub-rate", "0.01"],
    "pe_interleaved": ["--pe", "-n", "100", "-l", "80"],
    "hammings": ["-n", "300", "-l", "40", "-H", "{hmg}"],
    "colorspace": ["-n", "200", "-C", "--sub-rate", "0.01"],
    "snps": ["-n", "200", "-N", "2000", "--outsnps", "{bed}"],
    "indels": ["-n", "400", "-X", "0.5", "-x", "5"],
    "pe_indels": ["--pe", "-n", "150", "-X", "0.3", "-x", "9"],
    "err_fixed": ["-n", "300", "-g", "fixed", "-z", "3"],
    "err_static": ["-n", "300", "-g", "static"],
    "err_dyn_uniform": ["-n", "300", "-g", "dyn", "-z", "0.02", "-Z"],
    "random_reads": ["-n", "300", "-R", "0.3", "--sub-rate", "0.01"],
    "all_post": ["--pe", "-n", "200", "-X", "0.05", "-g", "dyn", "-R",
                 "0.1", "-N", "1000", "-H", "{hmg}", "--seed", "9"],
}


@pytest.mark.parametrize("case", sorted(SIMREADS))
def test_simreads_cli_matches_jax(genome, case):
    d = genome
    ext = ("csfasta" if case == "colorspace" else
           "fa" if case in ("se_fasta", "indels") else "fq")
    outs = {}
    for tag, run in (("jax", jax_main), ("torch", torch_main)):
        files = [d / f"{case}_{tag}.{ext}"]
        argv = ["simreads", "-i", str(d / "g.fa"), "-o", str(files[0])]
        if case in ("pe_two_files", "pe_indels", "all_post"):
            files.append(d / f"{case}_{tag}_2.{ext}")
            argv += ["-O", str(files[1])]
        if case == "snps":
            files.append(d / f"{case}_{tag}.bed")
        argv += [a.format(hmg=d / "g.hmg.npz", bed=files[-1])
                 for a in SIMREADS[case]]
        assert run(argv) == 0
        outs[tag] = [f.read_bytes() for f in files]
    assert outs["torch"] == outs["jax"]
    assert all(len(x) > 1000 for x in outs["jax"])


def test_rnafragsim_cli_matches_jax(genome):
    d = genome
    for tag, run in (("jax", jax_main), ("torch", torch_main)):
        assert run(["rnafragsim", "-i", str(d / "g.fa"), "-b",
                    str(d / "tx.bed"), "-o", str(d / f"rf_{tag}.fq"), "-O",
                    str(d / f"rf_{tag}.csv"), "-n", "500", "-l", "60",
                    "--frag-min", "120", "--frag-max", "350",
                    "--expr-alpha", "0.5", "-S", "4"]) == 0
    for ext in ("fq", "csv"):
        assert (d / f"rf_torch.{ext}").read_bytes() == \
            (d / f"rf_jax.{ext}").read_bytes()


@pytest.mark.parametrize("opts", [[], ["-n", "333", "--nctrl", "2",
                                       "--nexpt", "4", "--de-frac", "0.3",
                                       "--fold-change", "2.5",
                                       "--dispersion", "0.05", "-S", "7"]])
def test_usimdiffexpr_cli_matches_jax(tmp_path, opts):
    for tag, run in (("jax", jax_main), ("torch", torch_main)):
        assert run(["usimdiffexpr", "-o", str(tmp_path / f"{tag}.csv"), "-O",
                    str(tmp_path / f"{tag}_truth.csv"), *opts]) == 0
    for stem in ("", "_truth"):
        assert (tmp_path / f"torch{stem}.csv").read_bytes() == \
            (tmp_path / f"jax{stem}.csv").read_bytes()


@pytest.mark.parametrize("k", [1, 2, 3])
def test_kangarg_cli_matches_jax(genome, k):
    d = genome
    for tag, run in (("jax", jax_main), ("torch", torch_main)):
        assert run(["kangarg", "-i", str(d / "g.fa"), "-o",
                    str(d / f"kg{k}_{tag}.fa"), "-k", str(k), "-S", "3"]) == 0
    assert (d / f"kg{k}_torch.fa").read_bytes() == \
        (d / f"kg{k}_jax.fa").read_bytes()


def test_repeat_genome_matches_jax():
    want, wstats = jax_repeat(300_000, seed=4)
    got, stats = repeat_genome(300_000, seed=4)
    np.testing.assert_array_equal(got, want)
    assert stats == wstats and stats["repeat_frac_placed"] > 0.3
