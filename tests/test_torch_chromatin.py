"""The port's chromatin / DNA-structure family against the JAX package.

`conformation_profile` (the octamer gather, torch on the caller's
device; `--device cpu` here) equals the JAX function exactly, on short
edge sequences, on one below and one above the JAX module's 2^18-step
device threshold (its `jnp.take` branch), with N runs and a non-zero
undefined value, and so do the profiles' summary stats.  Every subcommand of the family runs through both CLIs
on the same seeded inputs (a second case where an option changes the
path) and their files and stdout lines compare equal
(tests/cli_parity.py); `genstructprofile` also with several gathers a
run.  `--device cuda` without a card raises for `predconfnucs` and
`genstructprofile`."""
import numpy as np
import pytest
import torch

from biokanga_tpu.chromatin import conformation as jax_conf
from biokanga_tpu.seq.fasta import write_fasta
from biokanga_tpu.sim.simreads import random_genome
from biokanga_tpu.tools.converters3 import genbiomultialign
from biokanga_tpu_torch.chromatin import conformation as torch_conf
from biokanga_tpu_torch.cli import main as torch_main
from biokanga_tpu_torch.tools import chromatin_tools
from cli_parity import check_subcommand

CPU = torch.device("cpu")


def _with_ns(rng, n):
    codes = rng.integers(0, 4, n).astype(np.int8)
    if n > 40:
        for s in rng.integers(0, n - 20, max(1, n // 5_000)):
            codes[s: s + int(rng.integers(1, 20))] = 4
    return codes


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(61)
    return rng.uniform(-10, 40, (4 ** 8, 22)).astype(np.float32)


@pytest.mark.parametrize("case", ["short", "below", "above"])
def test_conformation_profile_matches_jax(table, case):
    """Exact equality (and float32) with the JAX function; "above" has
    more than 2^18 steps, where the JAX module gathers with jnp.take."""
    rng = np.random.default_rng({"short": 1, "below": 2, "above": 3}[case])
    if case == "short":
        seqs = [_with_ns(rng, n) for n in (0, 1, 2, 3, 7, 8, 9, 16)]
        seqs += [np.full(12, 4, np.int8), np.array([0, 4, 1, 2, 4, 3, 0, 1,
                                                    2, 3], np.int8)]
    elif case == "below":
        seqs = [_with_ns(rng, 50_000)]
    else:
        seqs = [_with_ns(rng, 300_000)]
        assert seqs[0].size - 1 >= jax_conf._DEVICE_GATHER_MIN
    for codes in seqs:
        np.testing.assert_array_equal(
            torch_conf.step_octamer_indices(codes, CPU).numpy(),
            jax_conf.step_octamer_indices(codes))
        for param, undef in (("minorgroove", 0.0), ("twist", -1.5),
                             (21, 7.25)):
            want = jax_conf.conformation_profile(codes, table, param, undef)
            got = torch_conf.conformation_profile(codes, table, param, undef,
                                                  device=CPU)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            assert (torch_conf.profile_stats(got)
                    == jax_conf.profile_stats(want))


def _sam(path, recs, chroms):
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\n")
        for c, n in chroms:
            f.write(f"@SQ\tSN:{c}\tLN:{n}\n")
        for name, flag, chrom, pos, ln in recs:
            f.write(f"{name}\t{flag}\t{chrom}\t{pos + 1}\t60\t{ln}M\t*\t0\t0"
                    f"\t{'ACGT' * (ln // 4)}\t*\n")


@pytest.fixture(scope="module")
def inp(tmp_path_factory):
    """Every input file of the CLI cases, from seeded numpy."""
    d = tmp_path_factory.mktemp("chromatin_in")
    rng = np.random.default_rng(71)
    g = random_genome([("chr1", 4_000), ("chr2", 2_500), ("chrS", 150)],
                      seed=72)
    g[0][1][1_000:1_030] = 4
    write_fasta(str(d / "g.fa"), g)
    octs = rng.choice(4 ** 8, 3_000, replace=False)
    with open(d / "oct.csv", "w") as f:
        f.write("octamer," + ",".join(jax_conf.OCT_PARAM_NAMES) + "\n")
        for i in octs.tolist():
            vals = rng.uniform(-5, 40, 22)
            f.write(f'"{jax_conf.idx_to_oligo(i, 8)}", '
                    + ",".join(f"{v:.5g}" for v in vals) + "\n")
    with open(d / "prefs.csv", "w") as f:
        f.write('"octamer","gcnt","scnt","ratio"\n')
        for i in rng.choice(4 ** 8, 3_000, replace=False).tolist():
            f.write(f'"{jax_conf.idx_to_oligo(i, 8)}",10,1,'
                    f"{rng.uniform(0, 0.3):.6f}\n")
    with open(d / "reads.bed", "w") as f:
        f.write("track name=reads\n")
        for centre in (500, 1_200, 2_100, 3_300):
            for _ in range(30):
                j = int(rng.integers(-4, 5))
                f.write(f"chr1\t{centre - 73 + j}\t{centre + 74 + j}\tr\t0\t"
                        f"{'+-'[int(rng.integers(0, 2))]}\n")
        for s in rng.integers(0, 2_300, 60).tolist():
            f.write(f"chr2\t{s}\t{s + 147}\tr\t0\t+\n")
    recs = [(f"s{i}", 16 * int(rng.integers(0, 2)), "chr1", int(p), 36)
            for i, p in enumerate(rng.integers(0, 3_900, 150))]
    recs += [(f"t{i}", 0, "chr2", int(p), 40)
             for i, p in enumerate(rng.integers(0, 2_400, 50))]
    _sam(d / "reads.sam", recs, (("chr1", 4_000), ("chr2", 2_500)))
    (d / "bkg.bed").write_text("".join(
        f"chr1\t{s}\t{s + 147}\tn\t0\t{'+-'[i % 2]}\n"
        for i, s in enumerate(range(100, 3_800, 180))) +
        "chr2\t50\t197\tn\t0\t+\n")
    (d / "smp.bed").write_text("".join(
        f"chr1\t{s + int(rng.integers(-6, 7))}\t{s + 147}\ts\t0\t+\n"
        for s in range(100, 3_800, 360)) + "chr3\t5\t152\ts\t0\t+\n")
    cores = [(f"core{i}", g[i % 2][1][s: s + 147])
             for i, s in enumerate(rng.integers(0, 2_300, 40).tolist())]
    cores += [("tiny", g[0][1][:7]), ("withN", g[0][1][990:1_060]),
              ("short9", g[1][1][:9])]
    write_fasta(str(d / "cores.fa"), cores)
    (d / "a.maf").write_text(
        "##maf version=1\n\na score=10.0\n"
        "s hg.chr1 0 24 + 1000 ACGTACGTACGTAAGGCCTTACGT\n"
        "s mm.chr1 0 24 + 900  ACGTACCTACGTAAGGCCTAACGT\n"
        "s rn.chr4 5 23 + 800  ACGTACGTAC-TAAGGCCTTACGT\n\n"
        "a score=3.0\n"
        "s hg.chr1 100 12 + 1000 TTGACCANGTCA\n"
        "s mm.chr1 90 12 + 900   TTGACCAAGTCA\n\n")
    genbiomultialign([str(d / "a.maf")], str(d / "a.algn.npz"))
    (d / "cm.csv").write_text('"Oligo","Total","Fixed"\n"ACG",3,2\n'
                              '"CGT",7,7\n"GTA",0,0\n"TTT",5,1\nbad,row\n')
    return d


# the port's subcommands that take --device (given cpu here)
DEVICE_COMMANDS = ("predconfnucs", "genstructprofile")
# (case id, argv with {i} for the input directory)
CASES = [
    ("dnaseqsitepotential", ["dnaseqsitepotential", "-i", "{i}/reads.bed",
                             "-I", "{i}/g.fa", "-o", "o.csv"]),
    ("dnaseqsitepotential-sam", ["dnaseqsitepotential", "-i",
                                 "{i}/reads.sam", "-I", "{i}/g.fa", "-o",
                                 "o.csv", "-s", "-"]),
    ("rnaseqsitepotential", ["rnaseqsitepotential", "-i", "{i}/reads.bed",
                             "-I", "{i}/g.fa", "-o", "o.csv", "-s", "+"]),
    ("simulatemnase", ["simulatemnase", "-i", "{i}/g.fa", "-o", "o.fa",
                       "-I", "{i}/prefs.csv", "-n", "200"]),
    ("simulatemnase-m1", ["simulatemnase", "-i", "{i}/g.fa", "-o", "o.fa",
                          "-I", "{i}/prefs.csv", "-m", "1", "-n", "120",
                          "-s", "+", "--seed", "5"]),
    ("simulatemnase-m2", ["simulatemnase", "-i", "{i}/g.fa", "-o", "o.fa",
                          "-m", "2", "-n", "100", "-l", "50", "-c", "100",
                          "-C", "140", "--seed", "7"]),
    ("prednucleosomes", ["prednucleosomes", "-i", "{i}/reads.bed", "-o",
                         "o.bg", "--min-score", "0.5"]),
    ("prednucleosomes-M6", ["prednucleosomes", "-i", "{i}/reads.bed", "-o",
                            "o.csv", "-g", "{i}/g.fa", "-I",
                            "{i}/prefs.csv", "-M", "6"]),
    ("prednucleosomes-M7", ["prednucleosomes", "-i", "{i}/reads.sam", "-o",
                            "o.csv", "-M", "7", "-a", "5", "-A", "100"]),
    ("predconfnucs", ["predconfnucs", "-i", "{i}/g.fa", "-I",
                      "{i}/oct.csv", "-o", "o.bg"]),
    ("predconfnucs-M4", ["predconfnucs", "-i", "{i}/g.fa", "-I",
                         "{i}/oct.csv", "-o", "o.bed", "-M", "4", "-a", "20",
                         "-A", "100", "-t", "x"]),
    ("genstructprofile", ["genstructprofile", "-i", "{i}/cores.fa", "-p",
                          "{i}/oct.csv", "-o", "o.csv"]),
    ("genstructprofile-twist", ["genstructprofile", "-i", "{i}/cores.fa",
                                "-p", "{i}/oct.csv", "-o", "o.csv", "--param",
                                "twist", "-T", "60", "-u", "5", "-n", "30"]),
    ("genstructprofile-batches", ["genstructprofile", "-i", "{i}/cores.fa",
                                  "-p", "{i}/oct.csv", "-o", "o.csv",
                                  "--param", "energy"]),
    ("genstructstats", ["genstructstats", "-i", "{i}/oct.csv", "-o",
                        "o.csv"]),
    ("genstructstats-s", ["genstructstats", "-i", "{i}/oct.csv", "-o",
                          "o.csv", "-s"]),
    ("gennucstats", ["gennucstats", "-i", "{i}/bkg.bed", "-o", "o.csv"]),
    ("gennucstats-sample", ["gennucstats", "-i", "{i}/bkg.bed", "-o",
                            "o.csv", "-I", "{i}/smp.bed", "-w", "3", "-s",
                            "70"]),
    ("gencomposition", ["gencomposition", "-i", "{i}/g.fa", "-o", "o.csv",
                        "-n", "3"]),
    ("gencentroidmetrics", ["gencentroidmetrics", "-i", "{i}/a.algn.npz",
                            "-o", "o.csv", "-n", "3"]),
    ("gencentroidmetrics-ref", ["gencentroidmetrics", "-i",
                                "{i}/a.algn.npz", "-o", "o.csv", "-r", "mm"]),
    ("proccentroids", ["proccentroids", "-i", "{i}/cm.csv", "-o", "o.csv"]),
]


@pytest.mark.parametrize("case,argv", CASES, ids=[c[0] for c in CASES])
def test_chromatin_subcommand_matches_jax_cli(inp, tmp_path, capsys,
                                              monkeypatch, case, argv):
    if case == "genstructprofile-batches":
        # several gathers a run: a batch closes past 1,000 steps
        monkeypatch.setattr(chromatin_tools, "PROFILE_BATCH_STEPS", 1_000)
    argv = [a.replace("{i}", str(inp)) for a in argv]
    extra = ["--device", "cpu"] if argv[0] in DEVICE_COMMANDS else []
    out, names = check_subcommand(tmp_path, argv, capsys, monkeypatch,
                                  torch_extra=extra)
    assert len(names) == 1
    text = (tmp_path / "torch" / names[0]).read_text()
    assert len(text.splitlines()) > 1, case


def test_every_chromatin_subcommand_has_a_case():
    from biokanga_tpu.cli import SUBCOMMANDS

    names = {argv[0] for _, argv in CASES}
    family = {"dnaseqsitepotential", "rnaseqsitepotential", "simulatemnase",
              "prednucleosomes", "predconfnucs", "genstructprofile",
              "genstructstats", "gennucstats", "gencomposition",
              "gencentroidmetrics", "proccentroids"}
    assert names == family and family <= set(SUBCOMMANDS)


def test_device_commands_raise_without_cuda(inp, tmp_path, monkeypatch):
    """The default device is cuda, and cuda without a card raises: no
    profile is gathered on the CPU instead and no file is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["predconfnucs", "-i", f"{inp}/g.fa", "-I",
                  f"{inp}/oct.csv", "-o", str(tmp_path / "x.bg")],
                 ["genstructprofile", "-i", f"{inp}/cores.fa", "-p",
                  f"{inp}/oct.csv", "-o", str(tmp_path / "x.csv")]):
        for device in ([], ["--device", "cuda"]):
            with pytest.raises(RuntimeError, match="is_available"):
                torch_main(argv + device)
    assert not list(tmp_path.iterdir())
