"""The port's conservation family against the JAX CLI.

A seeded multi-species alignment (three blocks, three species, reference
indels, Ns and substitutions) goes through the JAX CLI's
`genbiomultialign`, and the same `.algn.npz` file is given to both CLIs.
Every subcommand of the family runs through both on it and on seeded
loci, BED, FASTA and read files (a second case where an option changes
the path: hyper mode with -N/-j/-k, the set-op modes, the '#'
placeholders, glob inputs), and their files and stdout lines compare
equal (tests/cli_parity.py)."""
import numpy as np
import pytest

from biokanga_tpu.cli import main as jax_main
from biokanga_tpu.seq.encode import codes_to_ascii
from biokanga_tpu.seq.fasta import write_fasta
from biokanga_tpu.sim.simreads import random_genome
from cli_parity import check_subcommand


def _mutate(rng, text, n_sub, gaps=(), n_pos=()):
    t = list(text)
    for i in rng.choice(len(t), n_sub, replace=False).tolist():
        t[i] = "ACGT"[("ACGT".index(t[i]) + 1) % 4] if t[i] in "ACGT" else t[i]
    for s, e in gaps:
        t[s:e] = "-" * (e - s)
    for i in n_pos:
        t[i] = "N"
    return "".join(t)


@pytest.fixture(scope="module")
def inp(tmp_path_factory):
    d = tmp_path_factory.mktemp("conservation_in")
    rng = np.random.default_rng(81)
    g = random_genome([("chr1", 1_200), ("chr2", 400)], seed=82)
    write_fasta(str(d / "g.fa"), g)
    chr1 = codes_to_ascii(g[0][1]).decode()
    chr2 = codes_to_ascii(g[1][1]).decode()
    b1 = chr1[100:220]
    b2 = chr1[400:440] + "--" + chr1[440:478]
    b3 = chr2[0:60]
    blocks = [
        [("hg.chr1", 100, b1), ("mm.chr2", 500, _mutate(rng, b1, 3)),
         ("rn.chr3", 50, _mutate(rng, b1, 1, gaps=((70, 72),),
                                 n_pos=(90,)))],
        [("hg.chr1", 400, b2), ("mm.chr2", 900, _mutate(rng, b2, 2)),
         ("rn.chr3", 300, b2.replace("--", "AC"))],
        [("hg.chr2", 0, b3), ("mm.chr7", 10, b3)],
    ]
    with open(d / "t.maf", "w") as f:
        f.write("##maf version=1\n\n")
        for rows in blocks:
            f.write("a score=1.0\n")
            for src, start, text in rows:
                size = sum(c != "-" for c in text)
                f.write(f"s {src} {start} {size} + 100000 {text}\n")
            f.write("\n")
    assert jax_main(["genbiomultialign", "-i", str(d / "t.maf"), "-o",
                     str(d / "t.algn.npz")]) == 0
    (d / "loci.csv").write_text(
        '1,"ultracore","hg","chr1",120,160,41,"all",0\n'
        '2,"hypercore","hg","chr1",410,450,41,"all",0\n'
        "chr2,5,40\nchr1,700,720\nbad,row\n")
    (d / "el1.csv").write_text(
        '1,"ultracore","hg","chr1",100,199,100,"s",0\n'
        '2,"ultracore","hg","chr1",500,599,100,"s",0\n'
        '3,"ultracore","hg","chr2",10,40,31,"s",0\n')
    (d / "el2.csv").write_text(
        '1,"ultracore","mm","chr1",150,250,101,"s",0\n'
        '2,"ultracore","hg","chr2",10,40,31,"s",0\n'
        "chr1\t900\t1500\n")
    (d / "genes.bed").write_text(
        "chr1\t50\t150\tgeneA\t0\t+\t50\t150\t0\t2\t20,30,\t0,70,\n"
        "chr1\t600\t800\tgeneB\t0\t-\n"
        "chr2\t100\t300\tgeneC\t0\t+\n")
    cand = random_genome([(f"c{i}", int(n)) for i, n in
                          enumerate(rng.integers(10, 120, 12))], seed=83)
    cand[3][1][:6] = 4
    cand[5][1][:] = 2
    write_fasta(str(d / "cand.fa"), cand)
    (d / "reads.bed").write_text("".join(
        f"chr{1 + i % 2}\t{s}\t{s + 30}\tr\t0\t+\n"
        for i, s in enumerate(rng.integers(0, 300, 40).tolist())))
    return d


# (case id, argv with {i} for the input directory)
CASES = [
    ("genhyperconserved", ["genhyperconserved", "-i", "{i}/t.algn.npz",
                           "-o", "o.csv", "-O", "cores.csv", "-n", "20"]),
    ("genhyperconserved-hyper", ["genhyperconserved", "-i",
                                 "{i}/t.algn.npz", "-o", "o.csv", "-O",
                                 "cores.csv", "-N", "30", "-y", "90", "-n",
                                 "10", "-X", "5", "-j", "-k", "-r", "mm",
                                 "-s", "hg", "-s", "mm"]),
    ("genultras", ["genultras", "-i", "{i}/t.algn.npz", "-o", "o.csv", "-O",
                   "cores.csv", "-n", "15"]),
    ("genhyperdropouts", ["genhyperdropouts", "-i", "{i}/el1.csv", "-I",
                          "{i}/el2.csv", "-o", "o.csv"]),
    ("genhyperdropouts-intersect", ["genhyperdropouts", "-i",
                                    "{i}/el1.csv", "-I", "{i}/el2.csv",
                                    "-o", "o.csv", "-p", "1"]),
    ("genhyperdropouts-combined", ["genhyperdropouts", "-i", "{i}/el1.csv",
                                   "-I", "{i}/el2.csv", "-o", "o.csv", "-p",
                                   "3"]),
    ("genalignstats", ["genalignstats", "-i", "{i}/t.algn.npz", "-o",
                       "o.csv"]),
    ("genalignconf", ["genalignconf", "-i", "{i}/t.algn.npz", "-o",
                      "o.csv"]),
    ("genalignconf-summary", ["genalignconf", "-i", "{i}/t.algn.npz", "-o",
                              "o.csv", "-m", "2"]),
    ("genalignref2relloci", ["genalignref2relloci", "-i", "{i}/loci.csv",
                             "-I", "{i}/t.algn.npz", "-o", "o.csv"]),
    ("genalignref2relloci-species", ["genalignref2relloci", "-i",
                                     "{i}/loci.csv", "-I", "{i}/t.algn.npz",
                                     "-o", "rel_#.csv", "-r", "hg"]),
    ("genalignloci2core", ["genalignloci2core", "-i", "{i}/loci.csv", "-I",
                           "{i}/t.algn.npz", "-o", "o.csv", "-d", "5"]),
    ("loci2phylip", ["loci2phylip", "-i", "{i}/loci.csv", "-I",
                     "{i}/t.algn.npz", "-o", "o.phy"]),
    ("loci2phylip-per-locus", ["loci2phylip", "-i", "{i}/loci.csv", "-I",
                               "{i}/t.algn.npz", "-o", "ph_#.phy", "-x",
                               "1"]),
    ("genrollups", ["genrollups", "-i", "{i}/el*.csv", "-o", "o.csv"]),
    ("genelementseq", ["genelementseq", "-i", "{i}/loci.csv", "-I",
                       "{i}/g.fa", "-o", "o.fa", "-f", "5"]),
    ("genloci2gene", ["genloci2gene", "-i", "{i}/loci.csv", "-b",
                      "{i}/genes.bed", "-o", "o.csv", "-L", "300"]),
    ("genseqcandidates", ["genseqcandidates", "-i", "{i}/cand.fa", "-o",
                          "o.fa", "--min-len", "20", "--max-len", "100",
                          "--max-n-pct", "10", "--min-gc", "30",
                          "--max-gc", "70"]),
    ("genelementprofiles", ["genelementprofiles", "-i", "{i}/loci.csv",
                            "-I", "{i}/t.algn.npz", "-o", "o.csv", "-d",
                            "4"]),
    ("processcsvfiles", ["processcsvfiles", "-i", "{i}/el*.csv", "-o",
                         "o.csv"]),
    ("processcsvfiles-common", ["processcsvfiles", "-i", "{i}/el*.csv",
                                "-o", "o.csv", "-m", "common"]),
    ("gennormwiggle", ["gennormwiggle", "-i", "{i}/reads.bed", "-o",
                       "o.wig"]),
    ("gennormwiggle-coverage", ["gennormwiggle", "-i", "{i}/reads.bed",
                                "-o", "o.wig", "-m", "1", "-s", "2"]),
]


@pytest.mark.parametrize("case,argv", CASES, ids=[c[0] for c in CASES])
def test_conservation_subcommand_matches_jax_cli(inp, tmp_path, capsys,
                                                 monkeypatch, case, argv):
    argv = [a.replace("{i}", str(inp)) for a in argv]
    out, names = check_subcommand(tmp_path, argv, capsys, monkeypatch)
    texts = [(tmp_path / "torch" / n).read_text() for n in names]
    assert any(t.strip() for t in texts), case
    if case.endswith(("-species", "-per-locus")):
        assert len(names) >= 2, names


def test_every_conservation_subcommand_has_a_case():
    from biokanga_tpu.cli import SUBCOMMANDS

    names = {argv[0] for _, argv in CASES}
    family = {"genhyperconserved", "genultras", "genhyperdropouts",
              "genalignstats", "genalignconf", "genalignref2relloci",
              "genalignloci2core", "loci2phylip", "genrollups",
              "genelementseq", "genloci2gene", "genseqcandidates",
              "genelementprofiles", "processcsvfiles", "gennormwiggle"}
    assert names == family and family <= set(SUBCOMMANDS)
