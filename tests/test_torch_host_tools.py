"""The port's host tool subcommands against the JAX CLI: the 26
converters, the misc tools, the expression and zygosity tools, the FASTA
and SAM tools, `ssr`, the SQLite loaders, `csv2sqlite` and
`alignvalidate`.  One case a subcommand (and a second one where an
option changes the path): both CLIs run on the same seeded inputs, and
their files and stdout lines compare equal (tests/cli_parity.py)."""
import numpy as np
import pytest

from biokanga_tpu.align.snp import SNPCall, write_snps_csv
from biokanga_tpu.index.build import build_index, save_index
from biokanga_tpu.seq.encode import ascii_to_codes
from biokanga_tpu.seq.fasta import write_fasta
from biokanga_tpu.seq.rds import write_rds
from biokanga_tpu.sim.simreads import random_genome
from cli_parity import check_subcommand


def _sam(path, recs, chroms=(("chr1", 10_000),)):
    """SAM of (name, flag, chrom, 0-based pos, length) records."""
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\n")
        for c, n in chroms:
            f.write(f"@SQ\tSN:{c}\tLN:{n}\n")
        for name, flag, chrom, pos, ln in recs:
            if flag & 4:
                f.write(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII\n")
                continue
            f.write(f"{name}\t{flag}\t{chrom}\t{pos + 1}\t60\t{ln}M\t*\t0\t0"
                    f"\t{'ACGT' * (ln // 4)}\t*\n")


@pytest.fixture(scope="module")
def inp(tmp_path_factory):
    """Every input file of the cases below, from seeded numpy."""
    d = tmp_path_factory.mktemp("host_tools_in")
    rng = np.random.default_rng(41)
    g = random_genome([("chr1", 6_000), ("chr2", 3_000), ("chrM", 400)],
                      seed=43)
    write_fasta(str(d / "g.fa"), g)
    # two sequences share a name, one is short, one carries Ns
    multi = random_genome([("s1", 300), ("s1", 420), ("short", 30),
                           ("s3 desc", 250)], seed=44)
    multi[3][1][40:60] = 4
    write_fasta(str(d / "multi.fa"), multi)
    write_fasta(str(d / "inter.fa"),
                [(f"p{i}/{m + 1}", rng.integers(0, 4, 80).astype(np.int8))
                 for i in range(5) for m in range(2)])
    ssr = np.concatenate([ascii_to_codes(b"GATTACAGGCAT" * 10),
                          ascii_to_codes(b"AT" * 12),
                          ascii_to_codes(b"CCGATGGC" * 10),
                          ascii_to_codes(b"CAG" * 9),
                          ascii_to_codes(b"TTGACCA" * 6)])
    write_fasta(str(d / "ssr.fa"), [("chrZ", ssr)])

    (d / "a.bed").write_text(
        "chr1\t10\t50\tf1\t0\t+\nchr2\t5\t99\tf2\t0\t-\n"
        "chr1\t100\t500\tgeneA\t0\t+\t100\t500\t0\t2\t50,100,\t0,300,\n")
    (d / "m.bed").write_text(
        "chr1\t0\t100\ta\t0\t+\nchr1\t90\t200\tb\t0\t+\n"
        "chr1\t500\t600\tc\t0\t+\nchr1\t603\t650\tc2\t0\t-\n"
        "chr2\t0\t10\td\t0\t+\nchrM\t5\t25\te\t0\t+\n")
    (d / "feat.bed").write_text(
        "chr1\t0\t1000\tup\t0\t+\t0\t1000\t0\t2\t300,400,\t0,600,\n"
        "chr1\t2000\t3000\tflat\t0\t+\n"
        "chr1\t4000\t6000\tbig\t0\t-\n")
    (d / "parts.bed").write_text(
        "chr1\t0\t3000\tpartA\t0\t+\nchr1\t3100\t6000\tpartB\t0\t+\n")
    (d / "a.gff3").write_text(
        "##gff-version 3\n"
        "c\tx\tgene\t1\t100\t.\t+\t.\tID=g1;Name=G1\n"
        "c\tx\texon\t1\t50\t.\t+\t.\tID=e1;Parent=g1\n"
        "c\tx\tmRNA\t1\t100\t.\t+\t.\tID=m1;Parent=g1\n")
    (d / "a.gtf").write_text(
        'chr1\tx\texon\t101\t200\t.\t+\t.\tgene_id "g1"; transcript_id "t1";\n'
        'chr1\tx\texon\t301\t400\t.\t+\t.\tgene_id "g1"; transcript_id "t1";\n'
        'chr1\tx\tCDS\t501\t550\t.\t-\t.\tgene_id "g2"; transcript_id "t2";\n')

    (d / "s.csv").write_text('"name","seq"\n"s1","ACGT"\n"s2","GGNGG"\n')
    (d / "a.csv").write_text(
        '"Name","Score","Chrom"\n"x",5,"chr1"\n"y",15,"chr2"\n'
        '"z",25,"chr1"\n"w",7.5,"chrM"\n')
    (d / "b.csv").write_text('"Name","Extra"\n"y",7\n"w",9\n"v",1\n')
    (d / "loci.csv").write_text(
        '"Chrom","Start","End","Name","Strand"\n'
        '"chr1",100,200,"snp1","-"\n"chr2",5,50,"snp2","+"\n')
    (d / "h.csv").write_text(
        '"Chrom","Loci","Hamming"\n' + "".join(
            f'"chr{1 + i // 9}",{i % 9},{h}\n'
            for i, h in enumerate(rng.integers(0, 5, 18))))
    (d / "markers.csv").write_text(
        '"Name","Loci","Score","Tag"\n"m1",100,0.5,"a"\n"m2",250,1.5,"b"\n'
        '"m3",,2,""\n')
    (d / "in.psl").write_text(
        "psLayout version 3\n\nmatch\tmis-\n----\n"
        "90\t5\t0\t0\t1\t2\t1\t3\t+\tq1\t100\t0\t97\tt1\t5000\t100\t200\t"
        "2\t50,45\t0,52\t100,155\n"
        "40\t0\t0\t0\t0\t0\t0\t0\t-\tq2\t40\t0\t40\tt1\t5000\t900\t940\t"
        "1\t40\t0\t900\n")
    (d / "in.b6").write_text(
        "# comment\nq1\tt1\t98.5\t100\t1\t0\t1\t100\t500\t599\t1e-50\t190\n"
        "q2\tt2\t91.0\t50\t4\t1\t1\t50\t20\t69\t2e-9\t71.5\n")
    c1 = random_genome([("c1", 300)], seed=1)[0][1]
    c2 = random_genome([("c2", 200)], seed=2)[0][1]
    write_fasta(str(d / "ctg.fa"), [("c1", c1), ("c2", c2)])
    (d / "s.agp").write_text(
        "scaf1\t1\t300\t1\tW\tc1\t1\t300\t+\n"
        "scaf1\t301\t400\t2\tN\t100\tscaffold\tyes\tpaired-ends\n"
        "scaf1\t401\t600\t3\tW\tc2\t1\t200\t-\n"
        "scaf2\t1\t100\t1\tW\tc2\t51\t150\t+\n")
    write_rds(str(d / "x.rds.npz"),
              [(f"r{i}", rng.integers(0, 5, 60).astype(np.int8))
               for i in range(5)])
    (d / "d.maf").write_text(
        "##maf version=1\na score=123.0\n"
        "s hg.chr1 100 8 + 1000 ACGT--ACGT\n"
        "s mm.chr2 200 10 - 2000 ACGTTTACGT\n\n"
        "a score=9.5\ns hg.chr1 500 4 + 1000 AC-GT\n"
        "s mm.chr2 700 5 + 2000 ACCGT\n")
    steps = [a + b for a in "ACGT" for b in "ACGT"]
    (d / "struct.csv").write_text("".join(
        f"{s},0,0,0,{30 + i},0,0,0,0,0\n" for i, s in enumerate(steps)))
    write_fasta(str(d / "q.fa"),
                [("s1", np.array([0, 1, 2, 3] * 25, np.int8)),
                 ("s2", np.zeros(100, np.int8)),
                 ("s3", rng.integers(0, 5, 150).astype(np.int8))])

    # SAMs: reads over the features, on both strands, one unmapped
    def libsam(path, n_up, seed):
        r = np.random.default_rng(seed)
        recs = [(f"u{i}", 0, "chr1", int(p), 50)
                for i, p in enumerate(r.integers(0, 900, n_up))]
        recs += [(f"f{i}", 16 * (i % 2), "chr1", int(p), 48)
                 for i, p in enumerate(r.integers(2000, 2900, 60))]
        recs += [(f"b{i}", 16, "chr1", int(p), 52)
                 for i, p in enumerate(r.integers(4000, 5900, 300))]
        recs += [("x0", 4, None, 0, 0), ("x1", 0, "chr2", 100, 40)]
        _sam(path, recs, (("chr1", 6_000), ("chr2", 3_000)))

    libsam(d / "ctrl.sam", 50, 5)
    libsam(d / "expr.sam", 150, 6)
    libsam(d / "ctrl2.sam", 60, 7)
    roi = [(f"r{i}", 0, "chr1", 1000 + 10 * i, 200) for i in range(30)]
    roi += [(f"s{i}", 16, "chr2", 200 + 3 * i, 120) for i in range(8)]
    _sam(d / "roi.sam", roi, (("chr1", 6_000), ("chr2", 3_000)))
    truth = [("lcl|usimreads|00000001|chr1|100|199|100|+|0|0|0", 0, "chr1",
              100, 4),
             ("lcl|usimreads|00000002|chr1|500|599|100|-|0|0|0", 16, "chr1",
              501, 4),
             ("lcl|usimreads|00000003|chr1|900|999|100|+|0|0|0", 0, "chr1",
              333, 4),
             ("lcl|usimreads|00000004|chr1|700|799|100|+|0|0|0", 4, None,
              0, 0),
             ("notasimread", 0, "chr1", 5, 4)]
    _sam(d / "truth.sam", truth)
    _sam(d / "other.sam", [(truth[0][0], 0, "chr1", 101, 4),
                           (truth[1][0], 16, "chr1", 900, 4),
                           (truth[3][0], 0, "chr1", 5, 4)])

    # radseq reads and barcodes
    site = "TGCAGG"
    bcs = {"sampleA": "ACGTA", "sampleB": "TTGCC"}
    rad = []
    for i, (s, bc) in enumerate(list(bcs.items()) * 4):
        body = rng.integers(0, 4, 80).astype(np.int8)
        code = np.concatenate([ascii_to_codes(bc.encode()),
                               ascii_to_codes(site.encode()), body])
        if i == 3:
            code[1] = (code[1] + 1) % 4             # one barcode mismatch
        rad.append((f"rd{i}_{s}", code.astype(np.int8)))
    bad = rad[0][1].copy()
    bad[6] = (bad[6] + 1) % 4
    rad.append(("bad", bad))
    rad.append(("nobc", rng.integers(0, 4, 90).astype(np.int8)))
    write_fasta(str(d / "rad.fa"), rad)
    (d / "bc.csv").write_text("sample,barcode\nsampleA,ACGTA\n"
                              "sampleB,TTGCC\n")
    region = rng.integers(0, 4, 200).astype(np.int8)
    hr = [(f"r{i}", region[i % 3: i % 3 + 100].copy()) for i in range(10)]
    hr += [(f"u{i}", rng.integers(0, 4, 100).astype(np.int8))
           for i in range(5)]
    write_fasta(str(d / "homozy.fa"), hr)

    # SNP CSV through the JAX writer, a DE CSV, an index for genzygosity
    calls = [SNPCall(chrom=c, loci=lo, ref_base=0, tot_bases=12, nonref=9,
                     base_cnts=np.array([3, 0, 9, 0], np.int64),
                     pvalue=1e-8, bkgnd_rate=0.01, win_bases=200, win_mm=2,
                     rank=1)
             for c, lo in (("chr1", 42), ("chr1", 99), ("chr2", 7))]
    write_snps_csv(str(d / "snps.csv"), calls)
    (d / "de.csv").write_text(
        '"Feature","CtrlCnts","ExprCnts","FoldChange","Pearson","Class"\n'
        '"up",50,150,3.0,0.91,"up"\n"flat",60,61,1.0166,0.2,"none"\n')
    a = rng.integers(0, 4, 3000).astype(np.int8)
    b = rng.integers(0, 4, 3000).astype(np.int8)
    b[:1500] = a[:1500]
    save_index(build_index([("a", a), ("b", b), ("c", a.copy())],
                           lut_bases=8), str(d / "z.npz"))
    return d


# (case id, argv with {i} for the input directory, dirs to make first)
CASES = [
    ("bed2csv", ["bed2csv", "-i", "{i}/a.bed", "-o", "o.csv"], ()),
    ("csv2bed", ["csv2bed", "-i", "{i}/loci.csv", "-o", "o.bed"], ()),
    ("csv2fasta", ["csv2fasta", "-i", "{i}/s.csv", "-o", "o.fa"], ()),
    ("fasta2bed", ["fasta2bed", "-i", "{i}/multi.fa", "-o", "o.bed"], ()),
    ("bedfilter", ["bedfilter", "-i", "{i}/m.bed", "-o", "o.bed", "-z",
                   "chr1", "--min-len", "40", "--max-len", "150"], ()),
    ("bedmerge", ["bedmerge", "-i", "{i}/m.bed", "-o", "o.bed"], ()),
    ("bedmerge-gap", ["bedmerge", "-i", "{i}/m.bed", "-o", "o.bed", "-g",
                      "5"], ()),
    ("gfffilter", ["gfffilter", "-i", "{i}/a.gff3", "-o", "o.gff3", "-t",
                   "gene", "-t", "mRNA"], ()),
    ("gtffilter", ["gtffilter", "-i", "{i}/a.gtf", "-o", "o.gtf", "-r",
                   "t1"], ()),
    ("genwiggle", ["genwiggle", "-i", "{i}/ctrl.sam", "-o", "o.wig", "-s",
                   "10"], ()),
    ("genwiggle-norm", ["genwiggle", "-i", "{i}/roi.sam", "-o", "o.wig",
                        "-n"], ()),
    ("splitmultifasta", ["splitmultifasta", "-i", "{i}/multi.fa", "-o",
                         "split", "-p", "x_"], ("split",)),
    ("fastafilter", ["fastafilter", "-i", "{i}/multi.fa", "-o", "o.fa",
                     "--min-len", "50"], ()),
    ("fasta2pe", ["fasta2pe", "-i", "{i}/inter.fa", "-o", "o1.fa", "-O",
                  "o2.fa"], ()),
    ("psl2csv", ["psl2csv", "-i", "{i}/in.psl", "-o", "o.csv"], ()),
    ("blast2csv", ["blast2csv", "-i", "{i}/in.b6", "-o", "o.csv"], ()),
    ("csv2stats", ["csv2stats", "-i", "{i}/a.csv", "-o", "o.csv"], ()),
    ("csvfilter", ["csvfilter", "-i", "{i}/a.csv", "-o", "o.csv", "-c",
                   "Score", "-p", "gt", "-V", "6"], ()),
    ("csvfilter-match", ["csvfilter", "-i", "{i}/a.csv", "-o", "o.csv",
                         "-c", "Chrom", "-p", "match", "-V", "chr[1M]"],
     ()),
    ("csvmerge", ["csvmerge", "-i", "{i}/a.csv", "-i", "{i}/b.csv", "-o",
                  "o.csv", "-k", "Name"], ()),
    ("csv2feat", ["csv2feat", "-i", "{i}/loci.csv", "-o", "o.bed"], ()),
    ("fasta2dist", ["fasta2dist", "-i", "{i}/multi.fa", "-o", "o.csv",
                    "-k", "3"], ()),
    ("agp2genome", ["agp2genome", "-a", "{i}/s.agp", "-c", "{i}/ctg.fa",
                    "-o", "o.fa"], ()),
    ("dmpbioseq", ["dmpbioseq", "-i", "{i}/x.rds.npz", "-o", "o.txt",
                   "-n", "4"], ()),
    ("dmpbioseq-index", ["dmpbioseq", "-i", "{i}/z.npz", "-o", "o.txt",
                         "-n", "2"], ()),
    ("hammingdist", ["hammingdist", "-i", "{i}/h.csv", "-o", "o.csv", "-w",
                     "4"], ()),
    ("genbioseq", ["genbioseq", "-i", "{i}/multi.fa", "-i", "{i}/q.fa",
                   "-o", "o.rds.npz"], ()),
    ("genbiobed", ["genbiobed", "-i", "{i}/m.bed", "-o", "o.biobed.npz"],
     ()),
    ("genbiomultialign", ["genbiomultialign", "-i", "{i}/d.maf", "-o",
                          "o.algn.npz"], ()),
    ("fasta2struct", ["fasta2struct", "-i", "{i}/q.fa", "-o", "o.csv",
                      "-c", "twist", "-C", "4"], ()),
    ("fasta2struct-params", ["fasta2struct", "-i", "{i}/q.fa", "-o",
                             "o.csv", "-p", "{i}/struct.csv", "-n", "30"],
     ()),
    ("quickcount", ["quickcount", "-i", "{i}/q.fa", "-o", "o.csv", "-k",
                    "2"], ()),
    ("quickcount-perseq", ["quickcount", "-i", "{i}/q.fa", "-o", "o.csv",
                           "-k", "3", "-m", "perseq"], ()),
    ("loci2dist", ["loci2dist", "-i", "{i}/m.bed", "-o", "o.csv", "-b",
                   "25"], ()),
    ("ufilter", ["ufilter", "-i", "{i}/m.bed", "-o", "o.bed", "-z",
                 "chr[12]", "-Z", "chr2"], ()),
    ("gensampler", ["gensampler", "-i", "{i}/g.fa", "-o", "o.fa", "-n",
                    "20", "-l", "50", "-b", "{i}/parts.bed", "-S", "3"], ()),
    ("kangahrdx", ["kangahrdx", "-i", "{i}/homozy.fa", "-o", "o.fa",
                   "--max-copies", "2", "--seed-len", "24"], ()),
    ("kangaradseq", ["kangaradseq", "-i", "{i}/rad.fa", "-b", "{i}/bc.csv",
                     "-O", "demux"], ()),
    ("maploci", ["maploci", "-i", "{i}/ctrl.sam", "-b", "{i}/feat.bed",
                 "-o", "o.csv", "--strand"], ()),
    ("maploci2features", ["maploci2features", "-i", "{i}/expr.sam", "-b",
                          "{i}/feat.bed", "-o", "o.csv"], ()),
    ("gendeseq", ["gendeseq", "-c", "{i}/ctrl.sam", "-c", "{i}/ctrl2.sam",
                  "-e", "{i}/expr.sam", "-b", "{i}/feat.bed", "-o",
                  "o.csv"], ()),
    ("rnade", ["rnade", "-c", "{i}/ctrl.sam", "-e", "{i}/expr.sam", "-b",
               "{i}/feat.bed", "-o", "o.csv", "--confidence-iters", "200"],
     ()),
    ("rnade-exons", ["rnade", "-c", "{i}/ctrl.sam", "-e", "{i}/expr.sam",
                     "-b", "{i}/feat.bed", "-o", "o.csv", "-r", "exons",
                     "--bins", "5", "--min-cnts", "5"], ()),
    ("locateroi", ["locateroi", "-i", "{i}/roi.sam", "-o", "o.csv",
                   "--min-cov", "2", "--min-len", "50"], ()),
    ("genzygosity", ["genzygosity", "-I", "{i}/z.npz", "-o", "o.csv", "-k",
                     "16"], ()),
    ("alignsbs", ["alignsbs", "-a", "{i}/ctrl.sam", "-b", "{i}/expr.sam",
                  "-B", "{i}/feat.bed", "-o", "o.csv", "-n", "200"], ()),
    ("alignsbs-noreplace", ["alignsbs", "-a", "{i}/ctrl.sam", "-b",
                            "{i}/expr.sam", "-B", "{i}/feat.bed", "-o",
                            "o.csv", "-n", "50", "--no-replacement"], ()),
    ("fasta2nxx", ["fasta2nxx", "-i", "{i}/multi.fa", "-i", "{i}/g.fa",
                   "-o", "o.csv"], ()),
    ("fasta2nxx-stdout", ["fasta2nxx", "-i", "{i}/g.fa", "-q", "run.db"],
     ()),
    ("xfasta", ["xfasta", "-i", "{i}/multi.fa", "-o", "o.fa", "-r", "^s",
                "--min-len", "100", "--start", "10", "--end", "200"], ()),
    ("pseudogenome", ["pseudogenome", "-i", "{i}/multi.fa", "-i",
                      "{i}/g.fa", "-o", "o.fa", "-O", "o.bed", "--sep-ns",
                      "50"], ()),
    ("ssr", ["ssr", "-i", "{i}/ssr.fa", "-o", "o.csv", "-O", "o.bed", "-r",
             "5"], ()),
    ("filtchrom", ["filtchrom", "-i", "{i}/roi.sam", "-o", "o.sam", "-z",
                   "^chr2$"], ()),
    ("filtchrom-exclude", ["filtchrom", "-i", "{i}/roi.sam", "-o", "o.sam",
                           "-z", "^chr2$", "-Z"], ()),
    ("remaploci", ["remaploci", "-i", "{i}/ctrl.sam", "-o", "o.sam", "-b",
                   "{i}/parts.bed"], ()),
    ("snps2sqlite", ["snps2sqlite", "-i", "{i}/snps.csv", "-o", "o.db",
                     "-n", "exp1", "-c", "cv1"], ()),
    ("snpm2sqlite", ["snpm2sqlite", "-i", "{i}/snps.csv", "-o", "o.db"],
     ()),
    ("psl2sqlite", ["psl2sqlite", "-i", "{i}/in.psl", "-o", "o.db", "-n",
                    "blitz1"], ()),
    ("de2sqlite", ["de2sqlite", "-i", "{i}/de.csv", "-o", "o.db"], ()),
    ("csv2sqlite", ["csv2sqlite", "-i", "{i}/markers.csv", "-o", "o.db"],
     ()),
    ("csv2sqlite-table", ["csv2sqlite", "-i", "{i}/a.csv", "-o", "o.db",
                          "-t", "scores"], ()),
    ("alignvalidate", ["alignvalidate", "-i", "{i}/truth.sam", "-o",
                       "o.csv"], ()),
    ("alignvalidate-refsam", ["alignvalidate", "-i", "{i}/truth.sam", "-r",
                              "{i}/other.sam", "-o", "o.csv",
                              "--tolerance", "1"], ()),
]


@pytest.mark.parametrize("case,argv,make_dirs", CASES,
                         ids=[c[0] for c in CASES])
def test_host_subcommand_matches_jax_cli(inp, tmp_path, capsys,
                                         monkeypatch, case, argv,
                                         make_dirs):
    argv = [a.replace("{i}", str(inp)) for a in argv]
    out, names = check_subcommand(tmp_path, argv, capsys, monkeypatch,
                                  make_dirs)
    assert out.strip() or case == "fasta2nxx"   # -o: no stdout line
    if case == "fasta2nxx-stdout":         # the stats on stdout, -q row
        assert names == ["run.db"] and "N50," in out


def test_every_host_subcommand_has_a_case():
    from biokanga_tpu_torch.cli_host import HOST_SUBCOMMANDS
    from test_torch_chromatin import CASES as chromatin_cases
    from test_torch_conservation import CASES as conservation_cases
    from test_torch_go_stats import CASES as go_cases

    read_tools = {"filter", "ngsqc", "filterreads", "kangar", "kangapr",
                  "kmerdist"}                 # test_torch_readprep.py
    covered = {argv[0] for _, argv, _ in CASES}
    families = {argv[0] for _, argv in
                chromatin_cases + conservation_cases + go_cases}
    assert len(families) == 28
    assert covered | read_tools | families == set(HOST_SUBCOMMANDS)
    assert len(HOST_SUBCOMMANDS) == 57 + 28
