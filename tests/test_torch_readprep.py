"""The port's read preparation against the JAX package: the contaminant
database (`Contaminants.match_flank`, `match_vectors` and the aligner
result under the vector screen), `near_duplicate_mask`, and the
subcommands `filter`, `ngsqc`, `filterreads`, `kangar`, `kangapr` and
`kmerdist` byte for byte (tests/cli_parity.py).  The port runs with
`--device cpu`; tests/test_torch_cuda.py holds the card against it."""
import numpy as np
import pytest
import torch

import readprep_reads as rp
from biokanga_tpu.align.pipeline import pad_rows as jax_pad_rows
from biokanga_tpu.seq.contaminants import Contaminants as JaxContaminants
from biokanga_tpu.seq.encode import ascii_to_codes, revcomp
from biokanga_tpu.seq.fasta import write_fasta, write_fastq
from biokanga_tpu.seq.rds import write_rds
from biokanga_tpu.sim.simreads import random_genome
from biokanga_tpu.tools.filter_reads import \
    near_duplicate_mask as jax_near_dups
from biokanga_tpu_torch.align.pipeline import pad_rows
from biokanga_tpu_torch.seq.contaminants import Contaminants
from biokanga_tpu_torch.tools.filter_reads import near_duplicate_mask
from cli_parity import check_subcommand

CPU = torch.device("cpu")
CPU_FLAG = ("--device", "cpu")


def _contam_db(path):
    """Flank entries of every code (default 5', 3', rc codes 5-8) and
    vectors for PE1 only (both strands), PE2 only and both mates."""
    ad = ascii_to_codes(b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCAC")
    vecs = random_genome([("a", 700), ("b", 500), ("c", 400)], seed=71)
    write_fasta(str(path), [
        ("plain5", ad[::-1].copy()),
        ("ad3@34", ad),
        ("ad5@12", ad[:20].copy()),
        ("rc@5678", ad[5:30].copy()),
        ("tiny@3", ad[:3].copy()),               # shorter than 4: dropped
        ("vecA&15", vecs[0][1]),
        ("vecB&26", vecs[1][1]),
        ("vecC&1256", vecs[2][1]),
    ])
    return ad, [v for _, v in vecs]


def _block(ad, vecs, n=300, seed=72):
    """(reads, lengths): ragged reads of 60-120 bp, some contained in a
    vector (either strand), some with adaptor overlays at either end."""
    rng = np.random.default_rng(seed)
    L = 120
    reads = rng.integers(0, 4, (n, L)).astype(np.int8)
    lengths = rng.integers(60, L + 1, n).astype(np.int32)
    for i in range(n):
        ln = int(lengths[i])
        kind = i % 6
        if kind in (0, 1):
            v = vecs[i % 3]
            s = int(rng.integers(0, len(v) - ln))
            r = v[s:s + ln].copy()
            if kind == 1:
                r = revcomp(r)
            sub = rng.random(ln) < 0.02
            r[sub] = (r[sub] + 1) % 4
            reads[i, :ln] = r
        elif kind == 2:
            t = int(rng.integers(5, 30))
            reads[i, ln - t:ln] = ad[:t]
        elif kind == 3:
            t = int(rng.integers(5, 20))
            reads[i, :t] = ad[::-1][-t:]
        reads[i, ln:] = 4
    return reads, lengths


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """The contaminant FASTA of _contam_db loaded by both packages (one
    pair of vector engines for the module: the JAX one compiles once a
    shape)."""
    path = tmp_path_factory.mktemp("contam") / "c.fa"
    ad, vecs = _contam_db(path)
    return (path, ad, vecs, Contaminants.load(str(path), "cpu"),
            JaxContaminants.load(str(path)))


def test_contaminant_db_matches_jax(dbs):
    path, ad, vecs, tdb, jdb = dbs
    reads, lengths = _block(ad, vecs)
    assert [(f.name, f.types, f.rc) for f in tdb.flank] == \
        [(f.name, f.types, f.rc) for f in jdb.flank]
    assert [(v.name, v.pe1, v.pe2, v.rc) for v in tdb.vectors] == \
        [(v.name, v.pe1, v.pe2, v.rc) for v in jdb.vectors]
    for ctype in range(4):
        for ov, rate in ((1, 1), (5, 0), (8, 2)):
            np.testing.assert_array_equal(
                tdb.match_flank(reads, lengths, ctype, ov, rate),
                jdb.match_flank(reads, lengths, ctype, ov, rate))
    for is_pe2 in (False, True, False):
        got = tdb.match_vectors(reads, lengths, is_pe2=is_pe2)
        want = jdb.match_vectors(reads, lengths, is_pe2=is_pe2)
        np.testing.assert_array_equal(got, want)
        assert got.sum() > 20
    assert tdb.report_rows() == jdb.report_rows()
    for a, b in zip(tdb.flank, jdb.flank):
        np.testing.assert_array_equal(a.hit_dist, b.hit_dist)


@pytest.mark.parametrize("n", [300, 64, 1])
def test_vector_screen_engine_result_matches_jax(dbs, n):
    """The aligner's hits on the padded block the screen runs (match_vectors
    maps their loci to vectors through entry_starts), as the JAX engine
    gives them; a one-read block pads to 64 rows."""
    path, ad, vecs, tdb, jdb = dbs
    reads, lengths = _block(ad, vecs, n=n, seed=73 + n)
    engine, idx = tdb._vector_engine()
    jengine, jidx = jdb._vector_engine()
    np.testing.assert_array_equal(idx.entry_starts, jidx.entry_starts)
    r, ln = pad_rows(reads, lengths)
    jr, jln = jax_pad_rows(reads, lengths)
    np.testing.assert_array_equal(r, jr)
    res = engine.align_with_rescue(r, ln)
    want = jengine.align_with_rescue(jr, jln)
    for key in ("any_hit", "locus", "unique", "is_rc", "best_mm"):
        np.testing.assert_array_equal(np.asarray(res[key]),
                                      np.asarray(want[key]), err_msg=key)
    assert res["any_hit"][:n].sum() >= n // 3


def test_vector_screen_device_is_explicit(dbs, monkeypatch):
    """The database takes its device when it loads: without one it still
    matches flanks on the host, and its vector screen raises; cuda
    without a card raises at load."""
    path, ad, vecs, _, _ = dbs
    reads, lengths = _block(ad, vecs, n=40)
    db = Contaminants.load(str(path))
    assert db.match_flank(reads, lengths, 2).any()
    with pytest.raises(ValueError, match="device"):
        db.match_vectors(reads, lengths)
    db = Contaminants.load(str(path), "cpu")
    assert db.device == CPU and db.match_vectors(reads, lengths).any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Contaminants.load(str(path), "cuda")


def test_near_duplicate_mask_matches_jax():
    rng = np.random.default_rng(74)
    seqs = []
    for i in range(400):
        L = int(rng.choice([40, 80, 80, 80, 12]))
        if i > 10 and rng.random() < 0.4:
            s = seqs[int(rng.integers(0, i))].copy()
            for _ in range(int(rng.integers(0, 5))):
                p = int(rng.integers(0, len(s)))
                s[p] = (s[p] + int(rng.integers(1, 5))) % 5
        else:
            s = rng.integers(0, 5 if i % 9 == 0 else 4, L).astype(np.int8)
        seqs.append(s.astype(np.int8))
    for max_subs, anchors in ((2, (0, 16)), (0, (0,)), (4, (0, 16, 32)),
                              (1, (70,))):
        got = near_duplicate_mask(seqs, max_subs, anchors)
        np.testing.assert_array_equal(
            got, jax_near_dups(seqs, max_subs, anchors))
    assert near_duplicate_mask(seqs).sum() > 20
    assert near_duplicate_mask([]).shape == (0,)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The planted PE library of tests/readprep_reads.py (3,000 pairs, one
    partial block; and 8,192 + 100 pairs: a full block and a partial one),
    its contaminant FASTA, a plain adaptor FASTA, and SE reads with
    varying qualities, Ns and duplicates."""
    d = tmp_path_factory.mktemp("readprep_in")
    g = random_genome([("chr", 200_000)], seed=75)[0][1]
    for tag, n in (("", 3_000), ("big_", 8_292)):
        names, r1, r2, _ = rp.library(g, n, seed=76)
        q = np.random.default_rng(77).integers(35, 74, (n, rp.READ_LEN))
        for m, r in ((1, r1), (2, r2)):
            write_fastq(str(d / f"{tag}r{m}.fq"),
                        ((nm, c, bytes(qq.astype(np.uint8)))
                         for nm, c, qq in zip(names, r, q)))
        (d / f"{tag}names.txt").write_text("\n".join(names))
    write_fasta(str(d / "contam.fa"), rp.contaminant_entries(76))
    write_fasta(str(d / "adaptors.fa"),
                [("a1", ascii_to_codes(rp.ADAPTER_R1[:13])),
                 ("a2", ascii_to_codes(rp.ADAPTER_R2[:20]))])
    rng = np.random.default_rng(78)
    se = rng.integers(0, 4, (500, 90)).astype(np.int8)
    se[10:60:5] = se[9:59:5]                                 # duplicates
    se[100:110, 20:24] = 4                                   # Ns
    se[200:220, -12:] = ascii_to_codes(rp.ADAPTER_R1[:12])
    ln = rng.integers(40, 91, 500)
    qual = rng.integers(35, 74, (500, 90)).astype(np.uint8)
    write_fastq(str(d / "se.fq"), ((f"s{i}", se[i, :ln[i]],
                                    bytes(qual[i, :ln[i]]))
                                   for i in range(500)))
    write_fasta(str(d / "se.fa"), ((f"f{i}", se[i, :ln[i]])
                                   for i in range(0, 500, 2)))
    write_rds(str(d / "pe.rds.npz"), ((f"s{i}", se[i, :ln[i]])
                                      for i in range(500)),
              pe_interleaved=True)
    return d


FILTER_CASES = [
    ("se", ["-i", "{i}/se.fq", "-o", "o.fq"]),
    ("se-options", ["-i", "{i}/se.fq", "-o", "o.fq", "--trim5", "3",
                    "--trim3", "2", "-n", "2", "--min-phred", "20",
                    "--min-len", "30"]),
    ("se-no-dedupe", ["-i", "{i}/se.fq", "-o", "o.fq", "--no-dedupe",
                      "-n", "0"]),
    ("se-near-dedupe", ["-i", "{i}/r1.fq", "-o", "o.fq", "--near-dedupe",
                        "--near-max-subs", "3"]),
    ("se-adaptor-fasta", ["-i", "{i}/se.fq", "-o", "o.fq", "-c",
                          "{i}/adaptors.fa", "--min-len", "40"]),
    ("se-contam", ["-i", "{i}/r1.fq", "-o", "o.fq", "-c", "{i}/contam.fa",
                   "--trim5", "2"]),
    ("pe", ["-i", "{i}/r1.fq", "-u", "{i}/r2.fq", "-o", "o1.fq", "-U",
            "o2.fq"]),
    ("pe-contam", ["-i", "{i}/r1.fq", "-u", "{i}/r2.fq", "-o", "o1.fq",
                   "-U", "o2.fq", "-c", "{i}/contam.fa", "--near-dedupe"]),
    ("pe-contam-partial-block", ["-i", "{i}/big_r1.fq", "-u",
                                 "{i}/big_r2.fq", "-o", "o1.fq", "-U",
                                 "o2.fq", "-c", "{i}/contam.fa",
                                 "--near-dedupe"]),
]


@pytest.mark.parametrize("case,argv", FILTER_CASES,
                         ids=[c[0] for c in FILTER_CASES])
def test_filter_matches_jax_cli(lib, tmp_path, capsys, monkeypatch, case,
                                argv):
    argv = ["filter"] + [a.replace("{i}", str(lib)) for a in argv]
    out, names = check_subcommand(tmp_path, argv, capsys, monkeypatch,
                                  torch_extra=CPU_FLAG)
    assert out.startswith("filter: ")
    if case == "pe-contam-partial-block":
        # the planted artefacts: the bars chip_smoke.py phase 29 holds the
        # card to are what the JAX CLI reaches here
        shares = rp.planted_shares(
            (lib / "big_names.txt").read_text().split("\n"),
            rp.fastq_name_lengths(tmp_path / "jax" / "o1.fq"))
        assert shares["n_vector"] >= 60 and shares["n_adapter"] >= 200
        assert shares["vector_rejected"] >= rp.MIN_VECTOR_REJECTED
        assert shares["adapter_trimmed"] >= rp.MIN_ADAPTER_TRIMMED


NGSQC_CASES = [
    ("plain", ["-i", "{i}/se.fq", "-o", "qc.html", "-k", "4"]),
    ("contam", ["-i", "{i}/r1.fq", "-o", "qc.html", "-c", "{i}/contam.fa"]),
    ("max-reads", ["-i", "{i}/r2.fq", "-i", "{i}/se.fq", "-o", "qc.html",
                   "--max-reads", "500", "-c", "{i}/contam.fa", "-k", "3"]),
    ("fasta", ["-i", "{i}/se.fa", "-o", "qc.html"]),
]


@pytest.mark.parametrize("case,argv", NGSQC_CASES,
                         ids=[c[0] for c in NGSQC_CASES])
def test_ngsqc_matches_jax_cli(lib, tmp_path, capsys, monkeypatch, case,
                               argv):
    argv = ["ngsqc"] + [a.replace("{i}", str(lib)) for a in argv]
    out, names = check_subcommand(tmp_path, argv, capsys, monkeypatch,
                                  torch_extra=CPU_FLAG)
    assert names == ["qc.html"] and out.startswith("ngsqc: ")


HOST_READ_CASES = [
    ("kangar", ["kangar", "-i", "{i}/se.fq", "-i", "{i}/se.fa", "-o",
                "o.rds.npz", "-x", "2", "-y", "3", "--max-ns", "1"]),
    ("kangar-pe", ["kangar", "-i", "{i}/r1.fq", "-u", "{i}/r2.fq", "-o",
                   "o.rds.npz"]),
    ("filterreads", ["filterreads", "-i", "{i}/pe.rds.npz", "-o",
                     "o.rds.npz", "--min-len", "60", "--max-len", "95",
                     "--max-ns", "0", "--dedupe", "-x", "1", "-y", "4"]),
    ("kangapr", ["kangapr", "-i", "{i}/se.fq", "-o", "o.fq", "-s", "3",
                 "-S", "7", "-M", "40"]),
    ("kangapr-pe", ["kangapr", "-m", "1", "-i", "{i}/r1.fq", "-I",
                    "{i}/r2.fq", "-o", "o1.fq", "-O", "o2.fq", "-S", "5"]),
    ("kangapr-fasta", ["kangapr", "-i", "{i}/se.fa", "-o", "o.fa", "-S",
                       "2"]),
    ("kmerdist", ["kmerdist", "-i", "{i}/se.fa", "-i", "{i}/contam.fa",
                  "-o", "o.csv", "-k", "3"]),
]


@pytest.mark.parametrize("case,argv", HOST_READ_CASES,
                         ids=[c[0] for c in HOST_READ_CASES])
def test_host_read_tool_matches_jax_cli(lib, tmp_path, capsys, monkeypatch,
                                        case, argv):
    argv = [a.replace("{i}", str(lib)) for a in argv]
    out, _ = check_subcommand(tmp_path, argv, capsys, monkeypatch)
    assert out.startswith(argv[0] + ":")
