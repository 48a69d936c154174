"""The port's `mergeoverlaps`, `findapproxmatches`, NW scores and marker
tools against the JAX package: the library functions on seeded numpy
inputs with their edge cases, and each subcommand's files byte for byte
(`mergeoverlaps` modes 0-3, `findapproxmatches`, `kmarkers`,
`prekmarkers`, `locmarkers`, `snpmarkers`, `genmarkers`,
`markerseqs`).  The port runs on the CPU."""
import filecmp

import numpy as np
import pytest
import torch

from biokanga_tpu.align.snp import SNPCall, write_snps_csv
from biokanga_tpu.cli import main as jax_main
from biokanga_tpu.index.build import build_index as jax_build
from biokanga_tpu.ops import nw as jnw
from biokanga_tpu.ops.shortmatch import find_short_matches as jax_matches
from biokanga_tpu.seq.encode import revcomp
from biokanga_tpu.seq.fasta import write_fasta, write_fastq
from biokanga_tpu.sim.simreads import random_genome
from biokanga_tpu.tools import markers as jmk
from biokanga_tpu.tools import mergeoverlaps as jmo
from biokanga_tpu_torch.cli import main as torch_main
from biokanga_tpu_torch.index.build import build_index as torch_build
from biokanga_tpu_torch.ops import nw as tnw
from biokanga_tpu_torch.ops.shortmatch import find_short_matches
from biokanga_tpu_torch.tools import markers as tmk
from biokanga_tpu_torch.tools import mergeoverlaps as tmo

CPU = torch.device("cpu")


def _amplicon_pairs(n: int, seed: int, L: int = 60):
    """Pairs of L-base reads from barcoded amplicons of 70-110 bases,
    with edge cases: an N in a barcode, pairs that do not overlap, a
    merge shorter than two barcodes, overlaps whose 3' barcode straddles
    both reads, substitutions, shorter second reads, a wrong barcode."""
    rng = np.random.default_rng(seed)
    cols = [jmo._codes(s) for s in jmo._COL_BARCODES]
    rows = [jmo._codes(s) for s in jmo._ROW_BARCODES]
    r1s, r2s = [], []
    for i in range(n):
        ins = int(rng.integers(70, 111))
        body = rng.integers(0, 4, ins - 12).astype(np.int8)
        frag = np.concatenate([cols[i % 12], body, revcomp(rows[i % 8])])
        if i % 3 == 1:            # row barcode at the 5' end instead
            frag = np.concatenate([rows[i % 8], body, revcomp(cols[i % 12])])
        r1, r2 = frag[:L].copy(), revcomp(frag[-L:]).copy()
        kind = i % 11
        if kind == 1:
            r1[2] = 4
        elif kind == 2:
            r2 = rng.integers(0, 4, L).astype(np.int8)
        elif kind == 3:
            r1 = frag[:8].copy()
            r2 = revcomp(frag[:8]).copy()
        elif kind == 4:
            r2[rng.integers(0, L, 3)] = rng.integers(0, 4, 3)
        elif kind == 5:
            r2 = r2[:L - 7]
        elif kind == 6:
            r1[:6] = jmo._codes("GGGGGG")
        r1s.append(r1)
        r2s.append(r2)
    return r1s, r2s


def _padded(rows, L):
    out = np.full((len(rows), L), 4, np.int8)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def test_merge_pairs_arrays_matches_jax():
    r1, r2 = _amplicon_pairs(120, 1)
    a, b = _padded(r1, 60), _padded(r2, 60)
    for p in (jmo.MergeParams(), jmo.MergeParams(8, 10.0)):
        want = jmo.merge_pairs_arrays(a, b, p)
        got = tmo.merge_pairs_arrays(a, b, tmo.MergeParams(*p.__dict__.values()),
                                     CPU)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        for x, y in zip(got[0], want[0]):
            assert (x is None and y is None) or np.array_equal(x, y)


@pytest.fixture(scope="module")
def pair_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mo")
    r1, r2 = _amplicon_pairs(300, 2)
    write_fastq(str(d / "r1.fq"), ((f"p{i}", r, None) for i, r in enumerate(r1)))
    write_fastq(str(d / "r2.fq"), ((f"p{i}", r, None) for i, r in enumerate(r2)))
    return d


@pytest.mark.parametrize("mode,out", [(0, "m.fastq"), (1, "m.fasta"),
                                      (2, "amp"), (3, "amp")])
def test_mergeoverlaps_cli_matches_jax(pair_files, mode, out):
    d = pair_files
    files = {}
    for tag, run, dev in (("jax", jax_main, []),
                          ("torch", torch_main, ["--device", "cpu"])):
        od = d / f"{tag}{mode}"
        od.mkdir(exist_ok=True)
        argv = ["mergeoverlaps", "-i", str(d / "r1.fq"), "-u",
                str(d / "r2.fq"), "-m", str(mode), "-o", str(od / out),
                "-l", "10"]
        if mode < 2:
            argv += ["--unmerged1", str(od / "u1.fq"), "--unmerged2",
                     str(od / "u2.fq")]
        assert run(argv + dev) == 0
        files[tag] = sorted(p.name for p in od.iterdir())
    assert files["jax"] == files["torch"] and len(files["jax"]) >= 2
    for name in files["jax"]:
        assert filecmp.cmp(d / f"jax{mode}" / name, d / f"torch{mode}" / name,
                           shallow=False), name


def test_find_short_matches_matches_jax():
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 6000).astype(np.int8)
    g[100:130] = 4
    qs = [g[s:s + 23].copy() for s in (10, 1500, 2040, 5977)]
    qs[1][[3, 9]] = (qs[1][[3, 9]] + 1) % 4
    qs.append(revcomp(g[3000:3023]))
    qs.append(np.where(np.arange(23) == 5, 4, g[400:423]).astype(np.int8))
    for both in (True, False):
        for mm, chunk in ((2, 1 << 20), (3, 1024), (0, 600)):
            want = jax_matches(g, qs, max_mm=mm, both_strands=both,
                               chunk=chunk)
            got = find_short_matches(g, qs, max_mm=mm, both_strands=both,
                                     chunk=chunk, device=CPU)
            assert got == want
    assert len(want) >= 3


@pytest.mark.parametrize("genome", ["fa", "npz"])
def test_findapproxmatches_cli_matches_jax(tmp_path, genome):
    seqs = random_genome([("c1", 4000), ("c2", 3000)], seed=8)
    g = np.concatenate([s for _, s in seqs])
    write_fasta(str(tmp_path / "g.fa"), seqs)
    if genome == "npz":
        assert jax_main(["index", "-i", str(tmp_path / "g.fa"), "-o",
                         str(tmp_path / "g.npz"), "--lut-bases", "8"]) == 0
    qs = [("a", g[100:123]), ("b", revcomp(g[5000:5023])),
          ("c", g[3990:4013]), ("short", g[200:215]),
          ("d", np.where(np.arange(23) % 7 == 0, 0, g[6000:6023]))]
    write_fasta(str(tmp_path / "q.fa"), qs)
    for strand in ("both", "sense"):
        argv = ["findapproxmatches", "-i", str(tmp_path / "q.fa"), "-I",
                str(tmp_path / f"g.{genome}"), "-s", "3", "-Q", strand]
        assert jax_main(argv + ["-o", str(tmp_path / "j.csv")]) == 0
        assert torch_main(argv + ["-o", str(tmp_path / "t.csv"), "--device",
                                  "cpu"]) == 0
        want = (tmp_path / "j.csv").read_bytes()
        assert (tmp_path / "t.csv").read_bytes() == want
        assert want.count(b"\n") >= 5


def test_nw_score_batch_matches_jax():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 5, (24, 40)).astype(np.int8)
    b = a[:, 3:35].copy()
    m = rng.random(b.shape) < 0.2
    b[m] = rng.integers(0, 5, int(m.sum()))
    for scores in ((), (2, -3, -5, -2)):
        want = jnw.nw_score_batch(a, b, *scores)
        got = tnw.nw_score_batch(a, b, *scores, device=CPU)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
    assert got[0] == tnw.nw_score_numpy(a[0], b[0], *scores)


def _cultivars():
    rng = np.random.default_rng(42)
    a = rng.integers(0, 4, size=3000).astype(np.int8)
    b = rng.integers(0, 4, size=2500).astype(np.int8)
    c = rng.integers(0, 4, size=1200).astype(np.int8)
    b[1000:1500] = a[1000:1500]
    a[2000:2010] = 4
    c[100:400] = a[100:400]
    c[900:1100] = c[200:400]
    return [("cultA", a), ("cultB", b), ("cultC1", c), ("cultC2", c[:600])]


@pytest.mark.parametrize("K,min_count,max_other", [(20, 1, 0), (12, 2, 1),
                                                   (32, 1, 0)])
def test_kmer_markers_match_jax(K, min_count, max_other):
    seqs = _cultivars()
    e2c = ["A", "B", "C", "C"]
    want = jmk.kmer_markers(jax_build(seqs, lut_bases=8), e2c, K=K,
                            min_count=min_count, max_other_count=max_other)
    got = tmk.kmer_markers(torch_build(seqs, lut_bases=8), e2c, K=K,
                           min_count=min_count, max_other_count=max_other)
    assert [m.__dict__ for m in got] == [m.__dict__ for m in want]
    assert len(want) > 10


def _call(chrom, loci, ref, alt, cov):
    cnts = np.zeros(4, np.int64)
    cnts[ref] = cov // 2
    cnts[alt] = cov - cov // 2
    return SNPCall(chrom=chrom, loci=loci, ref_base=ref, tot_bases=cov,
                   nonref=cov - cov // 2, base_cnts=cnts, pvalue=1e-9,
                   bkgnd_rate=0.01, win_bases=100, win_mm=1)


@pytest.fixture(scope="module")
def marker_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mk")
    write_snps_csv(str(d / "c1.csv"), [
        _call("chr1", 500, 0, 2, 20), _call("chr1", 900, 1, 3, 8),
        _call("chr2", 30, 2, 0, 12), _call("chr2", 1950, 3, 1, 9)])
    write_snps_csv(str(d / "c2.csv"), [
        _call("chr1", 500, 0, 3, 30), _call("chr1", 40, 1, 0, 3),
        _call("chrX", 70, 1, 2, 40)])
    write_fasta(str(d / "g.fa"), random_genome([("chr1", 2000),
                                                ("chr2", 2000)], seed=1))
    write_fasta(str(d / "cv.fa"), _cultivars())
    for name in ("g", "cv"):
        assert jax_main(["index", "-i", str(d / f"{name}.fa"), "-o",
                         str(d / f"{name}.npz"), "--lut-bases", "8"]) == 0
    return d


def test_snp_markers_and_marker_seqs_match_jax(marker_files):
    d = marker_files
    csvs = {"cv1": str(d / "c1.csv"), "cv2": str(d / "c2.csv")}
    for cov in (1, 5, 10):
        want = jmk.snp_markers(csvs, min_cov=cov)
        got = tmk.snp_markers(csvs, min_cov=cov)
        assert [m.__dict__ for m in got] == [m.__dict__ for m in want]
    idx = torch_build(random_genome([("chr1", 2000), ("chr2", 2000)],
                                    seed=1), lut_bases=8)
    jidx = jax_build(random_genome([("chr1", 2000), ("chr2", 2000)],
                                   seed=1), lut_bases=8)
    for f5, f3 in ((100, 100), (25, 60)):
        want = jmk.marker_seqs(jidx, jmk.snp_markers(csvs, 1), f5, f3)
        got = tmk.marker_seqs(idx, tmk.snp_markers(csvs, 1), f5, f3)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (_, x), (_, y) in zip(got, want):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("sub", ["kmarkers", "prekmarkers", "locmarkers",
                                 "snpmarkers", "genmarkers", "markerseqs"])
def test_marker_cli_matches_jax(marker_files, sub):
    d = marker_files
    argv = {
        "kmarkers": ["-I", str(d / "cv.npz"), "-k", "24", "-c",
                     "cultC1=C", "-c", "cultC2=C", "--max-other", "1"],
        "prekmarkers": ["-I", str(d / "cv.npz"), "-k", "16"],
        "locmarkers": ["-I", str(d / "cv.npz"), "-k", "20", "-c",
                       "cultC1=C", "-c", "cultC2=C", "--min-count", "2"],
        "snpmarkers": ["-i", f"cv1={d / 'c1.csv'}", "-i",
                       f"cv2={d / 'c2.csv'}", "--min-cov", "9"],
        "genmarkers": ["-i", f"b={d / 'c2.csv'}", "-i", f"a={d / 'c1.csv'}"],
        "markerseqs": ["-I", str(d / "g.npz"), "-i", f"cv1={d / 'c1.csv'}",
                       "-i", f"cv2={d / 'c2.csv'}", "--flank5", "30",
                       "--flank3", "45"],
    }[sub]
    assert jax_main([sub, *argv, "-o", str(d / f"{sub}.jax")]) == 0
    assert torch_main([sub, *argv, "-o", str(d / f"{sub}.torch")]) == 0
    want = (d / f"{sub}.jax").read_bytes()
    assert (d / f"{sub}.torch").read_bytes() == want and want.count(b"\n") > 2
