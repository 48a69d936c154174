"""De novo assembly of the port against the JAX package: the host-verified
pass and the tools around it (the scaled pass and `contigs` are in
tests/test_torch_assembly_scaled.py).

Inputs are made from numpy seeds: tiled and simulated reads of random
genomes (both orientations, a few substitutions, planted duplicates and
contained fragments), two contigs with PE reads across their gap, and
long sequences with indels.  Candidates, verified overlaps, merged
sequences and kept sequences must be equal; the FASTA of `assemb` and
`scaffold`, and the CSV of `pescaffold`, must be byte-identical to the
JAX CLI's.  The port runs on the CPU.
"""
import numpy as np
import pytest
import torch

from biokanga_tpu.assembly import assemble as jas
from biokanga_tpu.assembly import overlap as jov
from biokanga_tpu.assembly import scaffold as jsc
from biokanga_tpu.cli import main as jax_main
from biokanga_tpu.seq.encode import revcomp
from biokanga_tpu.seq.fasta import write_fasta, write_fastq
from biokanga_tpu.sim.simreads import random_genome
from biokanga_tpu_torch.assembly import assemble as tas
from biokanga_tpu_torch.assembly import overlap as tov
from biokanga_tpu_torch.assembly import scaffold as tsc
from biokanga_tpu_torch.cli import main as torch_main

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _reads(glen, n, L, seed, rc_frac=0.5, sub=0.003):
    rng = np.random.default_rng(seed)
    g = random_genome([("g", glen)], seed=seed)[0][1]
    out = []
    for s in rng.integers(0, glen - L, n):
        r = g[s:s + L].copy()
        m = rng.random(L) < sub
        r[m] = (r[m] + 1) % 4
        out.append(revcomp(r) if rng.random() < rc_frac else r)
    out += [out[0].copy(), out[1][:L - 30].copy(), revcomp(out[2])]
    return g, out


def _same_seqs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_overlap_candidates_and_verify_match_jax():
    _, seqs = _reads(3_000, 80, 100, seed=1)
    L = max(len(s) for s in seqs)
    q = np.full((2 * len(seqs), L), 4, np.int8)
    ql = np.zeros(2 * len(seqs), np.int32)
    for i, s in enumerate(seqs + [revcomp(s) for s in seqs]):
        q[i, :len(s)], ql[i] = s, len(s)
    jc, _ = jov.find_prefix_occurrences(seqs, q, ql, k=16,
                                        anchor_offsets=(0, 8, 16, 32))
    tc, _ = tov.find_prefix_occurrences(seqs, q, ql, k=16,
                                        anchor_offsets=(0, 8, 16, 32),
                                        device=CPU)
    for f in ("qids", "qoffs", "tids", "toffs"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    assert len(jc.qids) > 500
    for mo in (30, 60):
        want = jov.verify_overlaps(seqs, q, ql, jc, mo, 1.0)
        got = tov.verify_overlaps(seqs, q, ql, tc, mo, 1.0)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        assert len(want[0]) > 20


@pytest.mark.parametrize("min_ov", [40, 70])
def test_one_pass_and_containment_match_jax(min_ov):
    _, reads = _reads(5_000, 250, 100, seed=2)
    a, ma = jas.one_pass([r.copy() for r in reads], min_ov)
    b, mb = tas.one_pass([r.copy() for r in reads], min_ov, device=CPU)
    assert mb == ma > 0
    _same_seqs(a, b)
    _same_seqs(jas.remove_contained(a), tas.remove_contained(b, device=CPU))
    assert len(jas.remove_contained(reads)) < len(reads)


def test_assemble_host_pass_matches_jax():
    _, reads = _reads(2_500, 120, 100, seed=3, sub=0.0)
    want, ws = jas.assemble(reads, init_overlap=80, final_overlap=40,
                            scaled=False, max_passes=5)
    got, gs = tas.assemble(reads, init_overlap=80, final_overlap=40,
                           scaled=False, max_passes=5, device=CPU)
    _same_seqs(want, got)
    assert vars(gs) == vars(ws) and ws.merges > 0


def test_kmer_containment_dedup_matches_jax():
    rng = np.random.default_rng(4)
    big = rng.integers(0, 4, 5_000).astype(np.int8)
    seqs = [big, np.concatenate([big[100:2100], big[2101:4100]]),
            revcomp(np.concatenate([big[500:1500], [2], big[1500:3000]])
                    ).astype(np.int8),
            rng.integers(0, 4, 1_200).astype(np.int8), big[:20].copy()]
    seqs[3][rng.random(1_200) < 0.01] = 4
    for k, frac in ((32, 0.98), (16, 0.9)):
        _same_seqs(jas.kmer_containment_dedup(seqs, k, frac),
                   tas.kmer_containment_dedup(seqs, k, frac))


def test_assemb_cli_matches_jax(tmp_path):
    _, reads = _reads(1_500, 70, 100, seed=5)
    write_fasta(str(tmp_path / "a.fa"), ((f"r{i}", r) for i, r in
                                         enumerate(reads[:30])))
    write_fastq(str(tmp_path / "b.fq"), ((f"s{i}", r, None) for i, r in
                                         enumerate(reads[30:])))
    args = ["-i", str(tmp_path / "a.fa"), "-i", str(tmp_path / "b.fq"),
            "--init-overlap", "50", "--final-overlap", "50"]
    assert jax_main(["assemb", "-o", str(tmp_path / "j.fa")] + args) == 0
    assert torch_main(["assemb", "-o", str(tmp_path / "t.fa"), "--device",
                       "cpu"] + args) == 0
    want = (tmp_path / "j.fa").read_bytes()
    assert (tmp_path / "t.fa").read_bytes() == want
    assert want.count(b">") < len(reads) // 2


@pytest.fixture(scope="module")
def two_contigs(tmp_path_factory):
    """Two contigs of a 6 kb genome with a gap of 200 (the second stored
    reverse-complemented), PE reads across the gap and inside the
    contigs, as FASTA mate files (the JAX `scaffold` reads its mates in
    one block of 2^30 rows, which its native FASTQ parser cannot
    allocate), and their SAM from the JAX `align`."""
    d = tmp_path_factory.mktemp("torch_scaffold")
    g = random_genome([("s", 6_000)], seed=33)[0][1]
    c1, c2 = g[0:2_500].copy(), revcomp(g[2_700:5_500])
    rng = np.random.default_rng(6)
    r1, r2 = [], []
    for p in list(rng.integers(2_050, 2_350, 24)) + list(
            rng.integers(0, 5_400, 40)):
        frag = g[p:p + 500]
        if len(frag) < 500:
            continue
        r1.append(frag[:100].copy())
        r2.append(revcomp(frag[-100:]))
    write_fasta(str(d / "ctg.fa"), [("ctg1", c1), ("ctg2", c2)])
    write_fasta(str(d / "r1.fa"), ((f"p{i}/1", r) for i, r in enumerate(r1)))
    write_fasta(str(d / "r2.fa"), ((f"p{i}/2", r) for i, r in enumerate(r2)))
    assert jax_main(["index", "-i", str(d / "ctg.fa"), "-o",
                     str(d / "ctg.npz"), "--lut-bases", "8"]) == 0
    for m in (1, 2):
        assert jax_main(["align", "-i", str(d / f"r{m}.fa"), "-I",
                         str(d / "ctg.npz"), "-o", str(d / f"pe{m}.sam")]
                        ) == 0
    return d, [c1, c2], r1, r2


def test_scaffold_matches_jax(two_contigs, tmp_path):
    d, contigs, r1, r2 = two_contigs
    a1, a2 = np.stack(r1).astype(np.int8), np.stack(r2).astype(np.int8)
    lens = np.full(len(r1), 100, np.int32)
    want = jsc.scaffold(contigs, a1, lens, a2, lens, insert_size=500)
    got = tsc.scaffold(contigs, a1, lens, a2, lens, insert_size=500,
                       device=CPU)
    _same_seqs(want[0], got[0])
    assert got[1] == want[1] and len(want[1][0]) == 2
    args = ["-c", str(d / "ctg.fa"), "-i", str(d / "r1.fa"), "-u",
            str(d / "r2.fa"), "--insert-size", "500"]
    assert jax_main(["scaffold", "-o", str(tmp_path / "j.fa")] + args) == 0
    assert torch_main(["scaffold", "-o", str(tmp_path / "t.fa"), "--device",
                       "cpu"] + args) == 0
    assert (tmp_path / "t.fa").read_bytes() == (tmp_path / "j.fa").read_bytes()


def test_pescaffold_csv_matches_jax(two_contigs, tmp_path):
    d, _, _, _ = two_contigs
    args = ["-i", str(d / "pe1.sam"), "-u", str(d / "pe2.sam")]
    for votes in ("2", "30"):
        assert jax_main(["pescaffold", "-o", str(tmp_path / "j.csv"),
                         "--min-votes", votes] + args) == 0
        assert torch_main(["pescaffold", "-o", str(tmp_path / "t.csv"),
                           "--min-votes", votes] + args) == 0
        want = (tmp_path / "j.csv").read_bytes()
        assert (tmp_path / "t.csv").read_bytes() == want
    assert b'"ctg1"' in (tmp_path / "t.csv").read_bytes() or votes == "30"
