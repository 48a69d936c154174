"""The chunked SNP pileup: the port's `ChunkedPileup` and
`_seg_candidates` against the JAX package's, tolerance 0.

tests/test_chunked_snp.py's case (a 50 kb genome with planted SNPs, 8,000
reads, three chunks cut inside an entry) goes through both packages'
ChunkedAligner and ChunkedPileup; every call must be equal field for
field, also when the port compacts candidates in segments of 4,096 bases
(the JAX package's segment is 2^25 bases, past this genome).  The JAX
planes are uint16, whose counts wrap past 65,535; the port's are int32
read through a 16-bit mask, so piling 140,000 reads on the same bases, in
a chunk's overlap tail too, must give the JAX package's candidates and
entry totals.  `_seg_candidates` alone is held against the JAX function
on random planes at non-reference shares whose float32 products round.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biokanga_tpu.align import snp as jax_snp
from biokanga_tpu.align.params import AlignParams as JaxParams
from biokanga_tpu.index import chunked as jax_chunked
from biokanga_tpu.parallel.chunked import ChunkedAligner as JaxChunked
from biokanga_tpu.sim.simreads import plant_snps, random_genome, simulate_reads
from biokanga_tpu_torch.align import snp as torch_snp
from biokanga_tpu_torch.align.params import AlignParams
from biokanga_tpu_torch.align.pipeline import pad_rows
from biokanga_tpu_torch.index import chunked as tch
from biokanga_tpu_torch.parallel.chunked import ChunkedAligner, chunk_of
from biokanga_tpu_torch.seq.encode import revcomp

torch.set_num_threads(2)

CALL_FIELDS = ("chrom", "loci", "ref_base", "tot_bases", "nonref",
               "pvalue", "bkgnd_rate", "win_bases", "win_mm", "rank")


def _aligned(reads, lengths, res, acc):
    aligned = reads.copy()
    for i in np.nonzero(res["is_rc"] & acc)[0]:
        aligned[i, :lengths[i]] = revcomp(reads[i, :lengths[i]])
    return aligned


def _jax_calls(ci, res, reads, lengths, sp):
    ca = JaxChunked(ci, JaxParams(batch_size=len(reads)))
    cp = jax_snp.ChunkedPileup(ci.bases, [c.total_len for c in ci.chunks],
                               ci.owned, ci.overlap)
    for k in range(ci.num_chunks):
        eng = ca.engine_for(k)
        cp.start_chunk(k, int(eng.didx.genome.shape[0]))
        acc = res["unique"] & (chunk_of(ci.bases, res["locus"]) == k)
        cp.add_batch(eng.didx.genome, (res["locus"] - ci.bases[k]),
                     _aligned(reads, lengths, res, acc), lengths, acc)
        cp.finish_chunk(eng.didx.genome, np.clip(
            ci.entry_starts - ci.bases[k], 0, ci.chunks[k].total_len), sp)
    return cp


def _torch_calls(ci, res, reads, lengths, sp):
    ca = ChunkedAligner(ci, AlignParams(batch_size=len(reads)), "cpu")
    cp = torch_snp.ChunkedPileup(ci.bases, [c.total_len for c in ci.chunks],
                                 ci.owned, ci.overlap)
    for k in range(ci.num_chunks):
        genome = ca.engine_for(k).didx.genome
        cp.start_chunk(k, int(genome.shape[0]), "cpu")
        acc = res["unique"] & (chunk_of(ci.bases, res["locus"]) == k)
        cp.add_batch(genome, (res["locus"] - ci.bases[k]),
                     _aligned(reads, lengths, res, acc), lengths, acc)
        cp.finish_chunk(genome, np.clip(
            ci.entry_starts - ci.bases[k], 0, ci.chunks[k].total_len), sp)
    return cp


def _ref_base(ci):
    def ref(e, loci):
        g = int(ci.entry_starts[e]) + int(loci)
        k = int(chunk_of(ci.bases, g))
        return int(ci.chunks[k].codes[g - int(ci.bases[k])])
    return ref


def _assert_calls_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in CALL_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert a.base_cnts.dtype == b.base_cnts.dtype
        np.testing.assert_array_equal(a.base_cnts, b.base_cnts)


@pytest.fixture(scope="module")
def snp_case():
    seqs = random_genome([("c1", 30000), ("c2", 20000)], seed=31)
    mut, snps = plant_snps(seqs, snp_rate_per_mbp=600, seed=2)
    _, reads, _ = simulate_reads(mut, 8000, read_len=100, sub_rate=0.002,
                                 seed=4)
    lengths = np.full(len(reads), 100, np.int32)
    reads, lengths = pad_rows(reads, lengths)
    ci_j = jax_chunked.build_chunked_index(seqs, num_chunks=3, overlap=256,
                                           lut_bases=10)
    ci_t = tch.build_chunked_index(seqs, num_chunks=3, overlap=256,
                                   lut_bases=10)
    res = ChunkedAligner(ci_t, AlignParams(batch_size=len(reads)),
                         "cpu").align(reads, lengths)
    return ci_j, ci_t, res, reads, lengths, snps


@pytest.mark.parametrize("segment", [1 << 25, 4096])
def test_chunked_pileup_calls_match_jax(snp_case, segment, monkeypatch):
    ci_j, ci_t, res, reads, lengths, snps = snp_case
    monkeypatch.setattr(torch_snp, "SNP_SEGMENT", segment)
    sp_j = jax_snp.SNPParams(min_snp_reads=5)
    sp_t = torch_snp.SNPParams(min_snp_reads=5)
    cj = _jax_calls(ci_j, res, reads, lengths, sp_j)
    ct = _torch_calls(ci_t, res, reads, lengths, sp_t)
    assert ct.ent_m.dtype == cj.ent_m.dtype
    np.testing.assert_array_equal(ct.ent_m, cj.ent_m)
    np.testing.assert_array_equal(ct.ent_mm, cj.ent_mm)
    want = cj.finalize_calls(_ref_base(ci_j), ci_j.entry_names,
                             ci_j.entry_starts, sp_j)
    got = ct.finalize_calls(_ref_base(ci_t), ci_t.entry_names,
                            ci_t.entry_starts, sp_t)
    _assert_calls_equal(got, want)
    truth = {(c, o) for c, o, _, _ in snps}
    assert len({(c.chrom, c.loci) for c in got} & truth) / len(truth) > 0.85


def test_pileup_planes_wrap_as_the_jax_uint16_planes():
    """140,000 reads on each of three loci, in a chunk's overlap tail and
    in its owned range, half of them with a substitution at their second
    base: both base counts there pass 65,535."""
    rng = np.random.default_rng(5)
    # chunk 0 owns [0, 2,500); reads at 2,495 run into its overlap tail
    seqs = [("e1", rng.integers(0, 4, 3_000).astype(np.int8)),
            ("e2", rng.integers(0, 4, 2_000).astype(np.int8))]
    ci = tch.build_chunked_index(seqs, num_chunks=2, overlap=200,
                                 lut_bases=6)
    cat = np.concatenate([s for _, s in seqs])
    deep = 140_000
    loci = np.concatenate([np.full(deep, 1_200), np.full(deep, 2_495),
                           np.full(deep, 3_600), rng.integers(0, 4_990, 500)])
    B = len(loci)
    reads = cat[loci[:, None] + np.arange(10)].copy()
    reads[: deep // 2, 1] = (reads[: deep // 2, 1] + 1) % 4   # a "SNP"
    lengths = np.full(B, 10, np.int32)
    res = {"unique": np.ones(B, bool), "locus": loci.astype(np.int64),
           "is_rc": np.zeros(B, bool)}
    outs = []
    for mod, cp_cls in ((jax_snp, jax_snp.ChunkedPileup),
                        (torch_snp, torch_snp.ChunkedPileup)):
        sp = mod.SNPParams(min_snp_reads=5)
        cp = cp_cls(ci.bases, [c.total_len for c in ci.chunks], ci.owned,
                    ci.overlap)
        pad_n = ci.pad_shapes()[0]
        for k in range(ci.num_chunks):
            g = np.full(pad_n, 4, np.int8)
            g[:ci.chunks[k].total_len] = ci.chunks[k].codes
            args = (k, pad_n) if mod is jax_snp else (k, pad_n, "cpu")
            cp.start_chunk(*args)
            genome = jnp.asarray(g) if mod is jax_snp else torch.from_numpy(g)
            acc = chunk_of(ci.bases, loci) == k
            cp.add_batch(genome, loci - ci.bases[k], reads, lengths, acc)
            cp.finish_chunk(genome, np.clip(
                ci.entry_starts - ci.bases[k], 0, ci.chunks[k].total_len),
                sp)
        outs.append((cp, cp.finalize_calls(_ref_base(ci), ci.entry_names,
                                           ci.entry_starts, sp)))
    (cj, want), (ct, got) = outs
    assert len(ct.cand_rows) == len(cj.cand_rows) > 0
    for a, b in zip(ct.cand_rows, cj.cand_rows):
        assert a[0] == b[0] and a[2:] == b[2:]
        np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(ct.ent_m, cj.ent_m)
    np.testing.assert_array_equal(ct.ent_mm, cj.ent_mm)
    _assert_calls_equal(got, want)
    # the wrap is there: the substituted base's total reads 2 x (70,000
    # mod 65,536) from the uint16 planes
    assert any(int(r[2]) == 2 * (deep // 2 % 65_536) for r in ct.cand_rows)


@pytest.mark.parametrize("frac", [0.25, 0.3, 0.33, 0.1])
def test_seg_candidates_match_jax(frac):
    rng = np.random.default_rng(int(frac * 100))
    W, E = 6_000, 4
    counts = rng.integers(0, 12, (W, 4)).astype(np.int32)
    counts[rng.random(W) < 0.5] = 0
    counts[:50] = rng.integers(60_000, 65_535, (50, 4))
    match = rng.integers(0, 30, W).astype(np.int32)
    mismatch = rng.integers(0, 4, W).astype(np.int32)
    genome = rng.integers(0, 5, W).astype(np.int8)
    es = np.array([0, 900, 2_500, 2_500, 7_000], np.int32)
    cap, lo, hi, base = 300, 40, 5_900, 1_000
    want = jax_snp._seg_candidates(
        jnp.asarray(counts.astype(np.uint16)),
        jnp.asarray(match.astype(np.uint16)),
        jnp.asarray(mismatch.astype(np.uint16)), jnp.asarray(genome),
        jnp.asarray(es), jnp.int32(base), 5, frac, cap=cap, core_lo=lo,
        core_hi=hi)
    want = [np.asarray(x) for x in want]
    t = torch.from_numpy
    got = torch_snp._seg_candidates(t(counts), t(match), t(mismatch),
                                    t(genome), t(es), base, 5, frac, cap, lo,
                                    hi)
    m = len(got[0])
    assert 0 < m <= cap and (want[0][m:] == W).all()
    np.testing.assert_array_equal(got[0], want[0][:m])
    for g, w in zip(got[1:6], want[1:6]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w[:m])
    for g, w in zip(got[6:], want[6:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
