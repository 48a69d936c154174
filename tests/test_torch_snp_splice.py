"""The port's SNP pileup and indel and splice scans against the JAX
package's, on the same seeded inputs (tests/scan_cases.py), exact.

pileup_batch: loci off both ends, Ns in reads, ragged lengths, rejected
reads, on planes that already hold counts.  indel_scan and splice_scan:
genomes with and without Ns, candidates off both ends of the genome,
across entry starts and at INT32_MAX, equal scores in two columns, and
ambiguous junctions (the port must take the rightmost split, as the JAX
package does).  Then ExtendedAligner end to end: the same result dict
as the JAX ExtendedAligner on reads with deletions, insertions, splices
and none.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scan_cases as cases

from biokanga_tpu.align import snp as jsnp
from biokanga_tpu.align import splice_indel as jsi
from biokanga_tpu.align.params import AlignParams as JaxParams
from biokanga_tpu.align.pipeline import AlignEngine as JaxEngine
from biokanga_tpu.align.pipeline import ExtendedAligner as JaxExtended
from biokanga_tpu.index.build import build_index as jax_build_index
from biokanga_tpu.index.device import to_device as jax_to_device
from biokanga_tpu.ops import extend_packed as jep
from biokanga_tpu_torch.align import snp as tsnp
from biokanga_tpu_torch.align import splice_indel as tsi
from biokanga_tpu_torch.align.params import AlignParams
from biokanga_tpu_torch.align.pipeline import AlignEngine, ExtendedAligner
from biokanga_tpu_torch.index.build import build_index
from biokanga_tpu_torch.index.device import to_device
from biokanga_tpu_torch.ops import extend_packed as tep

torch.set_num_threads(2)
CPU = torch.device("cpu")


def test_pileup_batch_matches_jax():
    rng = np.random.default_rng(41)
    g = cases.genome(rng, True)
    n = len(g)
    counts = rng.integers(0, 5, (n, 4)).astype(np.int32)
    match = rng.integers(0, 9, n).astype(np.int32)
    mismatch = rng.integers(0, 3, n).astype(np.int32)
    want = (jnp.asarray(counts), jnp.asarray(match), jnp.asarray(mismatch))
    got = (torch.from_numpy(counts.copy()), torch.from_numpy(match.copy()),
           torch.from_numpy(mismatch.copy()))
    for _ in range(2):
        loci, seqs, lens, acc = cases.pileup_case(rng, g)
        want = jsnp.pileup_batch(*want, jnp.asarray(g), jnp.asarray(loci),
                                 jnp.asarray(seqs), jnp.asarray(lens),
                                 jnp.asarray(acc))
        got = tsnp.pileup_batch(*got, torch.from_numpy(g),
                                torch.from_numpy(loci),
                                torch.from_numpy(seqs),
                                torch.from_numpy(lens), torch.from_numpy(acc))
    for w, t in zip(want, got):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    # the planes moved, and reads off both ends added in part
    assert got[0].sum() > counts.sum() + 40_000
    assert got[0][0].sum() > counts[0].sum()
    assert got[0][-1].sum() > counts[-1].sum()


def _scan_inputs(rng, with_n, L, max_gap):
    g = cases.genome(rng, with_n)
    reads, lens, loci, valid, kinds, n_amb = cases.scan_case(
        rng, g, L=L, max_gap=max_gap)
    jpg = jep.pack_genome(g)
    jrc, jrn = jep.pack_reads(jnp.asarray(reads), jnp.asarray(lens))
    starts = cases.STARTS.astype(np.int32)
    jax_args = (jpg.rows, jpg.n_rows if jpg.has_n else jpg.rows, jpg.has_n,
                jpg.length, jnp.asarray(starts), jnp.asarray(loci),
                jnp.asarray(valid), jrc, jrn, jnp.asarray(lens))
    tpg = tep.pack_genome(g, CPU)
    tr, tl = torch.from_numpy(reads), torch.from_numpy(lens)
    trc, trn = tep.pack_reads(tr, tl)
    torch_args = (tpg, torch.from_numpy(starts), torch.from_numpy(loci),
                  torch.from_numpy(valid), trc, trn, tl)
    return jax_args, torch_args, kinds, n_amb


def _assert_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        t = got[k].numpy()
        np.testing.assert_array_equal(t.astype(w.dtype), w, err_msg=k)


@pytest.mark.parametrize("with_n,L,max_indel", [(True, 100, 10),
                                                (False, 100, 20),
                                                (True, 75, 5)])
def test_indel_scan_matches_jax(with_n, L, max_indel):
    rng = np.random.default_rng(L + max_indel + with_n)
    jax_args, torch_args, kinds, _ = _scan_inputs(rng, with_n, L, max_indel)
    want = jsi.indel_scan(*jax_args, L, max_indel)
    got = tsi.indel_scan(*torch_args, L, max_indel)
    _assert_equal(got, want)
    ok = np.asarray(want["ok"])
    indel = np.asarray(want["indel"])
    kinds = np.array(kinds)
    # the planted deletions and insertions are found with their sign
    assert (ok & (kinds == "del") & (indel > 0)).sum() >= 8
    assert (ok & (kinds == "ins") & (indel < 0)).sum() >= 8
    assert not ok.all()


@pytest.mark.parametrize("with_n,L,max_sep", [(True, 100, 50_000),
                                              (False, 100, 2_000),
                                              (True, 80, 100_000)])
def test_splice_scan_matches_jax(with_n, L, max_sep):
    rng = np.random.default_rng(L + max_sep + with_n)
    jax_args, torch_args, kinds, n_amb = _scan_inputs(rng, with_n, L, 10)
    want = jsi.splice_scan(*jax_args, L, max_sep)
    got = tsi.splice_scan(*torch_args, L, max_sep)
    _assert_equal(got, want)
    ok = np.asarray(want["ok"]) & (np.array(kinds) == "splice")
    assert ok.sum() >= 6 and n_amb >= 5


def test_splice_scan_chunks_change_nothing(monkeypatch):
    rng = np.random.default_rng(3)
    _, torch_args, _, _ = _scan_inputs(rng, True, 100, 10)
    whole = tsi.splice_scan(*torch_args, 100, 50_000)
    # three rows a chunk: 22 chunks for 64 rows
    monkeypatch.setattr(tsi, "SPLICE_CHUNK_BYTES", 3 * 24 * 24 * 101 * 4)
    chunked = tsi.splice_scan(*torch_args, 100, 50_000)
    for k in whole:
        assert torch.equal(whole[k], chunked[k]), k


def test_ambiguous_junction_takes_the_rightmost_split():
    """Exon 1 ends ...ACG and the intron ends ACG: splits s, s+1, s+2 and
    s+3 give the same mismatch count; the JAX package and the port take
    s+3."""
    rng = np.random.default_rng(17)
    g = rng.integers(0, 4, 20_000).astype(np.int8)
    p, s, intron, L = 1_000, 40, 3_000, 100
    g[p + s + intron:p + s + intron + 3] = g[p + s:p + s + 3]
    read = np.concatenate([g[p:p + s], g[p + s + intron:p + intron + L]])
    reads = np.tile(read, (2, 1))
    lens = np.full(2, L, np.int32)
    loci = np.array([[p, p + intron, 5, 7], [9, p + intron, 5, p]],
                    np.int32)
    valid = np.ones_like(loci, bool)
    starts = np.array([0, len(g)], np.int32)
    tpg = tep.pack_genome(g, CPU)
    tr, tl = torch.from_numpy(reads), torch.from_numpy(lens)
    trc, trn = tep.pack_reads(tr, tl)
    got = tsi.splice_scan(tpg, torch.from_numpy(starts),
                          torch.from_numpy(loci), torch.from_numpy(valid),
                          trc, trn, tl, L, 50_000)
    jpg = jep.pack_genome(g)
    jrc, jrn = jep.pack_reads(jnp.asarray(reads), jnp.asarray(lens))
    want = jsi.splice_scan(jpg.rows, jpg.rows, False, jpg.length,
                           jnp.asarray(starts), jnp.asarray(loci),
                           jnp.asarray(valid), jrc, jrn, jnp.asarray(lens),
                           L, 50_000)
    _assert_equal(got, want)
    assert got["ok"].all()
    assert got["split"].tolist() == [s + 3, s + 3]
    assert got["locus5"].tolist() == [p, p]
    assert got["mm"].tolist() == [0, 0]


def test_extended_aligner_matches_jax():
    rng = np.random.default_rng(23)
    g = cases.genome(rng, True)
    seqs = [("e0", g[:9_000]), ("e1", g[9_000:25_000]),
            ("e2", g[25_000:25_130]), ("e3", g[25_130:])]
    reads, lens, _, _, kinds, _ = cases.scan_case(rng, g, L=100, B=80)
    jax_ext = JaxExtended(JaxEngine(jax_to_device(
        jax_build_index(seqs, lut_bases=8)), JaxParams()), 10, 50_000)
    ext = ExtendedAligner(AlignEngine(to_device(
        build_index(seqs, lut_bases=8), CPU), AlignParams()), 10, 50_000)
    want = jax_ext.align(reads.copy(), lens.copy())
    got = ext.align(reads.copy(), lens.copy())
    for k in want:
        if k != "derived":
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)
    ops = got["cigar_op"][got["unique"]]
    assert (ops > 0).any() and (ops < 0).any() and (ops == 1 << 30).any()
