"""The port's sharded aligner (parallel/sharded.py) against the JAX
package's, on the same inputs, exactly.

The port runs as four gloo ranks on the CPU (tests/torch_dist_ranks.py,
one process and one torch thread each); the JAX package runs on the
conftest's 8 virtual CPU devices.  Inputs come from numpy seeds as in
tests/test_sharded.py: a three-entry genome with a 600 bp block in three
copies (multi-hit reads), 90 Ns, chunk cuts mid-entry, reads with Ns.
Every field of every result is compared: at (2, 2) against the JAX
ShardedAligner at (2, 2) field for field, chunk indices included; at
(1, 4) and (1, 2) the fields that do not name a chunk.
"""
from dataclasses import asdict

import jax
import numpy as np
import pytest

from biokanga_tpu.align.params import AlignParams
from biokanga_tpu.align.pipeline import AlignEngine, ExtendedAligner, pad_rows
from biokanga_tpu.align.snp import PileupAccumulator
from biokanga_tpu.index.build import build_index
from biokanga_tpu.index.chunked import build_chunked_index
from biokanga_tpu.index.device import to_device
from biokanga_tpu.parallel.sharded import (
    ShardedAligner,
    build_sharded_pileup_fn,
    combine_pileup_planes,
    make_mesh,
)
from biokanga_tpu.seq.encode import revcomp
from biokanga_tpu.sim.simreads import random_genome, simulate_reads
from torch_dist_ranks import load, sharded_ranks, spawn

# the fields that name a chunk depend on the layout's chunking
LAYOUT_FREE = ("unique", "any_hit", "best_mm", "next_mm", "inst", "locus",
               "is_rc", "ml_loci", "ml_mm", "ml_rc")


def _genome(seed=31):
    seqs = random_genome([("c1", 30000), ("c2", 25000), ("c3", 20000)],
                         seed=seed)
    seg = seqs[0][1][2000:2600].copy()
    seqs[1][1][7000:7600] = seg       # multi-hit repeat, 3 copies
    seqs[2][1][11000:11600] = seg
    rng = np.random.default_rng(4)
    for _, s in seqs:
        s[rng.choice(len(s), size=30, replace=False)] = 4
    return seqs


def _align_case():
    seqs = _genome()
    _, reads, _ = simulate_reads(seqs, 3_000, read_len=100, sub_rate=0.02,
                                 seed=13)
    reads[:16] = np.ascontiguousarray(seqs[0][1][2100:2200])  # multi-hit
    reads[16:24, 3] = 4                                       # N cases
    lengths = np.full(len(reads), 100, dtype=np.int32)
    lengths[24:40] = 93                                       # ragged
    reads[24:40, 93:] = 4
    reads, lengths = pad_rows(reads, lengths)
    return seqs, reads, lengths


def _extended_case():
    """tests/test_sharded.py::test_sharded_extended_indel_splice's input."""
    seqs = random_genome([("c1", 60000)], seed=17)
    s = seqs[0][1]
    L = 100
    rows = []
    for i in range(32):   # deletion reads
        st = 200 + i * 400
        w = s[st : st + L + 3]
        rows.append(np.concatenate([w[:50], w[53:]]))
    for i in range(32):   # junction reads across a 5 kb gap
        st = 30000 + i * 50
        rows.append(np.concatenate([s[st : st + 50],
                                    s[st + 5000 + 50 : st + 5000 + L]]))
    reads = np.stack(rows).astype(np.int8)
    reads, lengths = pad_rows(reads, np.full(len(reads), L, np.int32))
    return seqs, reads, lengths


def _pileup_case():
    """tests/test_sharded_pileup.py's input."""
    seqs = random_genome([("c", 8000)], seed=3)
    _, reads, _ = simulate_reads(seqs, 64, read_len=100, sub_rate=0.02,
                                 seed=8)
    return seqs, reads, np.full(64, 100, np.int32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' outputs on every case."""
    assert len(jax.devices()) >= 8
    out = str(tmp_path_factory.mktemp("sharded"))
    seqs, reads, lengths = _align_case()
    e_seqs, e_reads, e_lengths = _extended_case()
    p_seqs, p_reads, p_lengths = _pileup_case()
    spawn(sharded_ranks, 4, out, {
        "seqs": seqs, "reads": reads, "lengths": lengths,
        "extended": {"seqs": e_seqs, "reads": e_reads,
                     "lengths": e_lengths},
        "pileup": {"seqs": p_seqs, "reads": p_reads,
                   "lengths": p_lengths}})
    port = {name: load(out, name) for name in (
        "align_2x2", "align_1x4", "align_1x2", "extended", "pileup")}

    params = AlignParams(cand_per_core=48, batch_size=len(reads))
    ci = build_chunked_index(seqs, num_chunks=2, overlap=256, lut_bases=8)
    jax_out = {"align": ShardedAligner(make_mesh(2, 2), ci, params).align(
        reads, lengths)}
    jax_out["single"] = AlignEngine(to_device(build_index(seqs, lut_bases=8)),
                                    params).align_with_rescue(reads, lengths)

    ci = build_chunked_index(e_seqs, num_chunks=4, overlap=8192,
                             lut_bases=10)
    e_params = AlignParams(batch_size=len(e_reads))
    jax_out["extended"] = ShardedAligner(make_mesh(2, 4), ci, e_params
                                         ).align_extended(
        e_reads, e_lengths, micro_indel_len=9, splice_junct_len=50_000)
    jax_out["extended_single"] = ExtendedAligner(
        AlignEngine(to_device(build_index(e_seqs, lut_bases=10)), e_params),
        micro_indel_len=9, splice_junct_len=50_000).align(e_reads, e_lengths)

    mesh = make_mesh(4, 2)
    sa = ShardedAligner(mesh, build_chunked_index(
        p_seqs, num_chunks=2, overlap=256, lut_bases=8), AlignParams())
    res = sa.align(p_reads, p_lengths)
    aligned = p_reads.copy()
    for i in np.nonzero(res["is_rc"] & res["unique"])[0]:
        aligned[i] = revcomp(p_reads[i])
    loc = (res["locus"] - sa.sidx.bases[res["chunk"]]).astype(np.int32)
    planes = jax.device_get(build_sharded_pileup_fn(mesh, sa.sidx)(
        res["chunk"].astype(np.int32), loc, aligned, p_lengths,
        res["unique"]))
    jax_out["pileup"] = [np.asarray(p) for p in planes]
    jax_out["pileup_global"] = [combine_pileup_planes(np.asarray(p), sa.sidx)
                                for p in planes]
    didx = to_device(build_index(p_seqs, lut_bases=8))
    single = AlignEngine(didx, AlignParams()).align_with_rescue(p_reads,
                                                                p_lengths)
    acc = PileupAccumulator(didx)
    acc.add_alignments(p_reads, p_lengths, single)
    jax_out["pileup_single"] = acc.finalize()
    return port, jax_out


def _equal(got: dict, want: dict, keys) -> None:
    for k in keys:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


def test_sharded_align_2x2_equals_jax_field_for_field(runs):
    port, jax_out = runs
    got, want = port["align_2x2"], jax_out["align"]
    assert set(got) == set(want)
    _equal(got, want, [k for k in want if k != "derived"])
    assert got["locus"].dtype == np.int64 and got["ml_loci"].dtype == np.int64
    assert asdict(got["derived"]) == asdict(want["derived"])
    assert (got["inst"][:16] >= 3).all()
    assert got["unique"].sum() > 2_700
    assert got["n_over"].any() or got["cap_trunc"].any() or \
        got["overflow"].any() or (got["ml_mm"][:, 1] != 255).any()


@pytest.mark.parametrize("layout", ["1x4", "1x2"])
def test_sharded_align_other_layouts_equal_jax(runs, layout):
    port, jax_out = runs
    _equal(port[f"align_{layout}"], jax_out["align"], LAYOUT_FREE)


def test_sharded_align_equals_the_single_engine(runs):
    """The JAX tests' bar (tests/test_sharded.py): the port's sharded
    result is the single-device AlignEngine's."""
    port, jax_out = runs
    got, single = port["align_2x2"], jax_out["single"]
    _equal(got, single, ("unique", "any_hit", "best_mm", "next_mm", "inst",
                         "is_rc", "locus"))
    valid = single["ml_mm"] != 255
    np.testing.assert_array_equal(got["ml_mm"] != 255, valid)
    for k in ("ml_mm", "ml_loci", "ml_rc"):
        np.testing.assert_array_equal(got[k][valid], single[k][valid])


def test_sharded_extended_equals_jax(runs):
    port, jax_out = runs
    got, want = port["extended"], jax_out["extended"]
    assert set(got) == set(want)
    _equal(got, want, [k for k in want if k != "derived"])
    single = jax_out["extended_single"]
    u = single["unique"]
    np.testing.assert_array_equal(got["unique"], u)
    for k in ("locus", "cigar_op", "op_len"):
        np.testing.assert_array_equal(got[k][u], single[k][u])
    assert u[:64].sum() > 60


def test_sharded_pileup_equals_jax(runs):
    port, jax_out = runs
    got = port["pileup"]
    for g, w in zip(got["planes"], jax_out["pileup"]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got["global"], jax_out["pileup_global"]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got["global"], jax_out["pileup_single"]):
        np.testing.assert_array_equal(g, w)
    assert got["global"][0].sum() > 0
