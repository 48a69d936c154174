"""The dense Hamming extension and long reads: the port against the JAX
package.

Seeded numpy inputs go through biokanga_tpu's `hamming_extend`,
`AlignEngine` and `LongReadAligner` and through the port's, on the CPU;
every result field must be equal (integers, tolerance 0).  The dense
extension takes random loci with Ns on both sides, windows across entry
cuts, off either end of the genome and INT32_MAX sentinels; the engine
takes the dense path for an index moved without packed rows (100 bp) and
for reads past the packed extension's 4,096 bases (4,097 and 5,000 bp
against the default index); the long-read aligner takes the cases of
tests/test_longread.py at a size that runs in seconds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biokanga_tpu.align.longread import LongReadAligner as JaxLongRead
from biokanga_tpu.align.params import AlignParams as JaxParams
from biokanga_tpu.align.pipeline import AlignEngine as JaxEngine
from biokanga_tpu.index.device import to_device as jax_to_device
from biokanga_tpu.ops.extend import hamming_extend as jax_extend
from biokanga_tpu_torch.align.longread import LongReadAligner
from biokanga_tpu_torch.align.params import AlignParams
from biokanga_tpu_torch.align.pipeline import AlignEngine, pad_rows
from biokanga_tpu_torch.index.build import build_index
from biokanga_tpu_torch.index.device import to_device
from biokanga_tpu_torch.ops import extend
from biokanga_tpu_torch.seq.encode import revcomp
from biokanga_tpu_torch.sim.simreads import random_genome

torch.set_num_threads(2)

CPU = torch.device("cpu")
I32_MAX = 2**31 - 1
STARTS = np.array([0, 7_000, 19_000, 19_150, 30_000], np.int64)


def _extend_case(seed, L, B=48, C=24):
    rng = np.random.default_rng(seed)
    n = int(STARTS[-1])
    g = rng.integers(0, 4, n, dtype=np.int8)
    g[2_000:2_030] = 4
    g[rng.random(n) < 0.002] = 4
    lens = np.where(rng.random(B) < 0.3, L - rng.integers(1, 9, B), L)
    lens = np.maximum(lens, 0).astype(np.int32)
    lens[1] = 0
    origin = rng.integers(0, n - L, size=B)
    reads = g[origin[:, None] + np.arange(L)].copy()
    sub = rng.random(reads.shape) < 0.03
    reads[sub] = (reads[sub] + 1) % 4
    reads[rng.random(reads.shape) < 0.004] = 4
    reads[np.arange(L)[None, :] >= lens[:, None]] = 4
    loci = origin[:, None] + rng.choice([0, 0, -1, 1, 3], size=(B, C))
    cut = rng.choice(STARTS[1:-1], size=(B, C)) + rng.integers(-L, L, (B, C))
    pick = rng.random((B, C))
    loci = np.where(pick < 0.3, cut, loci)
    loci = np.where(pick > 0.95, I32_MAX, loci)
    loci = np.where((pick > 0.9) & (pick <= 0.95), -5, loci)
    loci = np.where((pick > 0.85) & (pick <= 0.9), n - L // 2, loci)
    valid = rng.random((B, C)) < 0.9
    return g, reads, lens, loci.astype(np.int32), valid


@pytest.mark.parametrize("L", [1, 100, 257, 4_097])
def test_dense_extension_matches_jax(L, monkeypatch):
    g, reads, lens, loci, valid = _extend_case(L, L)
    want = np.asarray(jax_extend(
        jnp.asarray(g), jnp.asarray(STARTS.astype(np.int32)),
        jnp.asarray(loci), jnp.asarray(valid), jnp.asarray(reads),
        jnp.asarray(lens)))
    t = torch.from_numpy
    # slabs of a few candidates: the slab loop must not change a count
    monkeypatch.setattr(extend, "SLAB_BASES", 7 * max(L, 1))
    got = extend.hamming_extend(
        t(g), t(STARTS.astype(np.int32)), t(loci), t(valid), t(reads),
        t(lens))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 255).any() and (want < 255).any()


@pytest.fixture(scope="module")
def dense_index():
    seqs = random_genome([("a", 60_000), ("b", 50_000)], seed=3)
    seqs[0][1][100:140] = 4
    seqs[1][1][20_000:26_000] = seqs[0][1][30_000:36_000]   # a repeat
    return seqs, build_index(seqs, lut_bases=9)


@pytest.mark.parametrize("L,pack", [(100, False), (4_097, True),
                                    (5_000, True)])
def test_engine_dense_path_matches_jax(dense_index, L, pack):
    """The dense branch of align_core: every result field of
    align_with_rescue equals the JAX engine's."""
    seqs, idx = dense_index
    rng = np.random.default_rng(L)
    n = 96 if L < 1_000 else 24
    g = np.concatenate([s for _, s in seqs])
    origin = rng.integers(0, len(g) - L, n)
    origin[:4] = 30_000 + rng.integers(0, 6_000 - L if L < 6_000 else 1, 4)
    reads = g[origin[:, None] + np.arange(L)].copy()
    sub = rng.random(reads.shape) < 0.004
    reads[sub] = (reads[sub] + 1) % 4
    lens = np.full(n, L, np.int32)
    lens[::5] = L - 13
    reads[np.arange(L)[None, :] >= lens[:, None]] = 4
    for i in range(1, n, 3):
        reads[i, : lens[i]] = revcomp(reads[i, : lens[i]])
    reads, lens = pad_rows(reads, lens)
    want = JaxEngine(jax_to_device(idx, pack=pack), JaxParams()
                     ).align_with_rescue(reads, lens)
    didx = to_device(idx, CPU, pack=pack)
    assert (didx.packed is None) == (not pack)
    got = AlignEngine(didx, AlignParams()).align_with_rescue(reads, lens)
    for k, v in want.items():
        if k != "derived":
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    # the four repeat reads are multi-hits; most others are placed
    assert not got["unique"][:4].any()
    assert got["unique"][: len(origin)].mean() > 0.75


@pytest.fixture(scope="module")
def long_genome():
    seqs = random_genome([("chr1", 300_000)], seed=11)
    idx = build_index(seqs, lut_bases=10)
    return seqs[0][1], idx


def _long_pair(idx):
    return (JaxLongRead(JaxEngine(jax_to_device(idx), JaxParams())),
            LongReadAligner(AlignEngine(to_device(idx, CPU),
                                        AlignParams())))


@pytest.mark.parametrize("case", ["subs_and_rc", "budget_cap",
                                  "ragged_tail"])
def test_long_read_aligner_matches_jax(long_genome, case):
    g, idx = long_genome
    rng = np.random.default_rng(4)
    if case == "subs_and_rc":        # 30 subs < the 63 cap; one read rc
        L, starts = 12_000, [1_000, 150_321, 270_000]
        reads = np.stack([g[s:s + L].copy() for s in starts])
        for r in reads:
            mut = rng.choice(L, 30, replace=False)
            r[mut] = (r[mut] + rng.integers(1, 4, 30)) % 4
        reads[2] = revcomp(reads[2])
        lens = np.full(3, L, np.int32)
    elif case == "budget_cap":       # 120 subs: rejected
        L = 20_000
        reads = g[None, 1_000:1_000 + L].copy()
        mut = rng.choice(L, 120, replace=False)
        reads[0, mut] = (reads[0, mut] + rng.integers(1, 4, 120)) % 4
        lens = np.array([L], np.int32)
    else:                            # 5,700 bp: a ragged last segment
        L = 5_000 + 700
        reads = np.full((2, L), 4, np.int8)
        reads[0] = g[4_321:4_321 + L]
        reads[1, :L - 600] = g[99_000:99_000 + L - 600]
        lens = np.array([L, L - 600], np.int32)
    jlr, tlr = _long_pair(idx)
    want = jlr.align(reads, lens)
    got = tlr.align(reads, lens)
    for k in ("unique", "locus", "is_rc", "best_mm"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if case == "subs_and_rc":
        assert got["locus"].tolist() == starts
        assert got["is_rc"].tolist() == [False, False, True]
        assert (got["best_mm"] == 30).all()
    elif case == "budget_cap":
        assert not got["unique"][0]
    else:
        assert got["unique"].all() and got["locus"].tolist() == [4_321,
                                                                 99_000]
