"""biokanga_tpu_torch.ops.extend_packed against the JAX packed extension.

Seeded numpy inputs go through biokanga_tpu.ops.extend_packed (the plain
JAX contract that the TPU kernel `_mm_kernel` serves) and through the
port's plain version; results must be equal (tolerance 0, integers).
Cases: a genome with an N plane, Ns in reads, 100 / 150 / 300 bp reads
(multi-row windows), ragged lengths, loci across entry boundaries,
negative, past the end and INT32_MAX sentinels; and one case a read
length of tests/extend_edge_cases.py (1 to 4,096 bases, up to 100,000
entries), which the card tests run in full against the kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import extend_edge_cases as edges
import win_edge_cases as win_edges

from biokanga_tpu.ops import extend_packed as jep
from biokanga_tpu_torch.device import i32_bits, popcount32, u32
from biokanga_tpu_torch.ops import extend_packed as tep

torch.set_num_threads(2)

I32_MAX = 2**31 - 1
N_BASES = 40_000
STARTS = np.array([0, 9_000, 25_000, 25_130, N_BASES], np.int64)


def _genome(rng, with_n: bool):
    g = rng.integers(0, 4, size=N_BASES, dtype=np.int8)
    if with_n:
        g[3_000:3_040] = 4
        g[rng.random(N_BASES) < 0.002] = 4
    return g


def _case(rng, genome, L, B=96, C=40):
    n = len(genome)
    lens = np.where(rng.random(B) < 0.4, L - rng.integers(1, 30, B), L)
    lens = lens.astype(np.int32)
    origin = rng.integers(0, n - L, size=B)
    reads = genome[origin[:, None] + np.arange(L)]
    sub = rng.random(reads.shape) < 0.02
    reads[sub] = (reads[sub] + 1) % 4
    reads[rng.random(reads.shape) < 0.005] = 4
    reads[np.arange(L)[None, :] >= lens[:, None]] = 4
    loci = origin[:, None] + rng.choice([0, 0, 0, -1, 1, 2], size=(B, C))
    edge = rng.choice(STARTS[1:-1], size=(B, C)) + rng.integers(-L, L, (B, C))
    pick = rng.random((B, C))
    loci = np.where(pick < 0.3, edge, loci)
    loci = np.where(pick > 0.95, I32_MAX, loci)
    loci = np.where((pick > 0.9) & (pick <= 0.95), -3, loci)
    loci = np.where((pick > 0.85) & (pick <= 0.9), n - L // 3, loci)
    valid = rng.random((B, C)) < 0.9
    return reads, lens, loci.astype(np.int32), valid


def _jax_mm(genome, reads, lens, loci, valid, starts=STARTS):
    pg = jep.pack_genome(genome)
    rc, rn = jep.pack_reads(jnp.asarray(reads), jnp.asarray(lens))
    return np.asarray(jep.hamming_extend_packed(
        pg, jnp.asarray(starts.astype(np.int32)), jnp.asarray(loci),
        jnp.asarray(valid), rc, rn, jnp.asarray(lens)))


def _port_mm(genome, reads, lens, loci, valid, starts=STARTS):
    pg = tep.pack_genome(genome, torch.device("cpu"))
    r, ln = torch.from_numpy(reads), torch.from_numpy(lens)
    rc, rn = tep.pack_reads(r, ln)
    return tep.hamming_extend_packed(
        pg, torch.from_numpy(starts.astype(np.int32)),
        torch.from_numpy(loci), torch.from_numpy(valid), rc, rn, ln).numpy()


@pytest.mark.parametrize("L,with_n", [(100, True), (100, False), (150, True),
                                      (300, True), (64, False)])
def test_hamming_extend_matches_jax(L, with_n):
    rng = np.random.default_rng(L + with_n)
    genome = _genome(rng, with_n)
    reads, lens, loci, valid = _case(rng, genome, L)
    want = _jax_mm(genome, reads, lens, loci, valid)
    got = _port_mm(genome, reads, lens, loci, valid)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # the case covers close hits and invalid candidates
    assert (want == 255).any() and (want <= 3).any()


def test_pack_genome_and_reads_match_jax():
    rng = np.random.default_rng(5)
    genome = _genome(rng, True)
    jpg = jep.pack_genome(genome)
    tpg = tep.pack_genome(genome, torch.device("cpu"))
    assert tpg.length == jpg.length and tpg.has_n
    np.testing.assert_array_equal(tpg.rows.numpy().view(np.uint32),
                                  np.asarray(jpg.rows))
    np.testing.assert_array_equal(tpg.n_rows.numpy().view(np.uint32),
                                  np.asarray(jpg.n_rows))
    reads, lens, _, _ = _case(rng, genome, 150)
    jrc, jrn = jep.pack_reads(jnp.asarray(reads), jnp.asarray(lens))
    trc, trn = tep.pack_reads(torch.from_numpy(reads), torch.from_numpy(lens))
    np.testing.assert_array_equal(trc.numpy().view(np.uint32), np.asarray(jrc))
    np.testing.assert_array_equal(trn.numpy().view(np.uint32), np.asarray(jrn))
    assert (np.asarray(jrc) >= 2**31).any()       # bit 31 is exercised


# one case a read length, the genome's N plane and entry starts cycling
EDGE_CASES = [edges.cases()[6 * k + k % 6]
              for k in range(len(edges.READ_LENGTHS))]


@pytest.mark.parametrize("case", EDGE_CASES, ids=lambda c: "-".join(
    str(x) for x in c[1:4]))
def test_edge_cases_match_jax(case):
    """tests/extend_edge_cases.py: read lengths 1 to 4,096, with and
    without an N plane, one entry, entry boundaries and 100,000 entries,
    loci < 0, past the end and INT32_MAX, B = 1 and odd C."""
    genome, starts, reads, lens, loci, valid = edges.extend_case(*case)
    want = _jax_mm(genome, reads, lens, loci, valid, starts)
    got = _port_mm(genome, reads, lens, loci, valid, starts)
    np.testing.assert_array_equal(got, want)
    assert (want == 255).any()


@pytest.mark.parametrize("W", [1, 7, 10, 19])
def test_gather_window_words_matches_jax(W):
    rng = np.random.default_rng(W)
    genome = _genome(rng, False)
    jpg = jep.pack_genome(genome)
    tpg = tep.pack_genome(genome, torch.device("cpu"))
    loci = rng.integers(0, N_BASES + 300, size=(8, 33)).astype(np.int32)
    loci[0, :4] = [I32_MAX, -1, 0, 127]
    want = np.asarray(jep.gather_window_words(jpg.rows, jnp.asarray(loci), W))
    got = tep.gather_window_words(tpg.rows, torch.from_numpy(loci), W)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_unsigned_helpers():
    vals = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x55555555, 0xDEADBEEF,
                     2**31 - 1], np.uint32)
    t = torch.from_numpy(vals.view(np.int32).copy())
    assert u32(t).tolist() == vals.astype(np.int64).tolist()
    assert torch.equal(i32_bits(u32(t)), t)
    want = [bin(int(v)).count("1") for v in vals]
    assert popcount32(u32(t)).tolist() == want


def test_wrapper_checks_arguments():
    rng = np.random.default_rng(1)
    genome = _genome(rng, False)
    reads, lens, loci, valid = _case(rng, genome, 100, B=4, C=3)
    pg = tep.pack_genome(genome, torch.device("cpu"))
    rc, rn = tep.pack_reads(torch.from_numpy(reads), torch.from_numpy(lens))
    with pytest.raises(ValueError, match="loci"):
        tep.hamming_extend_packed(
            pg, torch.from_numpy(STARTS.astype(np.int32)),
            torch.from_numpy(loci.astype(np.int64)), torch.from_numpy(valid),
            rc, rn, torch.from_numpy(lens))


@pytest.mark.parametrize("case", win_edges.cases(),
                         ids=lambda c: f"B{c[1]}-C{c[2]}-W{c[3]}-N{int(c[4])}")
def test_windowed_extension_matches_jax(case):
    """hamming_extend_packed_win (the assembler's overlap verify) on
    tests/win_edge_cases.py: windows across entry cuts, win <= 0 and past
    16 W, windows past the genome's end, loci < 0 and INT32_MAX, Ns in
    the reads and the genome."""
    genome, starts, reads, lens, loci, valid, win = win_edges.win_case(*case)
    pg = jep.pack_genome(genome)
    rc, rn = jep.pack_reads(jnp.asarray(reads), jnp.asarray(lens))
    want = np.asarray(jep.hamming_extend_packed_win(
        pg, jnp.asarray(starts.astype(np.int32)), jnp.asarray(loci),
        jnp.asarray(valid), rc, rn, jnp.asarray(win)))
    tpg = tep.pack_genome(genome, torch.device("cpu"))
    trc, trn = tep.pack_reads(torch.from_numpy(reads), torch.from_numpy(lens))
    got = tep.hamming_extend_packed_win(
        tpg, torch.from_numpy(starts.astype(np.int32)),
        torch.from_numpy(loci), torch.from_numpy(valid), trc, trn,
        torch.from_numpy(win)).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    ok = want != tep.MM_WIN_INVALID
    # true overlaps (about 1% mismatches) beside random windows (75%)
    assert ok.any() and (~ok).any() and (want[ok] * 20 < win[ok]).any()
