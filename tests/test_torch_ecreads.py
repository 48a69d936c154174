"""The port's PacBio error correction against the JAX package's.

Inputs are those of tests/test_pacbio.py, made from the same numpy seeds:
12 noisy copies of an 800 bp sequence, and 5 forward plus 5
reverse-complement copies of a 600 bp one.  The port runs on the CPU (the
kernels' plain versions).  Corrected reads and `overlaps_used` must be
equal, at one and two rounds; candidates and the consensus call are held
against the JAX functions directly, ties included.

Both packages get the same ECParams.  `sw_chunk_bytes` is set small: the
JAX package pads every SW chunk to that many bytes of pairs (some 13,000
pairs at these lengths by default), which its interpret mode runs for
minutes, and the votes are integer sums, so the chunk size cannot change
the output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biokanga_tpu.pacbio import ecreads as jax_ec
from biokanga_tpu.seq.encode import revcomp
from biokanga_tpu.sim.simreads import random_genome
from biokanga_tpu_torch.pacbio import ecreads as port_ec

torch.set_num_threads(2)

CHUNK_BYTES = 1 << 23


def noisy_copy(rng, seq, sub=0.03, ins=0.01, dele=0.01):
    """tests/test_pacbio.py's read model."""
    out = []
    for c in seq:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + ins:
            out.append(rng.integers(0, 4))
        if rng.random() < sub:
            out.append((c + 1 + rng.integers(0, 3)) % 4)
        else:
            out.append(c)
    return np.array(out, np.int8)


def twelve_reads():
    rng = np.random.default_rng(7)
    true = random_genome([("t", 800)], seed=44)[0][1]
    return [noisy_copy(rng, true) for _ in range(12)]


def params(pkg, score):
    return pkg.ECParams(min_overlap_score=score, sw_chunk_bytes=CHUNK_BYTES)


def assert_same_reads(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


@pytest.fixture(scope="module")
def jax_rounds():
    """JAX corrections of the 12 reads after one and after two rounds
    (round 2 corrects round 1's output, as ec_reads(rounds=2) does)."""
    reads = twelve_reads()
    r1, s1 = jax_ec.ec_reads(reads, params(jax_ec, 100))
    r2, s2 = jax_ec.ec_reads(r1, params(jax_ec, 100))
    return reads, {1: (r1, s1["overlaps_used"]),
                   2: (r2, s1["overlaps_used"] + s2["overlaps_used"])}


@pytest.mark.parametrize("rounds", [1, 2])
def test_ec_reads_matches_jax(jax_rounds, rounds):
    reads, want = jax_rounds
    got, st = port_ec.ec_reads(reads, params(port_ec, 100), rounds=rounds,
                               device="cpu")
    assert_same_reads(want[rounds][0], got)
    assert st["overlaps_used"] == want[rounds][1] > 0
    assert st["pairs"] >= st["overlaps_used"]
    if rounds == 2:
        assert st["rounds"] == 2


def test_rc_overlaps_match_jax():
    rng = np.random.default_rng(11)
    true = random_genome([("t", 600)], seed=9)[0][1]
    fwd = [noisy_copy(rng, true) for _ in range(5)]
    rc = [revcomp(noisy_copy(rng, true)) for _ in range(5)]
    want, ws = jax_ec.ec_reads(fwd + rc, params(jax_ec, 80))
    got, gs = port_ec.ec_reads(fwd + rc, params(port_ec, 80), device="cpu")
    assert_same_reads(want, got)
    assert gs["overlaps_used"] == ws["overlaps_used"] >= 10


@pytest.mark.parametrize("chunked", [False, True])
def test_candidates_match_jax(chunked):
    reads = twelve_reads()
    n = len(reads)
    tids = list(range(2, 7)) if chunked else list(range(n))
    entries = [(f"r{i}", reads[i]) for i in tids]
    entries += [(f"rc{i}", revcomp(reads[i])) for i in tids]
    kw = ({"probe_gids": np.arange(n), "n_reads_total": n,
           "ent_gids": np.asarray(tids + tids, np.int64)} if chunked else {})
    probes, plens = jax_ec._pad_reads(reads)
    jidx, jstarts = jax_ec._build_ec_index(entries)
    want = jax_ec.find_overlap_candidates_batch(
        jidx, jstarts, probes, plens, jax_ec.ECParams(max_targets=5), **kw)
    pidx, pstarts = port_ec._build_ec_index(entries, torch.device("cpu"))
    got = port_ec.find_overlap_candidates_batch(
        pidx, pstarts, probes, plens, port_ec.ECParams(max_targets=5), **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    c_probe, c_ent = got[0], got[1]
    assert len(c_probe) > n
    gid = np.asarray(tids + tids)[c_ent]
    assert not (gid == c_probe).any()           # no self-overlaps
    assert np.bincount(c_probe).max() <= 5      # top max_targets per probe


def test_consensus_ties_take_the_first_maximum():
    rng = np.random.default_rng(3)
    N, La = 6, 64
    votes = rng.integers(0, 3, (N, La, 7)).astype(np.int32)
    votes[0, :, :] = 2                           # five-way ties
    votes[1, :, 1] = votes[1, :, 5] = 4          # base vs deletion
    ins_cnt = rng.integers(0, 5, (N, La + 1)).astype(np.int32)
    ins_base = rng.integers(0, 2, (N, La + 1, 4)).astype(np.int32)
    ins_base[2] = 1
    probes, plens = jax_ec._pad_reads(
        [rng.integers(0, 4, int(rng.integers(40, 64))).astype(np.int8)
         for _ in range(N)], pad_to=La)
    want = jax_ec._consensus(jnp.asarray(votes), jnp.asarray(ins_cnt),
                             jnp.asarray(ins_base), jnp.asarray(probes),
                             jnp.asarray(plens), 2)
    v = port_ec._Votes(N, La, torch.device("cpu"))
    v.votes[:] = torch.from_numpy(votes)
    v.ins_cnt[:] = torch.from_numpy(ins_cnt)
    v.ins_base[:] = torch.from_numpy(ins_base)
    got = port_ec._consensus(v, torch.from_numpy(probes),
                             torch.from_numpy(plens), 2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    call, _, ins_b = got
    assert (call[0, :40] == 0).all() and (call[1, :40] == 1).all()
    assert (ins_b[2] == 0).all()


def test_cuda_is_never_replaced_by_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_ec.ec_reads(twelve_reads()[:3])
