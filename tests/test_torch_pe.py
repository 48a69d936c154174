"""The port's paired-end path against the JAX package, tolerance 0.

Seeded pairs of 2 x 100 bp from a two-entry genome with a planted 300 bp
block in three distant copies and an N run.  Beside simulated pairs the
set holds pairs built for the orphan rescue: one mate inside the repeat
(multi-hit, so its unique partner is the anchor), mates with one
substitution in every seed core (no seed, within the budget), and such
pairs at the genome's start, at its end and on both sides of the entry
boundary, where the rescue window starts below 0, runs past the last
base or crosses entries.  Every per-mate result field, `proper`,
`orphan1/2` and `insert` must be equal, dtype included; the windowed
rescue alone is held against the JAX package's jitted `_rescue_fn`
through `PEAligner.rescue`; `simulate_reads(pe=True)` gives the same
arrays and names; `classify_pairs` agrees on random results.
"""
import numpy as np
import pytest
import torch

from biokanga_tpu.align import pe as jax_pe
from biokanga_tpu.align.params import AlignParams
from biokanga_tpu.align.pipeline import AlignEngine as JaxEngine
from biokanga_tpu.index.build import build_index
from biokanga_tpu.index.device import to_device as jax_to_device
from biokanga_tpu.sim import simreads as jax_sim
from biokanga_tpu_torch.align import pe as torch_pe
from biokanga_tpu_torch.align.pipeline import AlignEngine
from biokanga_tpu_torch.index.device import to_device
from biokanga_tpu_torch.sim import simreads as torch_sim
from torch_align_data import KEYS

torch.set_num_threads(2)

CPU = torch.device("cpu")
L = 100
N_PAIRS = 64
LEN_A, LEN_B = 50_000, 30_000


def _rc(x):
    return np.where(x >= 4, x, 3 - x)[::-1]


def _kill_seeds(r):
    """One substitution in every seed core, nine in all: no seed hit, yet
    within the budget of ten."""
    r = r.copy()
    r[4:93:11] = (r[4:93:11] + 1) % 4
    return r


def _pair(cat, start, insert, minus=False):
    """Mates of the fragment cat[start : start + insert]."""
    a, b = cat[start:start + L], _rc(cat[start + insert - L:start + insert])
    return (b, a) if minus else (a, b)


@pytest.fixture(scope="module")
def setup():
    seqs = jax_sim.random_genome([("chrA", LEN_A), ("chrB", LEN_B)], seed=55)
    g = seqs[0][1]
    block = g[5_000:5_300].copy()
    g[25_000:25_300] = block
    seqs[1][1][12_000:12_300] = block
    seqs[1][1][20_000:20_040] = 4
    idx = build_index(seqs, lut_bases=8)
    cat = np.concatenate([s for _, s in seqs])
    _, reads, _ = jax_sim.simulate_reads(seqs, N_PAIRS, read_len=L,
                                         sub_rate=0.01, seed=12, pe=True,
                                         insert_min=200, insert_max=500)
    r1, r2 = reads[0::2].copy(), reads[1::2].copy()
    # mate 1 inside the three-copy block, mate 2 unique beside it
    for i, c in enumerate((5_000, 25_000, LEN_A + 12_000)):
        r1[i], r2[i] = _pair(cat, c + 40 + 20 * i, 420)
        r2[8 + i], r1[8 + i] = _pair(cat, c - 250 + 10 * i, 400, minus=True)
    # seed-dead mates: mid genome, at its start (reverse anchor: the window
    # starts below 0), at its end (forward anchor: past the last base) and
    # on both sides of the chrA/chrB boundary
    n = len(cat)
    for i, (start, insert) in enumerate((
            (14_000, 380), (3, 330), (60, 450), (n - 410, 410),
            (n - 301, 300), (LEN_A - 360, 360), (LEN_A + 2, 340))):
        a, b = _pair(cat, start, insert)
        r1[16 + 2 * i], r2[16 + 2 * i] = _kill_seeds(a), b
        r1[17 + 2 * i], r2[17 + 2 * i] = a, _kill_seeds(b)
    lengths = np.full(N_PAIRS, L, np.int32)
    return {"seqs": seqs, "idx": idx, "cat": cat, "r1": r1, "r2": r2,
            "len": lengths, "jd": jax_to_device(idx),
            "td": to_device(idx, CPU)}


def _aligners(setup, ap=None, **pe_args):
    ap = ap or AlignParams()
    return (jax_pe.PEAligner(JaxEngine(setup["jd"], ap),
                             jax_pe.PEParams(**pe_args)),
            torch_pe.PEAligner(AlignEngine(setup["td"], ap),
                               torch_pe.PEParams(**pe_args)))


def _assert_pe_equal(got, want):
    for side in ("res1", "res2"):
        for k in KEYS:
            assert got[side][k].dtype == want[side][k].dtype, (side, k)
            np.testing.assert_array_equal(got[side][k], want[side][k],
                                          err_msg=f"{side}.{k}")
    for k in ("proper", "orphan1", "orphan2", "insert"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case,pe_args", [
    ("proper", dict(pair_min_len=100, pair_max_len=600)),
    ("insert-rejected", dict(pair_min_len=25, pair_max_len=150,
                             rescue=False)),
    ("same-strand", dict(pair_min_len=100, pair_max_len=600,
                         pair_same_strand=True)),
    ("no-rescue", dict(pair_min_len=100, pair_max_len=600, rescue=False)),
])
def test_align_pairs_matches_jax(setup, case, pe_args):
    jp, tp = _aligners(setup, **pe_args)
    s = setup
    want = jp.align_pairs(s["r1"], s["len"], s["r2"], s["len"])
    got = tp.align_pairs(s["r1"], s["len"], s["r2"], s["len"])
    _assert_pe_equal(got, want)
    if case == "proper":
        assert want["proper"].sum() > 50
        assert tp.rescue_calls == 2 and tp.rescued >= 12
        # the block mates and the seed-dead mates were orphans; with the
        # rescue they pair, also where the window leaves the genome
        no_rescue = _aligners(setup, **dict(pe_args, rescue=False))[1] \
            .align_pairs(s["r1"], s["len"], s["r2"], s["len"])
        assert not no_rescue["proper"][16:30].any()
        assert got["proper"][16:30].sum() >= 10
        assert got["proper"][[17, 18, 22, 23, 24]].all()
    if case == "insert-rejected":
        assert want["proper"].sum() == 0
    if case == "same-strand":
        assert want["proper"].sum() < 5
    if case == "no-rescue":
        assert tp.rescue_calls == 0 and want["orphan1"].any() \
            and want["orphan2"].any()


def test_launch_finish_equals_align_pairs(setup):
    jp, tp = _aligners(setup, pair_min_len=100, pair_max_len=600)
    s = setup
    args = (s["r1"], s["len"], s["r2"], s["len"])
    a = tp.align_pairs(*args)
    first = tp.launch_pairs(*args)
    second = tp.launch_pairs(*args)          # one batch in flight
    _assert_pe_equal(tp.finish_pairs(first), a)
    _assert_pe_equal(tp.finish_pairs(second), a)
    _assert_pe_equal(a, jp.finish_pairs(jp.launch_pairs(*args)))


def test_mates_of_different_widths(setup):
    """Mate 2 trimmed to 90 bases: the mates launch one after the other,
    and launch_pairs / finish_pairs equal align_pairs and the JAX
    package's, field for field."""
    jp, tp = _aligners(setup, pair_min_len=100, pair_max_len=600)
    s = setup
    r2 = s["r2"][:, :90].copy()
    args = (s["r1"], s["len"], r2, np.full(N_PAIRS, 90, np.int32))
    got = tp.finish_pairs(tp.launch_pairs(*args))
    assert tp.rescue_calls == 2 and tp.rescued > 0
    _assert_pe_equal(got, tp.align_pairs(*args))
    _assert_pe_equal(got, jp.align_pairs(*args))
    assert got["proper"].sum() > 50


def _rescue_inputs(setup, B, rng):
    """Anchors and mates for the rescue alone: true mates inside the
    window, windows below 0 and past the end, across entries, ragged
    lengths, Ns, a mate that occurs twice in its window, random mates."""
    cat, n = setup["cat"], len(setup["cat"])
    a_loc = rng.integers(0, n - L, B).astype(np.int32)
    a_rc = rng.random(B) < 0.5
    a_loc[:6] = (0, 5, 120, n - L, n - L - 40, LEN_A - 50)
    a_rc[:6] = (True, True, True, False, False, False)
    a_len = np.full(B, L, np.int32)
    ml = np.where(rng.random(B) < 0.3, L - rng.integers(1, 30, B), L)
    ml = ml.astype(np.int32)
    m = np.full((B, L), 4, np.int8)
    for i in range(B):
        # mate start inside the window the anchor defines (pair_max 600)
        w0 = a_loc[i] if not a_rc[i] else a_loc[i] + L - 600
        s0 = int(np.clip(w0 + rng.integers(0, 600 - L), 0, n - L))
        m[i, :ml[i]] = cat[s0:s0 + ml[i]]
        if i % 5 == 0:
            sub = rng.integers(0, ml[i], 4)
            m[i, sub] = (m[i, sub] + 1) % 4
        if i % 7 == 0:
            m[i, rng.integers(0, ml[i])] = 4
        if i % 11 == 0:
            m[i, :ml[i]] = rng.integers(0, 4, ml[i])
    return a_loc, a_rc, a_len, m, ml


@pytest.mark.parametrize("B,subs,seed", [(40, 10, 1), (300, 10, 2),
                                         (24, 0, 3), (24, 3, 4)])
def test_rescue_matches_jax_rescue_fn(setup, B, subs, seed):
    ap = AlignParams(max_subs_per100=subs)
    jp, tp = _aligners(setup, ap, pair_min_len=100, pair_max_len=600)
    rng = np.random.default_rng(seed)
    a_loc, a_rc, a_len, m, ml = _rescue_inputs(setup, B, rng)
    if seed == 1:
        # a mate that matches two loci of its window equally is not rescued
        g = np.array(setup["cat"])
        g[30_200:30_260] = g[30_000:30_060]
        m[6], ml[6] = g[30_000:30_000 + L], 60
        m[6, 60:] = 4
        a_loc[6], a_rc[6] = 29_900, False
        seqs = [("chrA", g[:LEN_A]), ("chrB", g[LEN_A:])]
        idx = build_index(seqs, lut_bases=8)
        jp.engine.didx = jax_to_device(idx)
        tp.engine.didx = to_device(idx, CPU)
    want = jp.rescue(a_loc, a_rc, a_len, m, ml, False)
    got = tp.rescue(tp.engine, a_loc, a_rc, a_len, m, ml)
    assert sorted(got) == sorted(want) == ["locus", "mm", "ok"]
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tp.rescue_calls == -(-B // torch_pe.CPU_RESCUE_ROWS)
    if subs == 10:
        assert want["ok"].sum() > B // 2 and not want["ok"].all()
        assert not want["ok"][::11].any()           # random mates
    if seed == 1:
        assert not want["ok"][6] and want["mm"][6] == 0
        assert want["ok"][:6].sum() >= 4            # windows off the genome


def test_orient_mates_is_revcomp_of_the_first_bases():
    from biokanga_tpu.seq.encode import revcomp

    rng = np.random.default_rng(5)
    m = rng.integers(0, 5, (50, 37)).astype(np.int8)
    ml = rng.integers(0, 38, 50).astype(np.int32)
    flip = rng.random(50) < 0.5
    want = m.copy()
    for i in range(50):
        if flip[i]:
            want[i, :ml[i]] = revcomp(m[i, :ml[i]])
    got = torch_pe._orient_mates(m, ml, flip)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("same_strand", [False, True])
def test_classify_pairs_matches_jax(same_strand):
    rng = np.random.default_rng(9)
    n = 2_000
    starts = np.array([0, 40_000, 65_000], np.int64)

    def res():
        return {"unique": rng.random(n) < 0.8,
                "locus": rng.integers(0, 64_900, n).astype(np.int32),
                "is_rc": rng.random(n) < 0.5}

    r1, r2 = res(), res()
    near = rng.random(n) < 0.7
    r2["locus"] = np.where(near, r1["locus"] + rng.integers(-700, 700, n),
                           r2["locus"]).astype(np.int32)
    ln1 = rng.integers(50, 101, n).astype(np.int32)
    ln2 = rng.integers(50, 101, n).astype(np.int32)
    kw = dict(pair_min_len=150, pair_max_len=600,
              pair_same_strand=same_strand)
    want = jax_pe.classify_pairs(r1, r2, ln1, ln2, starts,
                                 jax_pe.PEParams(**kw))
    got = torch_pe.classify_pairs(r1, r2, ln1, ln2, starts,
                                  torch_pe.PEParams(**kw))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["proper"].any() and want["orphan1"].any()


@pytest.mark.parametrize("kw", [
    dict(num_reads=300, read_len=100, sub_rate=0.01, seed=17, pe=True,
         insert_min=200, insert_max=500),
    dict(num_reads=50, read_len=75, sub_rate=0.0, seed=4, pe=True,
         insert_min=150, insert_max=150, strand="-"),
    dict(num_reads=200, read_len=100, sub_rate=0.02, seed=9),
])
def test_simulate_reads_matches_jax(kw):
    seqs = jax_sim.random_genome([("c1", 9_000), ("c2", 400), ("c3", 5_000)],
                                 seed=8)
    seqs[0][1][100:130] = 4
    want = jax_sim.simulate_reads(seqs, **kw)
    got = torch_sim.simulate_reads(seqs, **kw)
    assert got[0] == want[0]
    assert got[1].dtype == want[1].dtype
    np.testing.assert_array_equal(got[1], want[1])
    assert [t.descriptor() for t in got[2]] == \
        [t.descriptor() for t in want[2]]
    assert len(got[0]) == kw["num_reads"] * (2 if kw.get("pe") else 1)
