"""The plain reference places planted reads, judges planted faults, and
states the guarantee the two configurations' settings give."""
import numpy as np
import torch

from benchmark.reference.aligner import (answers, build_seed_index,
                                         find_hits, pair_and_rescue, rc_codes)
from benchmark.reference.guarantee import guarantee
from benchmark.reference.judge import FIELDS, judge

SETTINGS = {"min_edit_dist": 1, "max_multi": 5, "pair_min_len": 100,
            "pair_max_len": 600}


def _genome(n=40000, seed=3):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.int8)
    return g, np.array([0, 25000, n], np.int64)


def _plant(g, locus, L, subs, rc, rng):
    r = g[locus:locus + L].copy()
    pos = rng.choice(L, size=subs, replace=False)
    r[pos] = (r[pos] + rng.integers(1, 4, size=subs)) % 4
    return rc_codes(torch.from_numpy(r[None]))[0].numpy() if rc else r


def test_guarantees_of_the_two_configurations():
    e = guarantee(100, 4_641_652, 10, 10, 1, "default")
    a = guarantee(150, 119_667_750, 12, 10, 1, "default")
    assert (e.max_mm, e.best_mm, e.multi_mm, e.seed_k) == (10, 9, 7, 9)
    assert (a.max_mm, a.best_mm, a.multi_mm, a.seed_k) == (15, 10, 7, 9)


def test_reference_places_planted_reads():
    g, starts = _genome()
    rng = np.random.default_rng(4)
    L, M = 100, 10
    plan = [(100, 0, False), (5000, 3, True), (24950, 10, False),
            (39900, 2, True), (30000, 11, False)]
    reads = np.stack([_plant(g, l, L, s, rc, rng) for l, s, rc in plan])
    gt = torch.from_numpy(g)
    hits = find_hits(gt, starts, torch.from_numpy(reads), M,
                     build_seed_index(gt, L // (M + 1)))
    res = answers(hits, len(reads), 1, 5)
    for i, (locus, subs, rc) in enumerate(plan[:4]):
        # 24950 crosses the entry boundary at 25000: no placement there
        if locus == 24950:
            assert not res["any_hit"][i]
            continue
        assert res["unique"][i] and res["locus"][i] == locus
        assert res["is_rc"][i] == rc and res["best_mm"][i] == subs
        assert res["ml_loci"][i, 0] == locus and res["ml_loci"][i, 1] == -1
    assert not res["any_hit"][4]          # 11 > M mismatches


def test_repeat_makes_two_hits_and_no_unique():
    g, starts = _genome()
    g[30000:30100] = g[1000:1100]
    gt = torch.from_numpy(g)
    reads = g[None, 1000:1100].copy()
    hits = find_hits(gt, starts, torch.from_numpy(reads), 10,
                     build_seed_index(gt, 9))
    res = answers(hits, 1, 1, 5)
    assert res["any_hit"][0] and not res["unique"][0]
    assert list(res["ml_loci"][0, :2]) == [1000, 30000]


def _pairs(g, rng, n=40, L=100, origins=None):
    r1, r2, o2 = [], [], []
    for _ in range(n):
        s = int(rng.integers(0, 24000 - 400))
        ins = int(rng.integers(200, 400))
        r1.append(_plant(g, s, L, 1, False, rng))
        r2.append(_plant(g, s + ins - L, L, 1, True, rng))
        o2.append(s + ins - L)
    if origins is not None:
        origins.extend(o2)
    return np.stack(r1), np.stack(r2)


def _truth(g, starts, r1, r2):
    gt = torch.from_numpy(g)
    idx = build_seed_index(gt, 9)
    h = [find_hits(gt, starts, torch.from_numpy(r), 10, idx)
         for r in (r1, r2)]
    m1, m2 = (answers(x, len(r1), 1, 5) for x in h)
    cls = pair_and_rescue(gt, starts, m1, m2, r1, r2, 100, 600, 10)
    return gt, h, m1, m2, cls


def test_judge_passes_the_truth_and_fails_planted_faults():
    g, starts = _genome()
    r1, r2 = _pairs(g, np.random.default_rng(5))
    gt, h, m1, m2, cls = _truth(g, starts, r1, r2)
    G = guarantee(100, len(g), 8, 10, 1, "default")
    assert cls["proper"].all()
    ok = judge(m1, m2, cls["proper"], h[0], h[1], gt, starts, r1, r2, G,
               SETTINGS)
    assert ok["wrong_mates"] == 0 and ok["wrong_pairs"] == 0

    def broken(change):
        p1 = {f: m1[f].copy() for f in FIELDS}
        p2 = {f: m2[f].copy() for f in FIELDS}
        proper = cls["proper"].copy()
        change(p1, p2, proper)
        return judge(p1, p2, proper, h[0], h[1], gt, starts, r1, r2, G,
                     SETTINGS)

    def shift(p1, p2, proper):
        p1["locus"][3] += 1
    def drop(p1, p2, proper):
        p2["unique"][7] = False
    def flag(p1, p2, proper):
        proper[9] = False
    def count(p1, p2, proper):
        p2["best_mm"][2] -= 1
    for change in (shift, drop, flag, count):
        out = broken(change)
        assert out["wrong_pairs"] == 1, change.__name__
    assert broken(flag)["wrong_mates"] == 0


def test_rescue_places_an_orphan_mate():
    """Pair 1's mate 2 source copied into the second entry: the search
    finds two hits of one count, so the mate is not unique, and only the
    rescue over mate 1's insert window places it."""
    g, starts = _genome()
    origins = []
    r1, r2 = _pairs(g, np.random.default_rng(6), n=4, origins=origins)
    g[26000:26100] = g[origins[1]:origins[1] + 100]
    gt, h, m1, m2, cls = _truth(g, starts, r1, r2)
    before = answers(h[1], 4, 1, 5)
    assert before["any_hit"][1] and not before["unique"][1]
    assert cls["proper"][1] and m2["unique"][1]
    assert m2["locus"][1] == origins[1] and m2["is_rc"][1]
