"""The traffic generator and the genome: deterministic from the seed, and
the pairs they make are what the traffic file says."""
import numpy as np
import torch

from benchmark.gen import pe_uniform
from benchmark.genome import make_genome

TRAFFIC = {"read_len": 100, "insert_min": 200, "insert_max": 500,
           "sub_rate": 0.01, "pool_pairs": 2000}
ENTRIES = [["a", 60000], ["b", 40000]]


def _genome(seed):
    codes, starts = make_genome(ENTRIES, seed, torch.device("cpu"))
    return codes.numpy(), starts


def test_genome_is_deterministic_from_the_seed():
    a, starts = _genome(2**31 + 11)
    b, _ = _genome(2**31 + 11)
    c, _ = _genome(2**31 + 12)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert list(starts) == [0, 60000, 100000]
    assert a.min() >= 0 and a.max() <= 3


def test_pool_is_deterministic_from_the_seed():
    g, starts = _genome(5)
    p = pe_uniform.make_pool(g, starts, TRAFFIC, 2**31 + 99)
    q = pe_uniform.make_pool(g, starts, TRAFFIC, 2**31 + 99)
    r = pe_uniform.make_pool(g, starts, TRAFFIC, 2**31 + 100)
    for k in ("reads1", "reads2", "origin", "insert", "minus"):
        assert np.array_equal(p[k], q[k])
    assert not np.array_equal(p["reads1"], r["reads1"])


def _rc(x):
    return (3 - x)[::-1]


def test_pairs_are_fr_mates_of_their_fragment():
    g, starts = _genome(6)
    clean = dict(TRAFFIC, sub_rate=0.0)
    p = pe_uniform.make_pool(g, starts, clean, 7)
    L = 100
    for i in range(200):
        s, ins = p["origin"][i], p["insert"][i]
        head, tail = g[s:s + L], g[s + ins - L:s + ins]
        m1, m2 = p["reads1"][i], p["reads2"][i]
        if p["minus"][i]:
            assert np.array_equal(m1, _rc(tail)) and np.array_equal(m2, head)
        else:
            assert np.array_equal(m1, head) and np.array_equal(m2, _rc(tail))
        e = np.searchsorted(starts, s, side="right")
        assert s + ins <= starts[e]
        assert 200 <= ins <= 500
    assert 0.4 < p["minus"].mean() < 0.6


def test_substitutions_at_the_stated_rate():
    g, starts = _genome(8)
    big = dict(TRAFFIC, pool_pairs=20000)
    clean = pe_uniform.make_pool(g, starts, dict(big, sub_rate=0.0), 9)
    noisy = pe_uniform.make_pool(g, starts, big, 9)
    diff = clean["reads1"] != noisy["reads1"]
    rate = diff.mean()
    assert 0.009 < rate < 0.011
    assert noisy["reads1"].max() <= 3
    # substituted positions spread over the whole read
    assert diff[:, :50].sum() > 0.4 * diff.sum()
