"""Paired-end reads from a genome: uniform origins, FR mates, uniform
substitutions.  A frozen, vectorised form of the arithmetic of
biokanga's `simreads --pe` (the port's sim/simreads.py), which the
benchmark does not call.

A fragment picks its entry with weight (entry length - insert_max + 1),
its insert uniformly in [insert_min, insert_max], its start uniformly
where it fits in the entry, and its strand with probability 1/2.  Mate 1
is the fragment's first read_len bases and mate 2 the reverse complement
of its last read_len bases; on the minus strand the two swap.  Then every
base is substituted with probability sub_rate, by a code 1-3 steps on
(mod 4): the positions of a Bernoulli process, drawn as geometric gaps.

Traffic parameters: read_len, insert_min, insert_max, sub_rate,
pool_pairs.  The same genome, parameters and seed give the same pool.
"""
from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

STREAM = 0x5EED_0001        # this generator's stream of the run's seed


def _rc(rows: np.ndarray) -> np.ndarray:
    return np.where(rows >= 4, rows, 3 - rows)[:, ::-1].astype(np.int8)


def _substitute(rows: np.ndarray, rate: float, rng) -> int:
    """Substitute each base of rows (in place) with probability rate;
    returns the number substituted."""
    if rate <= 0:
        return 0
    flat = rows.reshape(-1)
    total = flat.size
    mean = total * rate
    pos = []
    last = -1
    while last < total:
        gaps = rng.geometric(rate, size=int(mean + 10 * mean ** 0.5 + 64))
        run = last + np.cumsum(gaps)
        pos.append(run[run < total])
        last = int(run[-1])
    pos = np.concatenate(pos)
    pos = pos[flat[pos] < 4]
    delta = rng.integers(1, 4, size=len(pos))
    flat[pos] = (flat[pos] + delta) % 4
    return len(pos)


def make_pool(genome: np.ndarray, entry_starts: np.ndarray, traffic: dict,
              seed: int) -> dict:
    """reads1, reads2: (P, L) int8; lengths: (P,) int32; origin, insert,
    minus: each pair's fragment start, insert and strand."""
    rng = np.random.default_rng([seed, STREAM])
    P = int(traffic["pool_pairs"])
    L = int(traffic["read_len"])
    imin, imax = int(traffic["insert_min"]), int(traffic["insert_max"])
    starts = np.asarray(entry_starts, np.int64)
    lens = np.diff(starts)
    weights = np.maximum(lens - imax + 1, 0).astype(np.float64)
    if weights.sum() <= 0:
        raise ValueError("every entry is shorter than insert_max")
    weights /= weights.sum()
    entry = rng.choice(len(lens), size=P, p=weights)
    insert = rng.integers(imin, imax + 1, size=P)
    start = starts[entry] + (rng.random(P) * (lens[entry] - insert + 1)
                             ).astype(np.int64)
    minus = rng.random(P) < 0.5
    win = sliding_window_view(genome, L)
    head = win[start]
    tail_rc = _rc(win[start + insert - L])
    reads1 = np.where(minus[:, None], tail_rc, head)
    reads2 = np.where(minus[:, None], head, tail_rc)
    del head, tail_rc
    rate = float(traffic["sub_rate"])
    _substitute(reads1, rate, rng)
    _substitute(reads2, rate, rng)
    return {"reads1": reads1, "reads2": reads2,
            "lengths": np.full(P, L, np.int32),
            "origin": start, "insert": insert, "minus": minus}
