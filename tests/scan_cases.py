"""Seeded inputs of the indel and splice scans and of the SNP pileup
(numpy only; the card tests import it too, without jax).

A 40 kb genome of four entries (one of 130 bases), with or without Ns,
and reads cut from it with a deletion, an insertion or an intron, plain,
or random; ragged lengths end in N.  The candidate loci of each read hold
its true diagonals (twice: equal scores in two columns), neighbours,
loci across entry starts, off both ends of the genome and INT32_MAX
sentinels.  Some junctions are ambiguous: the first bases of the intron
repeat at its end, so several splits give the same mismatch count.
"""
import numpy as np

I32_MAX = 2**31 - 1
N_BASES = 40_000
STARTS = np.array([0, 9_000, 25_000, 25_130, N_BASES], np.int64)


def genome(rng, with_n: bool) -> np.ndarray:
    g = rng.integers(0, 4, size=N_BASES, dtype=np.int8)
    if with_n:
        g[3_000:3_040] = 4
        g[rng.random(N_BASES) < 0.002] = 4
    return g


def scan_case(rng, g: np.ndarray, L: int = 100, B: int = 64, C: int = 24,
              max_gap: int = 10):
    """(reads (B, L) int8, lengths (B,) int32, loci (B, C) int32,
    valid (B, C) bool, kinds list, number of ambiguous junctions).  `g`
    may be changed: ambiguous junctions copy bases inside it."""
    n = len(g)
    reads = np.full((B, L), 4, np.int8)
    lens = np.full(B, L, np.int32)
    loci = np.zeros((B, C), np.int64)
    kinds = []
    n_ambiguous = 0
    for b in range(B):
        kind = ("del", "ins", "splice", "plain", "random")[b % 5]
        p = int(rng.integers(200, n - 6_000))
        s = int(rng.integers(10, L - 10 - max_gap))
        gap = int(rng.integers(1, max_gap + 1))
        second = p
        if kind == "del":
            r = np.concatenate([g[p:p + s], g[p + s + gap:p + gap + L]])
        elif kind == "ins":
            r = np.concatenate([g[p:p + s],
                                rng.integers(0, 4, gap).astype(np.int8),
                                g[p + s:p + L - gap]])
        elif kind == "splice":
            intron = int(rng.integers(25, 5_000))
            if b % 2:                        # ambiguous split
                g[p + s + intron:p + s + intron + 3] = g[p + s:p + s + 3]
                n_ambiguous += 1
            r = np.concatenate([g[p:p + s],
                                g[p + s + intron:p + intron + L]])
            second = p + intron
        elif kind == "plain":
            r = g[p:p + L].copy()
        else:
            r = rng.integers(0, 4, L).astype(np.int8)
        r = r[:L].copy()
        sub = rng.random(L) < 0.01
        r[sub] = (r[sub] + 1) % 4
        if b % 7 == 3:
            r[rng.integers(0, L)] = 4
        if b % 6 == 5:
            lens[b] = L - int(rng.integers(1, 15))
            r[lens[b]:] = 4
        reads[b] = r
        kinds.append(kind)
        row = rng.integers(0, n, C)
        row[0] = row[1] = p
        row[2] = second
        row[3] = p + int(rng.integers(-3, 4))
        row[4] = int(rng.choice(STARTS[1:-1])) + int(rng.integers(-L, L))
        row[5] = -int(rng.integers(1, 40))
        row[6] = n - int(rng.integers(1, L))
        row[7] = I32_MAX
        loci[b] = rng.permutation(row) if b % 3 == 0 else row
    valid = rng.random((B, C)) < 0.9
    valid[:, :3] |= rng.random((B, 3)) < 0.9
    return reads, lens, loci.astype(np.int32), valid, kinds, n_ambiguous


def pileup_case(rng, g: np.ndarray, B: int = 300, L: int = 100):
    """(loci (B,) int32, aligned reads (B, L) int8, lengths (B,) int32,
    accept (B,) bool): reads from the genome with substitutions and Ns,
    ragged lengths, and loci off both ends."""
    n = len(g)
    loci = rng.integers(-L, n, B)
    loci[:5] = [-L + 1, -1, n - 1, n - L // 2, 0]
    pos = np.clip(loci[:, None] + np.arange(L), 0, n - 1)
    reads = g[pos].copy()
    sub = rng.random(reads.shape) < 0.05
    reads[sub] = rng.integers(0, 5, int(sub.sum()))
    lens = np.where(rng.random(B) < 0.3, L - rng.integers(1, 40, B), L)
    accept = rng.random(B) < 0.8
    return loci.astype(np.int32), reads.astype(np.int8), \
        lens.astype(np.int32), accept
