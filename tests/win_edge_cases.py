"""Inputs that drive the windowed Hamming extension
(`hamming_extend_packed_win`) to its edges, made with numpy from a seed;
shared by tests/test_torch_extend.py (the plain version against the JAX
package), tests/test_torch_cuda.py and chip_smoke.py (the kernel against
the plain version).  Imports neither jax nor torch.

A case is laid out as the assembler's overlap sweep lays out its own
(assembly/scale_overlap.py): the genome is a concatenation of sequences,
each one entry, and each read of B is a prefix of some sequence, padded
with Ns to 16 W bases.  Its C candidates are loci inside other entries
with the window the dovetail gives them (the rest of the entry), and
around them: windows that run across an entry cut, win = 0 and < 0,
windows past 16 W (clipped), windows past the genome's end, negative
loci and INT32_MAX, invalid flags, Ns in the reads and in the genome.
"""
import numpy as np

I32_MAX = 2**31 - 1
MAX_WORDS = 256


def win_case(seed: int, B: int, C: int, W: int, with_n: bool = True):
    """(genome (n,) int8, starts (E+1,) int64, reads (B, 16 W) int8,
    lens (B,) int32, loci (B, C) int32, valid (B, C) bool, win (B, C)
    int32)."""
    assert 1 <= W <= MAX_WORDS
    rng = np.random.default_rng(seed)
    L = 16 * W
    n_ent = max(8, (B * 3) // 2)
    ent_len = rng.integers(max(2, L // 2), 2 * L + 2, n_ent)
    starts = np.zeros(n_ent + 1, np.int64)
    np.cumsum(ent_len, out=starts[1:])
    n = int(starts[-1])
    genome = rng.integers(0, 4, n, dtype=np.int8)
    if with_n:
        genome[rng.random(n) < 0.002] = 4
        genome[n // 3: n // 3 + 40] = 4

    # each read a prefix of a sequence (an entry), with errors and Ns
    src = rng.integers(0, n_ent, B)
    lens = np.minimum(ent_len[src], L).astype(np.int32)
    lens[rng.random(B) < 0.1] //= 2
    idx = np.minimum(starts[src][:, None] + np.arange(L), n - 1)
    reads = genome[idx].copy()
    sub = rng.random(reads.shape) < 0.01
    reads[sub] = (reads[sub] + 1) % 4
    reads[rng.random(reads.shape) < 0.002] = 4
    reads[np.arange(L)[None, :] >= lens[:, None]] = 4

    # dovetail candidates: the read's prefix against the tail of an entry
    # from a shift on; the window is the rest of that entry
    tgt = rng.integers(0, n_ent, (B, C))
    shift = rng.integers(0, np.maximum(ent_len[tgt], 1))
    loci = starts[tgt] + shift
    win = starts[tgt + 1] - loci
    # plant true overlaps: the read's own prefix at the end of its source
    # entry's predecessor, so that some windows count few mismatches
    true = rng.random((B, C)) < 0.2
    loci = np.where(true, starts[src][:, None], loci)
    win = np.where(true, np.minimum(lens[:, None], L), win)

    pick = rng.random((B, C))
    win = np.where(pick < 0.06, win + rng.integers(1, 40, (B, C)), win)
    win = np.where((pick >= 0.06) & (pick < 0.09), 0, win)
    win = np.where((pick >= 0.09) & (pick < 0.11), -rng.integers(1, 9, (B, C)),
                   win)
    win = np.where((pick >= 0.11) & (pick < 0.14), L + rng.integers(1, 99,
                                                                    (B, C)),
                   win)
    tail = (pick >= 0.14) & (pick < 0.17)          # past the genome's end
    loci = np.where(tail, n - rng.integers(1, L + 1, (B, C)), loci)
    win = np.where(tail, L, win)
    loci = np.where((pick >= 0.17) & (pick < 0.19), -1 - (loci & 7), loci)
    loci = np.where((pick >= 0.19) & (pick < 0.2), I32_MAX, loci)
    valid = rng.random((B, C)) < 0.93
    return (genome, starts, reads, lens, loci.astype(np.int32), valid,
            np.clip(win, -2**31, I32_MAX).astype(np.int32))


def cases():
    """(seed, B, C, W, with_n): the assembler's word counts (10 for
    150 bp reads, 64 and 256 for contigs), both sides of the kernel's
    unrolled reach (16, 17), one word, and ragged B and C."""
    return [(1, 37, 33, 1, True), (2, 64, 48, 10, True),
            (3, 64, 48, 10, False), (4, 19, 40, 16, True),
            (5, 23, 40, 17, False), (6, 8, 64, 64, True),
            (7, 4, 24, 256, True)]
