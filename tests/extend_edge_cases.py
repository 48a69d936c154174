"""Inputs that drive the packed Hamming extension to its edges, made with
numpy from a seed; shared by tests/test_torch_extend.py (the plain version
against the JAX package) and tests/test_torch_cuda.py (the kernel against
the plain version).  Imports neither jax nor torch.

A case is a genome (with or without Ns, so with or without the N plane),
its entry starts (one entry; a few entries whose boundaries candidates
straddle; 100,000 entries, most of them 2-base stubs packed at the
genome's start, so that a search crosses 17 levels), and (B, C) candidate
loci of reads of one length: true origins and near misses, loci that
straddle entry boundaries, negative loci, loci past the end and
INT32_MAX, with ragged read lengths, a read of length 0, Ns in reads and
invalid flags.
"""
import numpy as np

I32_MAX = 2**31 - 1

READ_LENGTHS = (1, 16, 17, 100, 128, 129, 150, 300, 1_000, 4_096)
ENTRY_KINDS = ("one", "bounds", "many")
MANY_ENTRIES = 100_000


def genome_and_starts(seed: int, n: int, with_n: bool, entries: str):
    """(genome (n,) int8, starts (E+1,) int64 ascending, 0 first, n last)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n, dtype=np.int8)
    if with_n:
        g[n // 7: n // 7 + 60] = 4
        g[rng.random(n) < 0.002] = 4
    if entries == "one":
        starts = np.array([0, n])
    elif entries == "bounds":
        starts = np.array([0, n // 5, n // 2, n // 2 + 130, 4 * n // 5, n])
    else:
        stub = 2 * np.arange(MANY_ENTRIES - 8)       # 2-base stubs
        tail = np.linspace(stub[-1] + 2, n, 9)[:-1].astype(np.int64)
        starts = np.concatenate([stub, tail, [n]])
    return g, starts.astype(np.int64)


def extend_case(seed: int, L: int, with_n: bool, entries: str, B: int,
                C: int):
    """(genome, starts, reads (B, L) int8, lens (B,) int32, loci (B, C)
    int32, valid (B, C) bool) for reads of length <= L."""
    rng = np.random.default_rng(seed)
    n = max(400_000, 4 * L) if entries != "many" else 1_200_000
    genome, starts = genome_and_starts(seed, n, with_n, entries)
    lo = int(starts[-2]) if entries == "many" else 0   # reads off the stubs
    lens = np.where(rng.random(B) < 0.3,
                    np.maximum(L - rng.integers(1, 20, B), 0), L)
    lens = lens.astype(np.int32)
    if B > 2:
        lens[1] = 0
    origin = rng.integers(lo, n - L, size=B)
    reads = genome[origin[:, None] + np.arange(L)].copy()
    sub = rng.random(reads.shape) < 0.02
    reads[sub] = (reads[sub] + 1) % 4
    reads[rng.random(reads.shape) < 0.003] = 4
    reads[np.arange(L)[None, :] >= lens[:, None]] = 4
    loci = origin[:, None] + rng.integers(-2, 3, size=(B, C))
    bound = rng.choice(starts[1:-1] if len(starts) > 2 else starts, (B, C))
    edge = bound + rng.integers(-L - 1, 2, (B, C))
    pick = rng.random((B, C))
    loci = np.where(pick < 0.3, edge, loci)
    loci = np.where(pick > 0.96, I32_MAX, loci)
    loci = np.where((pick > 0.92) & (pick <= 0.96), -1 - (loci & 7), loci)
    loci = np.where((pick > 0.88) & (pick <= 0.92), n - L // 2, loci)
    loci = np.where((pick > 0.86) & (pick <= 0.88), n + 3, loci)
    valid = rng.random((B, C)) < 0.9
    return (genome, starts, reads, lens, loci.astype(np.int32), valid)


def cases():
    """(seed, L, with_n, entries, B, C): every read length, each with a
    genome with and without Ns and each kind of entry starts, at B = 1,
    odd C and batches whose warps take several reads."""
    out = []
    for k, L in enumerate(READ_LENGTHS):
        for with_n in (False, True):
            for e, entries in enumerate(ENTRY_KINDS):
                B = (1, 37, 130)[(k + e) % 3]
                C = 33 if L >= 1_000 else (97, 96, 1)[(k + e + with_n) % 3]
                out.append((k * 10 + 2 * e + with_n, L, with_n, entries, B,
                            C))
    return out
